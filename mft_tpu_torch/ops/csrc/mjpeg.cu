// J4: the Motion JPEG pixel stage on the card, in libavcodec's arithmetic.
//
// Replaces no Pallas site: the JAX package reads MJPEG video through
// cv2.VideoCapture (libavcodec's mjpegdec, then swscale) on the host
// (mft_tpu/io/video.py:30). That is not libjpeg-turbo's arithmetic, which
// J2 (jpeg.cu) follows for still images: mjpegdec runs the simple IDCT and
// keeps the planes at their coded sampling, and swscale converts full-range
// YUV without interpolating chroma. Bit for bit with the plain version in
// mft_tpu_torch/io/mjpeg.py (decode_pixels_ref), over a batch of N frames
// of one geometry in one call. The entropy stage stays J1's (jpeg_entropy.cu,
// host). Two kernels, as V2:
//   samples_kernel: one thread an 8x8 block (dequantize, IDCT, clamp into
//     the component's plane);
//   bgr_kernel: one thread a pixel (its chroma sample, the conversion).
// The arithmetic is in mjpeg.cuh, shared with the host mirror of the tests.
// A simple kernel first; bound: bytes (coefficients read, BGR written).

#include <cuda_runtime.h>

#include "mjpeg.cuh"

namespace {

__global__ void samples_kernel(mjpg::Geom g, const int16_t* __restrict__ coefs,
                               const int32_t* __restrict__ qtabs, uint8_t* __restrict__ planes,
                               long blocks) {
  long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < blocks) mjpg::block_samples(g, coefs, qtabs, planes, tid);
}

__global__ void bgr_kernel(mjpg::Geom g, const uint8_t* __restrict__ planes,
                           uint8_t* __restrict__ bgr, long pixels) {
  long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < pixels) mjpg::bgr_pixel(g, planes, bgr, tid);
}

unsigned grid(long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

// J4: N frames' quantized coefficients ((N, blocks, 64) int16, natural
// order) and quantization tables ((N, ncomp, 64) int32) -> the planes
// ((N, samples) uint8) and (N, H, W, 3) BGR. geom: io/mjpeg.py
// geometry_vector.
int mft_mjpeg_decode_pixels(const long* geom, int N, const int16_t* coefs, const int32_t* qtabs,
                            uint8_t* planes, uint8_t* bgr, cudaStream_t stream) {
  mjpg::Geom g = mjpg::read_geom(geom);
  long blocks = (long)N * g.blocks;
  samples_kernel<<<grid(blocks, 128), 128, 0, stream>>>(g, coefs, qtabs, planes, blocks);
  long pixels = (long)N * g.H * g.W;
  bgr_kernel<<<grid(pixels, 256), 256, 0, stream>>>(g, planes, bgr, pixels);
  return (int)cudaGetLastError();
}

}  // extern "C"
