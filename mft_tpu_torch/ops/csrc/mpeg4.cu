// V2 and V3: the pixel stages of the MPEG-4 Part 2 (mp4v) codec on the card.
//
// Replace no Pallas site: the JAX package decodes and encodes video files
// through OpenCV (libavcodec, swscale) on the host (mft_tpu/io/video.py:
// 29-30, 40, 83-86). The VLC stage V1 stays on the host (mpeg4_vlc.cu); the
// block work runs here, bit for bit with the plain versions in
// mft_tpu_torch/io/mpeg4.py:
// - V2 mft_mpeg4_decode_pixels: reconstruct_kernel (one thread an 8x8
//   block: H.263 dequantization, libavcodec's simple IDCT, half-pel motion
//   compensation from the reference planes with coordinates clamped into
//   them, reconstruction into the next reference), then, where asked,
//   colour_kernel (one thread a pixel: swscale's x86 yuv2rgb to BGR);
// - V3 mft_mpeg4_encode_pixels: encode_kernel (one thread an 8x8 block:
//   BGR -> BT.601 YUV with 2x2 chroma means, islow FDCT, H.263
//   quantization of the source or of its residual against V2's planes).
// Every MB of a VOP is independent given the reference, so one launch
// covers a VOP. Simple and correct first: the per-thread arithmetic is in
// mpeg4.cuh, shared with the host mirror of the tests.

#include <cuda_runtime.h>

#include "mpeg4.cuh"

namespace {

mp4v::Geom read_geom(const int* g) { return mp4v::Geom{g[0], g[1], g[2], g[3]}; }

__global__ void reconstruct_kernel(mp4v::Geom g, const int16_t* __restrict__ levels,
                                   const int8_t* __restrict__ mode, const int8_t* __restrict__ qp,
                                   const int16_t* __restrict__ mv, const uint8_t* __restrict__ ref,
                                   int rounding, uint8_t* __restrict__ out, long blocks) {
  long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < blocks) mp4v::reconstruct_block(g, levels, mode, qp, mv, ref, rounding, out, tid);
}

__global__ void colour_kernel(mp4v::Geom g, const uint8_t* __restrict__ planes,
                              uint8_t* __restrict__ bgr, long pixels) {
  long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < pixels) mp4v::colour_pixel(g, planes, bgr, tid);
}

__global__ void encode_kernel(mp4v::Geom g, const uint8_t* __restrict__ bgr,
                              const uint8_t* __restrict__ ref, int qp,
                              int16_t* __restrict__ levels, long blocks) {
  long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < blocks) mp4v::encode_block(g, bgr, ref, qp, levels, tid);
}

unsigned grid(long n, int threads) { return (unsigned)((n + threads - 1) / threads); }

}  // namespace

extern "C" {

// V2: one VOP's syntax arrays and the reference planes (null for an I-VOP:
// every MB is then intra) -> the VOP's planes (out), and, if bgr is not
// null, its (H, W, 3) BGR frame. geom: W, H, mbw, mbh.
int mft_mpeg4_decode_pixels(const int* geom, const int16_t* levels, const int8_t* mode,
                            const int8_t* qp, const int16_t* mv, const uint8_t* ref,
                            int rounding, uint8_t* out, uint8_t* bgr, cudaStream_t stream) {
  mp4v::Geom g = read_geom(geom);
  long blocks = 6L * g.mbw * g.mbh;
  const int threads = 128;
  reconstruct_kernel<<<grid(blocks, threads), threads, 0, stream>>>(
      g, levels, mode, qp, mv, ref ? ref : out, rounding, out, blocks);
  if (bgr) {
    long pixels = (long)g.W * g.H;
    colour_kernel<<<grid(pixels, 256), 256, 0, stream>>>(g, out, bgr, pixels);
  }
  return (int)cudaGetLastError();
}

// V3: one (H, W, 3) BGR frame and the reference planes (null: intra) ->
// (nmb, 6, 64) int16 levels.
int mft_mpeg4_encode_pixels(const int* geom, const uint8_t* bgr, const uint8_t* ref, int qp,
                            int16_t* levels, cudaStream_t stream) {
  mp4v::Geom g = read_geom(geom);
  long blocks = 6L * g.mbw * g.mbh;
  const int threads = 128;
  encode_kernel<<<grid(blocks, threads), threads, 0, stream>>>(g, bgr, ref, qp, levels, blocks);
  return (int)cudaGetLastError();
}

}  // extern "C"
