// J2 and J3: the pixel stages of JPEG decode and encode on the card.
//
// Replace no Pallas site: the JAX package decodes and encodes JPEG through
// OpenCV and PIL (libjpeg-turbo) on the host (mft_tpu/train/augment.py:57-68,
// io/video.py:37, eval/tapvid.py:107-113); the card's machine has neither.
// Integer code, bit for bit with the plain versions in
// mft_tpu_torch/io/jpeg.py (decode_pixels_ref, encode_pixels_ref), over a
// batch of N frames of one geometry in one call each. The arithmetic is in
// jpeg.cuh.
//
// J2 (mft_jpeg_decode_pixels), two kernels:
//   idct_kernel: 8 threads a coefficient block, 32 blocks a CUDA block; a
//     thread dequantizes and transforms one column into shared memory, then
//     one row out of it (the transpose is the shared-memory workspace), and
//     stores its 8 samples as one 8-byte word into the component's plane;
//   color_kernel: a thread a pixel; each component upsampled at the pixel
//     from its plane (the fancy filters read the neighbouring samples across
//     block edges, the image edge repeated), then converted to BGR.
// J3 (mft_jpeg_encode_pixels), one kernel: 8 threads a coefficient block; a
//   thread converts and downsamples the 8 samples of one row of its block
//   straight from the image (edges repeated as libjpeg pads them), runs the
//   row pass into shared memory, then a column pass and quantizes its 8
//   coefficients.
// Bound: bytes (coefficients, planes and pixels once each); at these sizes
// they are launch-bound. A simple kernel first: one thread per 8 samples,
// the image read from global memory as often as the samples need it.

#include <cuda_runtime.h>

#include "jpeg.cuh"

using jpeg::Geom;

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerCta = kThreads / 8;

__global__ void idct_kernel(Geom g, int N, const int16_t* __restrict__ coefs,
                            const int32_t* __restrict__ qtabs, uint8_t* __restrict__ planes) {
  __shared__ int ws[kBlocksPerCta][64];
  long long blk = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 3;
  int lane = threadIdx.x & 7, local = threadIdx.x >> 3;
  bool valid = blk < (long long)N * g.blocks;
  long long n = 0, b = 0;
  int c = 0;
  if (valid) {
    n = blk / g.blocks;
    b = blk - n * g.blocks;
    c = jpeg::component_of(g, b);
    const int16_t* in = coefs + blk * 64;
    const int32_t* q = qtabs + (n * g.ncomp + c) * 64;
    long long x[8];
    int out[8];
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = (long long)in[k * 8 + lane] * q[k * 8 + lane];
    jpeg::idct_1d(x, 11, out);  // column `lane`
#pragma unroll
    for (int k = 0; k < 8; k++) ws[local][k * 8 + lane] = out[k];
  }
  __syncwarp();  // the 8 threads of a block are in one warp
  if (valid) {
    long long x[8];
    int out[8];
#pragma unroll
    for (int k = 0; k < 8; k++) x[k] = ws[local][lane * 8 + k];
    jpeg::idct_1d(x, 18, out);  // row `lane`
    unsigned lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      lo |= (unsigned)jpeg::range_limit(out[k]) << (8 * k);
      hi |= (unsigned)jpeg::range_limit(out[k + 4]) << (8 * k);
    }
    long long lb = b - g.boff[c];
    long long by = lb / g.bw[c], bx = lb - by * g.bw[c];
    uint8_t* dst = planes + n * g.samples + g.poff[c] + (by * 8 + lane) * (g.bw[c] * 8LL) + bx * 8;
    *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
  }
}

__global__ void color_kernel(Geom g, int N, const uint8_t* __restrict__ planes,
                             uint8_t* __restrict__ out) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long hw = (long long)g.H * g.W;
  if (t >= N * hw) return;
  long long n = t / hw, rem = t - n * hw;
  int y = (int)(rem / g.W), x = (int)(rem - (long long)y * g.W);
  const uint8_t* base = planes + n * g.samples;
  int v[3] = {0, 0, 0};
#pragma unroll
  for (int c = 0; c < 3; c++)
    if (c < g.ncomp) v[c] = jpeg::upsample(base + g.poff[c], g.bw[c] * 8, g, c, y, x);
  int bgr[3];
  if (g.color == jpeg::GREY) {
    bgr[0] = bgr[1] = bgr[2] = v[0];
  } else if (g.color == jpeg::RGB) {
    bgr[0] = v[2];
    bgr[1] = v[1];
    bgr[2] = v[0];
  } else {
    jpeg::ycc_to_bgr(v[0], v[1], v[2], bgr);
  }
  uint8_t* o = out + t * 3;
  o[0] = (uint8_t)bgr[0];
  o[1] = (uint8_t)bgr[1];
  o[2] = (uint8_t)bgr[2];
}

__global__ void fdct_kernel(Geom g, int N, int C, const uint8_t* __restrict__ img,
                            const int32_t* __restrict__ recips, int16_t* __restrict__ coefs) {
  __shared__ int ws[kBlocksPerCta][64];
  long long blk = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 3;
  int lane = threadIdx.x & 7, local = threadIdx.x >> 3;
  bool valid = blk < (long long)N * g.blocks;
  long long n = 0, b = 0;
  int c = 0;
  if (valid) {
    n = blk / g.blocks;
    b = blk - n * g.blocks;
    c = jpeg::component_of(g, b);
    long long lb = b - g.boff[c];
    int by = (int)(lb / g.bw[c]), bx = (int)(lb - (long long)by * g.bw[c]);
    const uint8_t* frame = img + n * g.H * (long long)g.W * C;
    int d[8], out[8];
#pragma unroll
    for (int k = 0; k < 8; k++)
      d[k] = jpeg::downsample(frame, C, g, c, by * 8 + lane, bx * 8 + k) - 128;
    jpeg::fdct_1d(d, true, out);  // row `lane`
#pragma unroll
    for (int k = 0; k < 8; k++) ws[local][lane * 8 + k] = out[k];
  }
  __syncwarp();
  if (valid) {
    int d[8], out[8];
#pragma unroll
    for (int k = 0; k < 8; k++) d[k] = ws[local][k * 8 + lane];
    jpeg::fdct_1d(d, false, out);  // column `lane`
    const int32_t* r = recips + c * 192;
    int16_t* dst = coefs + blk * 64;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      int i = k * 8 + lane;
      dst[i] = (int16_t)jpeg::quantize(out[k], r[i], r[64 + i], r[128 + i]);
    }
  }
}

}  // namespace

// coefs (N, blocks, 64) int16, qtabs (N, ncomp, 64) int32, planes (N,
// samples) uint8 scratch, out (N, H, W, 3) uint8 BGR.
extern "C" int mft_jpeg_decode_pixels(const long long* geom, int N, const void* coefs,
                                      const void* qtabs, void* planes, void* out,
                                      cudaStream_t stream) {
  Geom g = jpeg::read_geom(geom);
  long long threads = (long long)N * g.blocks * 8;
  if (threads > 0)
    idct_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        g, N, (const int16_t*)coefs, (const int32_t*)qtabs, (uint8_t*)planes);
  long long pixels = (long long)N * g.H * g.W;
  if (pixels > 0)
    color_kernel<<<(unsigned)((pixels + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        g, N, (const uint8_t*)planes, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// img (N, H, W, C) uint8 (BGR, or grey with C = 1), recips (ncomp, 3, 64)
// int32 (reciprocal, correction, shift), coefs (N, blocks, 64) int16.
extern "C" int mft_jpeg_encode_pixels(const long long* geom, int N, int C, const void* img,
                                      const void* recips, void* coefs, cudaStream_t stream) {
  Geom g = jpeg::read_geom(geom);
  long long threads = (long long)N * g.blocks * 8;
  if (threads > 0)
    fdct_kernel<<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        g, N, C, (const uint8_t*)img, (const int32_t*)recips, (int16_t*)coefs);
  return (int)cudaGetLastError();
}
