// Dense bilinear warp (gather) for Hopper (sm_90a): one thread per output pixel.
//
// Replaces the three tent-matmul warps of mft_tpu/ops/warp_pallas.py:
// bilinear_warp_pallas (_warp_kernel), bilinear_warp_banded (_banded_kernel)
// and bilinear_warp_tiled (_tiled_kernel), and serves bilinear_warp_blocked's
// entry point too. All of them sample a channel-last (N, H, W, C) map at
// per-pixel (x, y) coordinates, align_corners pixel convention, zeros outside
// the map. The TPU had no fast gather, so it contracted every map row with a
// row of tent weights on the MXU and every column with a row of column
// weights on the VPU. Only two rows and two columns have nonzero weight, so
// this kernel reads those four taps directly.
//
// Two compile-time flags give every mode of the TPU kernels:
//   SNAP  snap each coordinate's fraction to 1/256 px, rounding half to even
//         (jnp.round); then the tent weights are multiples of 2^-8;
//   BF16  round the map taps and the row weights wy to bfloat16 (the MXU's
//         operands); the column weights wx stay float32.
// 'exact' is neither flag (bilinear_warp_pallas with dot_dtype float32 and
// snap False); 'tpu' is both (its defaults, and banded, blocked and tiled).
//
// The arithmetic is the TPU kernels' in the order they sum, and that of the
// plain version (ops/warp.py bilinear_warp_ref); built with -fmad=false, the
// two give the same bits:
//   wy_k = max(0, 1 - |sy - (y0 + k)|), wx_k likewise, y0 = floor(sy)
//   r_x  = wy_0 * m[y0, x] + wy_1 * m[y0 + 1, x]       (the MXU's row sum)
//   out  = wx_0 * r_x0 + wx_1 * r_x1                   (the column sum)
// with taps outside [0, H) x [0, W) contributing zero. The TPU's sums add
// only zeros besides these two terms, which changes no bit.
//
// What bounds it on this card: bytes. Per pixel it reads its coordinates (8 B)
// and four taps of C channels, and writes C float32 values; the maps are read
// about once overall when neighbouring pixels sample neighbouring positions.
// At 7 x 512 x 512 x 6 in bf16 that is about 81 MB, 0.024 ms at 3.35 TB/s.
//
// What the design does about it: nothing is staged. Neighbouring threads are
// neighbouring pixels, so coordinate reads coalesce and a smooth flow's taps
// fall in the same L1/L2 lines for a warp. Output strides are arguments, so
// the channel-last (N, P, C) result and the tiled kernel's C planes are
// written in place, with no transpose.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 16;

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// _snap256: f + round((s - f) * 256) / 256, rounding half to even.
__device__ __forceinline__ float snap256(float s) {
  const float f = floorf(s);
  return f + rintf((s - f) * 256.0f) * (1.0f / 256.0f);
}

template <typename MapT, bool SNAP, bool BF16>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const MapT* __restrict__ maps, const float* __restrict__ cx,
            const float* __restrict__ cy, int N, int H, int W, int C, long P,
            long c_n_stride, long c_p_stride, float* __restrict__ out, long o_n_stride,
            long o_p_stride, long o_c_stride) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)N * P) return;
  const long n = i / P;
  const long p = i - n * P;
  float sx = cx[n * c_n_stride + p * c_p_stride];
  float sy = cy[n * c_n_stride + p * c_p_stride];
  if (SNAP) {
    sx = snap256(sx);
    sy = snap256(sy);
  }
  const float x0f = floorf(sx);
  const float y0f = floorf(sy);
  float wx[2], wy[2];
  bool in_x[2], in_y[2];
  long xi[2], yi[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const float xk = x0f + (float)k;
    const float yk = y0f + (float)k;
    wx[k] = fmaxf(0.0f, 1.0f - fabsf(sx - xk));
    wy[k] = fmaxf(0.0f, 1.0f - fabsf(sy - yk));
    if (BF16) wy[k] = round_bf16(wy[k]);
    in_x[k] = (xk >= 0.0f) & (xk < (float)W);
    in_y[k] = (yk >= 0.0f) & (yk < (float)H);
    xi[k] = in_x[k] ? (long)xk : 0;
    yi[k] = in_y[k] ? (long)yk : 0;
  }
  const MapT* m = maps + n * (long)H * W * C;
  float* o = out + n * o_n_stride + p * o_p_stride;
  for (int c = 0; c < C; ++c) {
    float r[2];
#pragma unroll
    for (int kx = 0; kx < 2; ++kx) {
      float t[2];
#pragma unroll
      for (int ky = 0; ky < 2; ++ky) {
        float v = 0.0f;
        if (in_x[kx] & in_y[ky]) v = load(m + (yi[ky] * W + xi[kx]) * C + c);
        if (BF16) v = round_bf16(v);
        t[ky] = wy[ky] * v;
      }
      r[kx] = t[0] + t[1];
    }
    o[c * o_c_stride] = wx[0] * r[0] + wx[1] * r[1];
  }
}

template <typename MapT, bool SNAP, bool BF16>
int launch(const void* maps, const float* cx, const float* cy, int N, int H, int W,
           int C, long P, long c_n_stride, long c_p_stride, float* out, long o_n_stride,
           long o_p_stride, long o_c_stride, cudaStream_t stream) {
  const long total = (long)N * P;
  const long blocks = (total + kThreads - 1) / kThreads;
  warp_kernel<MapT, SNAP, BF16><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const MapT*>(maps), cx, cy, N, H, W, C, P, c_n_stride, c_p_stride, out,
      o_n_stride, o_p_stride, o_c_stride);
  return (int)cudaGetLastError();
}

template <typename MapT>
int dispatch(int snap, int bf16, const void* maps, const float* cx, const float* cy,
             int N, int H, int W, int C, long P, long c_n_stride, long c_p_stride,
             float* out, long o_n_stride, long o_p_stride, long o_c_stride,
             cudaStream_t stream) {
#define MFT_WARP_LAUNCH(S, B)                                                          \
  return launch<MapT, S, B>(maps, cx, cy, N, H, W, C, P, c_n_stride, c_p_stride, out, \
                            o_n_stride, o_p_stride, o_c_stride, stream)
  if (snap && bf16) MFT_WARP_LAUNCH(true, true);
  if (snap) MFT_WARP_LAUNCH(true, false);
  if (bf16) MFT_WARP_LAUNCH(false, true);
  MFT_WARP_LAUNCH(false, false);
#undef MFT_WARP_LAUNCH
}

}  // namespace

// maps (N, H, W, C) contiguous, float32 (map_bf16 0) or bfloat16 (1).
// Coordinates: x of pixel p of image n at cx[n * c_n_stride + p * c_p_stride],
// y at the same offset from cy (float32; strides in elements, 0 broadcasts).
// Output float32: channel c of pixel p of image n at
// out[n * o_n_stride + p * o_p_stride + c * o_c_stride].
extern "C" int mft_warp(void* out, const void* maps, const void* cx, const void* cy,
                        int N, int H, int W, int C, long P, long c_n_stride,
                        long c_p_stride, long o_n_stride, long o_p_stride,
                        long o_c_stride, int map_bf16, int snap, int bf16,
                        void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > kMaxChannels || P < 1)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(cx);
  const float* y = static_cast<const float*>(cy);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map_bf16)
    return dispatch<__nv_bfloat16>(snap, bf16, maps, x, y, N, H, W, C, P, c_n_stride,
                                   c_p_stride, o, o_n_stride, o_p_stride, o_c_stride, s);
  return dispatch<float>(snap, bf16, maps, x, y, N, H, W, C, P, c_n_stride, c_p_stride, o,
                         o_n_stride, o_p_stride, o_c_stride, s);
}
