// Gradient of the dense window lookup (K2, mft_corr_lookup) with respect to
// every pyramid level, for Hopper (sm_90a).
//
// mft_corr_lookup_bwd  replaces the VJP of mft_tpu/models/raft/corr.py
//                      _corr_lookup_pallas_ad (corr.py:236-287), which
//                      differentiates the tent-matmul form _lookup_level_mxu
//                      in XLA: the gradient of the (B, P, L*(2r+1)^2)
//                      samples g into each (B, P, h_l, w_l) level. No
//                      coordinate gradient: the model stops the gradient
//                      before every lookup.
//
// The math. A pixel's level-l window samples at (cx + i - r, cy + j - r),
// (cx, cy) = coords / 2^l, and all (2r+1)^2 samples share the fractional
// parts (wx, wy) of (cx, cy), since the offsets are integers. So the map
// position xx = floor(cx) - r + a, yy = floor(cy) - r + b, 0 <= a, b <= 2r+1
// (the window's box of (2r+2)^2 taps) receives exactly four terms,
//   t0 = g[a,   b  ] * (1-wx)(1-wy)    t1 = g[a-1, b  ] * wx(1-wy)
//   t2 = g[a,   b-1] * (1-wx)wy        t3 = g[a-1, b-1] * wx wy
// (g[i, j] = channel l*(2r+1)^2 + i*(2r+1) + j: the first window axis offsets
// x, the forward's order), a term whose window index leaves [0, 2r] being
// zero. Every other position of the map gets zero, and box positions off
// the map are not written.
//
// Each pixel owns its maps, so no two pixels write one value: no atomics.
// One thread per map position sums its four terms in the fixed order
// ((((0 + t0) + t1) + t2) + t3), each product rounded once (-fmad=false and
// __fmul_rn/__fadd_rn), in float32, and rounds the sum once to the volume
// dtype. The plain version (ops/corr_lookup.py corr_lookup_bwd_ref) does the
// same operations in the same order, so float32 results are equal bit for
// bit and bfloat16 ones too.
//
// What bounds it on this card: bytes. The kernel writes every value of every
// gradient map, the zeros too (no separate memset), and reads g and the
// coords once: at the training shape (368x768, batch 6, 46x96 at level 0)
// about 156 M values, 312 MB in bfloat16, a bound of ~0.1 ms at 3.35 TB/s.
//
// The design (one block of 256 threads per pixel, all levels):
// - g's L*(2r+1)^2 values of the pixel are staged once in shared memory as
//   float32, each level's window in a zero-bordered (2r+3)^2 square, so the
//   four terms are four unconditional reads (a border read gives +0 * w = +0,
//   exactly what the plain version adds for a window index out of range);
// - warp k of the block writes rows k, k+8, ... of each level's map: a row
//   outside the box is all zeros, a row inside it computes the box's columns
//   and zeros elsewhere; lanes write consecutive columns (bfloat16 maps of
//   even width in pairs, 4-byte stores).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kMaxSide = 2 * kMaxRadius + 3;   // a level's zero-bordered window side
constexpr int kThreads = 256;

struct GradLevels {
  void* out[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The level's box value at (a, b), 0 <= a, b <= 2r+1, from the bordered
// window sg (side s = 2r+3, g[i, j] at (i+1)*s + (j+1)).
__device__ __forceinline__ float box_value(const float* sg, int s, int a, int b, float w00,
                                           float w10, float w01, float w11) {
  float acc = 0.f;
  acc = __fadd_rn(acc, __fmul_rn(sg[(a + 1) * s + (b + 1)], w00));
  acc = __fadd_rn(acc, __fmul_rn(sg[a * s + (b + 1)], w10));
  acc = __fadd_rn(acc, __fmul_rn(sg[(a + 1) * s + b], w01));
  acc = __fadd_rn(acc, __fmul_rn(sg[a * s + b], w11));
  return acc;
}

// One level's map of one pixel: rows warp, warp + 8, ... of the h x w map.
template <typename T>
__device__ __forceinline__ void write_level(T* __restrict__ map, int h, int w, int level,
                                            const float* sl, int radius, float cx0,
                                            float cy0) {
  const int n = 2 * radius + 1, s = n + 2;
  const float scale = 1.f / (float)(1 << level);   // exact: a power of two
  const float cx = __fmul_rn(cx0, scale), cy = __fmul_rn(cy0, scale);
  const float fx = floorf(cx), fy = floorf(cy);
  const float wx = __fsub_rn(cx, fx), wy = __fsub_rn(cy, fy);
  const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
  const float w00 = __fmul_rn(ux, uy), w10 = __fmul_rn(wx, uy);
  const float w01 = __fmul_rn(ux, wy), w11 = __fmul_rn(wx, wy);
  const int x0 = (int)fx - radius, y0 = (int)fy - radius;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = kThreads / 32;
  for (int yy = warp; yy < h; yy += kWarps) {
    const int b = yy - y0;
    const bool row_in = b >= 0 && b <= n;
    T* row = map + (long)yy * w;
    if constexpr (sizeof(T) == 2) {
      if ((w & 1) == 0) {   // bf16 pairs: 4-byte stores, aligned as w is even
        for (int xx = 2 * lane; xx < w; xx += 64) {
          const int a0 = xx - x0, a1 = a0 + 1;
          const float v0 = (row_in && a0 >= 0 && a0 <= n)
                               ? box_value(sl, s, a0, b, w00, w10, w01, w11) : 0.f;
          const float v1 = (row_in && a1 >= 0 && a1 <= n)
                               ? box_value(sl, s, a1, b, w00, w10, w01, w11) : 0.f;
          *reinterpret_cast<__nv_bfloat162*>(row + xx) = __floats2bfloat162_rn(v0, v1);
        }
        continue;
      }
    }
    for (int xx = lane; xx < w; xx += 32) {
      const int a = xx - x0;
      put(row + xx, (row_in && a >= 0 && a <= n)
                        ? box_value(sl, s, a, b, w00, w10, w01, w11) : 0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    corr_lookup_bwd_kernel(GradLevels lv, const T* __restrict__ g,
                           const float* __restrict__ coords, int num_levels, int radius) {
  __shared__ float sg[kMaxLevels * kMaxSide * kMaxSide];
  const long bp = blockIdx.x;
  const int n = 2 * radius + 1, nn = n * n, s = n + 2, ss = s * s;
  const T* gp = g + bp * (long)(num_levels * nn);
  for (int k = threadIdx.x; k < num_levels * ss; k += kThreads) {
    const int l = k / ss, i = (k % ss) / s - 1, j = k % s - 1;
    const bool in = i >= 0 && i < n && j >= 0 && j < n;
    sg[k] = in ? to_float(gp[l * nn + i * n + j]) : 0.f;
  }
  __syncthreads();
  const float cx0 = coords[2 * bp], cy0 = coords[2 * bp + 1];
  // unrolled, so that the level table is read at constant indices (no
  // local-memory copy of the parameter struct)
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < num_levels)
      write_level<T>(static_cast<T*>(lv.out[l]) + bp * (long)lv.h[l] * lv.w[l], lv.h[l],
                     lv.w[l], l, sg + l * ss, radius, cx0, cy0);
  }
}

}  // namespace

// g (B, P, L*(2r+1)^2) and the level gradients (B, P, h_l, w_l) in one dtype
// (0 = float32, 1 = bfloat16), all contiguous; coords (B, P, 2) float32 at
// level-0 scale; radius 1..4; (h_l, w_l) given for 4 levels, those beyond
// num_levels ignored. Every value of every gradient map is written.
extern "C" int mft_corr_lookup_bwd(void* o0, void* o1, void* o2, void* o3, const void* g,
                                   const void* coords, int h0, int w0, int h1, int w1,
                                   int h2, int w2, int h3, int w3, int num_levels, long BP,
                                   int radius, int dtype, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 1 || radius > kMaxRadius ||
      BP < 1 || BP > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  GradLevels lv = {{o0, o1, o2, o3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(coords);
  if (dtype == 0)
    corr_lookup_bwd_kernel<float><<<(unsigned)BP, kThreads, 0, st>>>(
        lv, static_cast<const float*>(g), c, num_levels, radius);
  else if (dtype == 1)
    corr_lookup_bwd_kernel<__nv_bfloat16><<<(unsigned)BP, kThreads, 0, st>>>(
        lv, static_cast<const __nv_bfloat16*>(g), c, num_levels, radius);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
