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
// Each box value is the float32 sum ((((0 + t0) + t1) + t2) + t3), each
// product rounded once (-fmad=false and __fmul_rn/__fadd_rn), rounded once
// to the volume dtype. The plain version (ops/corr_lookup.py
// corr_lookup_bwd_ref) does the same operations in the same order, so
// float32 results are equal bit for bit and bfloat16 ones too.
//
// What bounds it on this card: bytes written. The kernel writes every value
// of every gradient map, the zeros too (autograd takes a dense gradient per
// level; no memset, no second kernel), and reads g and the coords once. At
// the training shape (368x768, batch 6: 26,496 pixels, maps 46x96, 23x48,
// 11x24, 5x12) that is 154.8 M values, 309.7 MB in bfloat16 (619 MB in
// float32) against 17 MB of g: a bound of ~0.0976 ms at 3.35 TB/s. 98% of
// the values are zeros: a pixel's level-0 box is 100 of its 4,416 values.
//
// The design: the stores are the work, so every store is a full 16-byte
// chunk (8 bfloat16 or 4 float32 values), consecutive threads on consecutive
// chunks, and the box arithmetic is kept off the store loop.
// - A block takes a group of kGroup = 8 consecutive pixels; their values of
//   level l are one contiguous run of 8*h_l*w_l values, which starts on a
//   16-byte boundary whatever h_l and w_l are (8 values of 2 or 4 bytes).
// - First the block reads the group's g (one contiguous run of 8 pixels'
//   windows, every load issued before the first is used) into shared
//   memory, with each (pixel, level)'s four weights and box origin; then it
//   computes the group's box values, 8 pixels x L levels x (2r+2)^2, all
//   threads busy, from shared memory, rounded to the volume dtype.
// - Then it walks each level's run in chunks: thread t takes chunks t,
//   t + 256, ...; its chunk's (pixel, row, column) comes from one division
//   by a float reciprocal for the first chunk and from a fixed carry step
//   (256 chunks in pixels, rows and columns, from the host) for each next
//   one, with no division per value. A chunk inside one map row is zeros
//   unless that row of the box meets it; then its values come from shared
//   memory. A chunk that crosses a row or a pixel (a width that is not a
//   multiple of 8 or 4 values, e.g. the 5x12 bf16 level 3) is built value
//   by value, and a partial last chunk of a run is stored value by value.
// Measured at the training shape in bf16, uniform / local coordinates, by
// CUDA graph replay (NVIDIA H100 80GB HBM3, 700 W; tools/torch_lookup_ab.py
// and tools/torch_lookup_probe.py; PERF.md section 6): this kernel
// 0.1244 / 0.1249 ms (78% of the bound); the block-a-pixel kernel it
// replaces (rows over 8 warps, 4-byte stores, a four-read box test on every
// value) 0.3667 / 0.3714; the same walk with each box value computed from g
// where a chunk meets its box, in the store loop (nothing staged but the
// origins: a few lanes of a warp work while the others wait), 0.1578 /
// 0.1625. The walk and its stores alone take 0.1000 / 0.0996 ms, what
// Tensor.zero_() takes for the same maps (0.0993): the rest is the box
// values (0.016 ms, no stores in flight in that phase of a block) and the
// chunks that meet a box (0.007 ms). In float32 0.2392 / 0.2401 ms against
// the replaced kernel's 0.3170 / 0.3204 and zero_()'s 0.1932.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kThreads = 256;
constexpr int kGroup = 8;   // pixels a block: 8 values of any dtype are 16 bytes

struct GradLevels {
  void* out[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float inv_hw[kMaxLevels];   // 1 / (h*w) and 1 / w, for the first chunk's position
  float inv_w[kMaxLevels];
  // kThreads chunks = step_p pixels + step_y rows + step_x columns
  // (0 <= step_y < h, 0 <= step_x < w)
  int step_p[kMaxLevels];
  int step_y[kMaxLevels];
  int step_x[kMaxLevels];
};

template <typename T> struct Word;
template <> struct Word<float> { using type = uint32_t; };
template <> struct Word<__nv_bfloat16> { using type = uint16_t; };

// a value of g from its bits
__device__ __forceinline__ float to_float(uint32_t v) { return __uint_as_float(v); }
__device__ __forceinline__ float to_float(uint16_t v) { return __uint_as_float((uint32_t)v << 16); }

__device__ __forceinline__ uint32_t to_bits(float v, float*) { return __float_as_uint(v); }
__device__ __forceinline__ uint16_t to_bits(float v, __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// floor(e / d) for 0 <= e < 2^11: the float product is off by less than one,
// which one correction step repairs
__device__ __forceinline__ int div_small(int e, int d, float inv) {
  int q = __float2int_rz(__int2float_rn(e) * inv);
  const int r = e - q * d;
  if (r < 0) --q;
  else if (r >= d) ++q;
  return q;
}

// 16 bytes from kChunk values' bits
__device__ __forceinline__ uint4 pack(const uint32_t* v) {
  return make_uint4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint4 pack(const uint16_t* v) {
  return make_uint4(v[0] | (uint32_t)v[1] << 16, v[2] | (uint32_t)v[3] << 16,
                    v[4] | (uint32_t)v[5] << 16, v[6] | (uint32_t)v[7] << 16);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
    corr_lookup_bwd_kernel(GradLevels lv, const T* __restrict__ g,
                           const float* __restrict__ coords, int num_levels, long BP) {
  using Bits = typename Word<T>::type;
  constexpr int n = 2 * R + 1, nn = n * n;
  constexpr int side = n + 1, box = side * side;   // the box of (2r+2)^2 positions
  constexpr int kChunk = 16 / (int)sizeof(T);      // values a 16-byte store
  __shared__ Bits sbox[kMaxLevels * kGroup * box];   // [level][pixel][b][a]
  __shared__ Bits sg[kGroup * kMaxLevels * nn];       // the group's g, as in memory
  __shared__ float4 swt[kMaxLevels * kGroup];         // the four weights of a box
  __shared__ int2 sorg[kMaxLevels * kGroup];          // box origin (x0, y0)
  const long bp0 = (long)blockIdx.x * kGroup;
  const int np = BP - bp0 < kGroup ? (int)(BP - bp0) : kGroup;   // the tail group's fewer
  const int tid = threadIdx.x;

  // 1a. the group's g, one contiguous run, every load issued before the
  // first is used; per (level, pixel) the weights and the box origin
  const int gn = np * num_levels * nn;
  const Bits* __restrict__ gg = reinterpret_cast<const Bits*>(g) + bp0 * (num_levels * nn);
#pragma unroll
  for (int i = 0; i < (kGroup * kMaxLevels * nn + kThreads - 1) / kThreads; ++i) {
    const int k = tid + i * kThreads;
    if (k < gn) sg[k] = gg[k];
  }
  if (tid < num_levels * kGroup && tid % kGroup < np) {
    const int l = tid / kGroup;   // tid = level * kGroup + pixel
    const float* c = coords + 2 * (bp0 + tid % kGroup);   // maybe only 4-byte aligned
    const float scale = __int_as_float((127 - l) << 23);   // 2^-l, exact
    const float cx = __fmul_rn(c[0], scale), cy = __fmul_rn(c[1], scale);
    const float fx = floorf(cx), fy = floorf(cy);
    const float wx = __fsub_rn(cx, fx), wy = __fsub_rn(cy, fy);
    const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
    swt[tid] = make_float4(__fmul_rn(ux, uy), __fmul_rn(wx, uy), __fmul_rn(ux, wy),
                           __fmul_rn(wx, wy));
    // floor(c) - r with floor(c) clamped to [-side, 2^30]: a box beyond
    // either end stays off every map (w < 2^28), and NaN coords clamp to
    // -side (all zeros)
    constexpr float kFar = 1073741824.f;
    sorg[tid] = make_int2((int)fminf(fmaxf(fx, (float)-side), kFar) - R,
                          (int)fminf(fmaxf(fy, (float)-side), kFar) - R);
  }
  __syncthreads();

  // 1b. the group's box values, rounded to T
  for (int k = tid; k < num_levels * kGroup * box; k += kThreads) {
    const int q = k / box, s = k - q * box;   // q = level * kGroup + pixel
    const int l = q / kGroup, p = q % kGroup;
    if (p >= np) continue;
    const int b = s / side, a = s - b * side;
    const Bits* gl = sg + (p * num_levels + l) * nn;   // g[i, j] at i*n + j
    const float4 wt = swt[q];
    const bool a0 = a < n, a1 = a >= 1, b0 = b < n, b1 = b >= 1;
    const float g00 = (a0 && b0) ? to_float(gl[a * n + b]) : 0.f;
    const float g10 = (a1 && b0) ? to_float(gl[(a - 1) * n + b]) : 0.f;
    const float g01 = (a0 && b1) ? to_float(gl[a * n + b - 1]) : 0.f;
    const float g11 = (a1 && b1) ? to_float(gl[(a - 1) * n + b - 1]) : 0.f;
    float acc = 0.f;
    acc = __fadd_rn(acc, __fmul_rn(g00, wt.x));
    acc = __fadd_rn(acc, __fmul_rn(g10, wt.y));
    acc = __fadd_rn(acc, __fmul_rn(g01, wt.z));
    acc = __fadd_rn(acc, __fmul_rn(g11, wt.w));
    sbox[k] = to_bits(acc, (T*)nullptr);
  }
  __syncthreads();

  // 2. each level's run of the group's values, 16-byte chunks; unrolled, so
  // that the level table is read at constant indices (no local-memory copy
  // of the parameter struct)
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < num_levels) {
      const int h = lv.h[l], w = lv.w[l], hw = h * w;
      const int nv = np * hw;   // the group's values of this level
      Bits* out = static_cast<Bits*>(lv.out[l]) + bp0 * hw;
      const Bits* boxes = sbox + l * kGroup * box;
      const int2* org = sorg + l * kGroup;
      int e = tid * kChunk;
      int p = div_small(e, hw, lv.inv_hw[l]);
      const int o = e - p * hw;
      int y = div_small(o, w, lv.inv_w[l]);
      int x = o - y * w;
      for (; e < nv; e += kThreads * kChunk) {
        Bits v[kChunk];
        if (x + kChunk <= w && e + kChunk <= nv) {   // one row of one pixel
          const int2 c = org[p];
          const int b = y - c.y, a = x - c.x;
          if ((unsigned)b < (unsigned)side && a > -kChunk && a < side) {
            const Bits* row = boxes + p * box + b * side;
#pragma unroll
            for (int k = 0; k < kChunk; ++k)
              v[k] = (unsigned)(a + k) < (unsigned)side ? row[a + k] : Bits(0);
            *reinterpret_cast<uint4*>(out + e) = pack(v);
          } else {
            *reinterpret_cast<uint4*>(out + e) = make_uint4(0, 0, 0, 0);
          }
        } else {   // across rows or pixels, or the run's tail: value by value
          int pk = p, yk = y, xk = x;
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            Bits val = 0;
            if (e + k < nv) {
              const int2 c = org[pk];
              const int b = yk - c.y, a = xk - c.x;
              if ((unsigned)b < (unsigned)side && (unsigned)a < (unsigned)side)
                val = boxes[pk * box + b * side + a];
            }
            v[k] = val;
            if (++xk == w) {
              xk = 0;
              if (++yk == h) {
                yk = 0;
                ++pk;
              }
            }
          }
          if (e + kChunk <= nv) {
            *reinterpret_cast<uint4*>(out + e) = pack(v);
          } else {
#pragma unroll
            for (int k = 0; k < kChunk; ++k)
              if (e + k < nv) out[e + k] = v[k];
          }
        }
        x += lv.step_x[l];
        if (x >= w) {
          x -= w;
          ++y;
        }
        y += lv.step_y[l];
        if (y >= h) {
          y -= h;
          ++p;
        }
        p += lv.step_p[l];
      }
    }
  }
}

template <typename T, int R>
void launch(const GradLevels& lv, const void* g, const float* coords, int num_levels, long BP,
            cudaStream_t st) {
  const unsigned blocks = (unsigned)((BP + kGroup - 1) / kGroup);
  corr_lookup_bwd_kernel<T, R><<<blocks, kThreads, 0, st>>>(lv, static_cast<const T*>(g),
                                                             coords, num_levels, BP);
}

template <typename T>
int launch_radius(const GradLevels& lv, const void* g, const float* coords, int num_levels,
                  long BP, int radius, cudaStream_t st) {
  switch (radius) {
    case 1: launch<T, 1>(lv, g, coords, num_levels, BP, st); break;
    case 2: launch<T, 2>(lv, g, coords, num_levels, BP, st); break;
    case 3: launch<T, 3>(lv, g, coords, num_levels, BP, st); break;
    case 4: launch<T, 4>(lv, g, coords, num_levels, BP, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// g (B, P, L*(2r+1)^2) and the level gradients (B, P, h_l, w_l) in one dtype
// (0 = float32, 1 = bfloat16), all contiguous, the gradients 16-byte
// aligned; coords (B, P, 2) float32 at level-0 scale; radius 1..4; (h_l,
// w_l) given for 4 levels, those beyond num_levels ignored, each with
// 8*h_l*w_l + 2048 < 2^31. Every value of every gradient map is written.
extern "C" int mft_corr_lookup_bwd(void* o0, void* o1, void* o2, void* o3, const void* g,
                                   const void* coords, int h0, int w0, int h1, int w1,
                                   int h2, int w2, int h3, int w3, int num_levels, long BP,
                                   int radius, int dtype, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 1 || radius > kMaxRadius ||
      BP < 1 || BP > 0x7fffffffL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  GradLevels lv = {{o0, o1, o2, o3}, {h0, h1, h2, h3}, {w0, w1, w2, w3}};
  const int chunk = dtype == 0 ? 4 : 8;
  for (int l = 0; l < num_levels; ++l) {
    const long h = lv.h[l], w = lv.w[l], hw = h * w;
    if (h < 1 || w < 1 ||
        kGroup * hw + (long)kThreads * chunk >= 0x7fffffffL ||
        reinterpret_cast<uintptr_t>(lv.out[l]) % 16)
      return (int)cudaErrorInvalidValue;
    const long step = (long)kThreads * chunk, rest = step % hw;
    lv.inv_hw[l] = 1.f / (float)hw;
    lv.inv_w[l] = 1.f / (float)w;
    lv.step_p[l] = (int)(step / hw);
    lv.step_y[l] = (int)(rest / w);
    lv.step_x[l] = (int)(rest % w);
  }
  auto st = static_cast<cudaStream_t>(stream);
  const auto* c = static_cast<const float*>(coords);
  if (dtype == 0) return launch_radius<float>(lv, g, c, num_levels, BP, radius, st);
  return launch_radius<__nv_bfloat16>(lv, g, c, num_levels, BP, radius, st);
}
