// Tiled products in float32 with one fixed summation order, for Hopper
// (sm_90a): the correlation volume written straight into the folded layout,
// and the update block's SAME-size convolutions. Their bfloat16 versions run
// on the tensor cores (product_tc.cu).
//
// mft_corr_build_folded  replaces mft_tpu/ops/corr_lookup_pallas.py
//                        build_corr_pyramid_pallas (_build_kernel) for float32
//                        features: for every pair b, source pixel p and level
//                        l, out_l[b, p, q] = (sum_c f1[b, c, p] * f2_l[b, c, q])
//                        * s with s = 1/sqrt(C) after the sum. f2_l is the
//                        level's pooled target features, (B, C, Q_l) with Q_l
//                        a multiple of 128 (a level of fewer than 128
//                        positions comes with zero feature columns up to 128,
//                        so its padding lanes are zero), so out_l is the
//                        folded (B, P, Q_l/128, 128) level: lane u*w + x of
//                        row q is image row q*fold + u. All levels of all
//                        pairs in one launch.
// mft_conv               replaces mft_tpu/ops/conv_pallas.py conv_pallas
//                        (_conv_kernel) for float32 inputs: out[b, n, y, x] =
//                        act(sum_k x[b, c, y + ky - pt, x + kx - pl] *
//                        w[n, c, ky, kx] + bias[n]) in NCHW, zeros outside the
//                        image, one cast to the output dtype; act none, relu,
//                        sigmoid or tanh. x may have any strides.
//
// Summation order. Every output is one f32 sum over k in ascending order from
// 0.0f, acc = acc + a_k * b_k, the product and the sum rounded apart
// (__fmul_rn, __fadd_rn), with k = c for the volume and k = (c, ky, kx) (the
// weight's own memory order) for the convolution. The plain PyTorch versions
// (ops/product.py) take the same sum one k at a time, so kernel and plain
// version give the same bits. The tensor cores would take f32 operands as
// TF32 (a 10-bit mantissa), well below what the plain versions compute, so
// these stay on the FMA units.
//
// What bounds them on this card: operations at the f32 rate (67 TFLOP/s,
// half that here, with two instructions per term). No configuration runs
// these products in f32 on its hot path; the compute dtype is bf16.
//
// What the design does about it. An SGEMM-style register-tiled product:
// a block of 256 threads computes a BM x BN output tile, stages BK-deep
// slices of both operands in shared memory (zero-filling the ragged edges
// and the convolution's padding), and each thread accumulates a TM x TN
// micro-tile in registers, reading its operands as float4 from shared
// memory. The next slice is loaded into registers while the current one is
// summed. The m index runs along the output's contiguous axis (pixels of an
// NCHW map; the target positions q of the volume, whose roles of A and B
// are swapped for that), so the stores coalesce.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 4;
constexpr int kPad = 4;  // floats of padding per shared-memory row (banks)

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// acc + a*b rounded as the plain version rounds it (see the header).
__device__ __forceinline__ float madd(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}

// The tile loop. Ops supplies K, a(k, m) and b(k, n) as f32 (zero outside),
// and says whether b is contiguous in k (the conv's weights) or in n.
// Thread t owns the micro-tile m = m0 + cm*(BM/(TM/4)) + tm*4 + i,
// n = n0 + cn*(BN/(TN/4)) + tn*4 + j, with tm = t % MT fastest.
template <int BM, int BN, int BK, int TM, int TN>
struct Tile {
  static constexpr int MT = BM / TM;  // threads along m
  static constexpr int NT = BN / TN;  // threads along n
  static_assert(MT * NT == kThreads, "one thread per micro-tile");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "float4 micro-tiles");
  static constexpr int A_PER = BK * BM / kThreads;  // a values loaded per thread
  static constexpr int B_PER = (BK * BN + kThreads - 1) / kThreads;
  static_assert(BK * BM % kThreads == 0, "whole A slices");

  template <typename Ops>
  __device__ static void run(const Ops& op, int m0, int n0, float (&acc)[TM][TN]) {
    __shared__ __align__(16) float As[BK][BM + kPad];
    __shared__ __align__(16) float Bs[BK][BN + kPad];
    const int t = threadIdx.x;
    const int tm = t % MT;
    const int tn = t / MT;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    float ra[A_PER], rb[B_PER];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int r = 0; r < A_PER; ++r) {
        const int e = t + r * kThreads;
        ra[r] = op.a(k0 + e / BM, m0 + e % BM);
      }
#pragma unroll
      for (int r = 0; r < B_PER; ++r) {
        const int e = t + r * kThreads;
        if (e < BK * BN) {
          const int kk = Ops::kBContiguousInK ? e % BK : e / BN;
          const int nn = Ops::kBContiguousInK ? e / BK : e % BN;
          rb[r] = op.b(k0 + kk, n0 + nn);
        }
      }
    };
    auto stash = [&]() {
#pragma unroll
      for (int r = 0; r < A_PER; ++r) {
        const int e = t + r * kThreads;
        As[e / BM][e % BM] = ra[r];
      }
#pragma unroll
      for (int r = 0; r < B_PER; ++r) {
        const int e = t + r * kThreads;
        if (e < BK * BN) {
          const int kk = Ops::kBContiguousInK ? e % BK : e / BN;
          const int nn = Ops::kBContiguousInK ? e / BK : e % BN;
          Bs[kk][nn] = rb[r];
        }
      }
    };

    const int K = op.K;
    fetch(0);
    for (int k0 = 0; k0 < K; k0 += BK) {
      stash();
      __syncthreads();
      if (k0 + BK < K) fetch(k0 + BK);  // in flight while this slice is summed
      // k beyond K reads zeros: acc + 0*0 leaves every value as it was
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int c = 0; c < TM / 4; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(&As[kk][c * MT * 4 + tm * 4]);
          a[4 * c] = v.x; a[4 * c + 1] = v.y; a[4 * c + 2] = v.z; a[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < TN / 4; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][c * NT * 4 + tn * 4]);
          b[4 * c] = v.x; b[4 * c + 1] = v.y; b[4 * c + 2] = v.z; b[4 * c + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = madd(acc[i][j], a[i], b[j]);
      }
      __syncthreads();
    }
  }

  __device__ static int m_of(int i) {
    return (i / 4) * MT * 4 + (threadIdx.x % MT) * 4 + i % 4;
  }
  __device__ static int n_of(int j) {
    return (j / 4) * NT * 4 + (threadIdx.x / MT) * 4 + j % 4;
  }
};

// ------------------------------------------------------------------------- //
// the folded volume: m = target position q of level l, n = source pixel p
// ------------------------------------------------------------------------- //
struct Levels {
  const void* f2[kMaxLevels];  // (B, C, Q_l)
  void* out[kMaxLevels];       // (B, P, Q_l)
  int q[kMaxLevels];           // Q_l, multiples of the m tile
  int tile0[kMaxLevels + 1];   // first m tile of each level
  int num_levels;
};

struct BuildOps {
  static constexpr bool kBContiguousInK = false;
  const float* f2;  // (C, Q) of this pair and level
  const float* f1;  // (C, P) of this pair
  int K, Q, P;
  __device__ float a(int k, int m) const {
    return (k < K && m < Q) ? f2[(long)k * Q + m] : 0.0f;
  }
  __device__ float b(int k, int n) const {
    return (k < K && n < P) ? f1[(long)k * P + n] : 0.0f;
  }
};

__global__ void __launch_bounds__(kThreads)
build_folded_kernel(Levels lv, const float* __restrict__ f1, int C, int P, float scale) {
  using Tl = Tile<128, 128, 8, 8, 8>;
  const int b = blockIdx.z;
  int l = 0;
  while (l + 1 < lv.num_levels && (int)blockIdx.x >= lv.tile0[l + 1]) ++l;
  const int Q = lv.q[l];
  const int m0 = ((int)blockIdx.x - lv.tile0[l]) * 128;
  const int n0 = blockIdx.y * 128;
  BuildOps op{static_cast<const float*>(lv.f2[l]) + (long)b * C * Q, f1 + (long)b * C * P,
              C, Q, P};
  float acc[8][8];
  Tl::run(op, m0, n0, acc);
  float* out = static_cast<float*>(lv.out[l]) + (long)b * P * Q;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int p = n0 + Tl::n_of(j);
    if (p >= P) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = m0 + Tl::m_of(i);
      if (q < Q) out[(long)p * Q + q] = __fmul_rn(acc[i][j], scale);
    }
  }
}

// ------------------------------------------------------------------------- //
// the convolution: m = (b, y, x) output pixel, n = output channel
// ------------------------------------------------------------------------- //
struct ConvShape {
  long sb, sc, sy, sx;  // strides of x in elements
  int B, Cin, H, W, Cout, kh, kw, pt, pl;
};

struct ConvOps {
  static constexpr bool kBContiguousInK = true;
  const float* x;  // (B, Cin, H, W)
  const float* w;  // (Cout, Cin, kh, kw) = (Cout, K)
  ConvShape s;
  int K, M;
  __device__ float a(int k, int m) const {
    if (k >= K || m >= M) return 0.0f;
    const int taps = s.kh * s.kw;
    const int c = k / taps;
    const int tap = k - c * taps;
    const int ky = tap / s.kw;
    const int kx = tap - ky * s.kw;
    const int hw = s.H * s.W;
    const int b = m / hw;
    const int pix = m - b * hw;
    const int y = pix / s.W + ky - s.pt;
    const int xx = pix - (pix / s.W) * s.W + kx - s.pl;
    if (y < 0 || y >= s.H || xx < 0 || xx >= s.W) return 0.0f;
    return x[b * s.sb + c * s.sc + y * s.sy + xx * s.sx];
  }
  __device__ float b(int k, int n) const {
    return (k < K && n < s.Cout) ? w[(long)n * K + k] : 0.0f;
  }
};

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

// The epilogue in the plain version's operations: torch.relu, torch.sigmoid
// (1 / (1 + exp(-v)) in f32) and torch.tanh.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return v > 0.0f ? v : 0.0f;
    case kSigmoid: return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
    case kTanh: return tanhf(v);
    default: return v;
  }
}

template <typename O, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, O* __restrict__ out, ConvShape s, int act) {
  using Tl = Tile<BM, BN, 8, TM, TN>;
  const int K = s.Cin * s.kh * s.kw;
  const int M = s.B * s.H * s.W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  ConvOps op{x, w, s, K, M};
  float acc[TM][TN];
  Tl::run(op, m0, n0, acc);
  const int hw = s.H * s.W;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + Tl::n_of(j);
    if (n >= s.Cout) continue;
    const float bn = bias[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + Tl::m_of(i);
      if (m >= M) continue;
      const int b = m / hw;
      const int pix = m - b * hw;
      const float v = activate(__fadd_rn(acc[i][j], bn), act);
      out[((long)b * s.Cout + n) * hw + pix] = from_f32<O>(v);
    }
  }
}

template <typename O, int BM, int BN, int TM, int TN>
cudaError_t launch_conv(const void* x, const void* w, const void* bias, void* out,
                        const ConvShape& s, int act, cudaStream_t stream) {
  const long M = (long)s.B * s.H * s.W;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((s.Cout + BN - 1) / BN));
  conv_kernel<O, BM, BN, TM, TN><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<O*>(out), s, act);
  return cudaGetLastError();
}

// Wide outputs take 128 x 128 tiles; outputs of at most 16 channels (the
// flow head's 2) take 256 x 16 tiles, so few lanes compute padding.
template <typename O>
cudaError_t conv_by_width(const void* x, const void* w, const void* bias, void* out,
                          const ConvShape& s, int act, cudaStream_t stream) {
  if (s.Cout <= 16)
    return launch_conv<O, 256, 16, 4, 4>(x, w, bias, out, s, act, stream);
  return launch_conv<O, 128, 128, 8, 8>(x, w, bias, out, s, act, stream);
}

}  // namespace

// float32 features and outputs. Levels beyond num_levels are ignored; Q_l
// must be multiples of 128.
extern "C" int mft_corr_build_folded(const void* f1, const void* f2_0, const void* f2_1,
                                     const void* f2_2, const void* f2_3, void* out0,
                                     void* out1, void* out2, void* out3, int q0, int q1,
                                     int q2, int q3, int num_levels, int B, int C, int P,
                                     float scale, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv = {};
  const void* f2[kMaxLevels] = {f2_0, f2_1, f2_2, f2_3};
  void* out[kMaxLevels] = {out0, out1, out2, out3};
  const int q[kMaxLevels] = {q0, q1, q2, q3};
  lv.num_levels = num_levels;
  lv.tile0[0] = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (q[l] <= 0 || q[l] % 128) return (int)cudaErrorInvalidValue;
    lv.f2[l] = f2[l];
    lv.out[l] = out[l];
    lv.q[l] = q[l];
    lv.tile0[l + 1] = lv.tile0[l] + q[l] / 128;
  }
  const dim3 grid((unsigned)lv.tile0[num_levels], (unsigned)((P + 127) / 128),
                  (unsigned)B);
  build_folded_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      lv, static_cast<const float*>(f1), C, P, scale);
  return (int)cudaGetLastError();
}

// float32 x (strides sb, sc, sy, sx in elements) and w, w and out
// contiguous, bias float32; out_dtype 0 = float32, 1 = bfloat16. act: 0 none,
// 1 relu, 2 sigmoid, 3 tanh.
extern "C" int mft_conv(const void* x, const void* w, const void* bias, void* out, long sb,
                        long sc, long sy, long sx, int B, int Cin, int H, int W, int Cout,
                        int kh, int kw, int pt, int pl, int act, int out_dtype,
                        void* stream) {
  if (act < kNone || act > kTanh) return (int)cudaErrorInvalidValue;
  const ConvShape s{sb, sc, sy, sx, B, Cin, H, W, Cout, kh, kw, pt, pl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return (int)conv_by_width<float>(x, w, bias, out, s, act, st);
  if (out_dtype == 1) return (int)conv_by_width<__nv_bfloat16>(x, w, bias, out, s, act, st);
  return (int)cudaErrorInvalidValue;
}
