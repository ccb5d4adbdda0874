// RAFT correlation-pyramid window lookup fused with convc1, for Hopper (sm_90a).
//
// mft_corr_lookup_conv  replaces mft_tpu/ops/corr_lookup_pallas.py
//                       corr_lookup_pallas_fused (_kernel_pixel_major_fused):
//                       per pixel, a bilinear zero-padded (2r+1)^2 window from
//                       each level of its own (h_l, w_l) correlation map (the
//                       samples of mft_corr_lookup, corr_gather.cu), rounded
//                       through the volume dtype, then relu(samples @ Wc + b),
//                       the motion encoder's 324->256 1x1 convc1, accumulated in
//                       f32 and written (B, P, F) in the volume dtype.
//
// Window order keeps the reference's transposed quirk: channel
// k = l*(2r+1)^2 + i*(2r+1) + j samples at (x/2^l + i - r, y/2^l + j - r), the
// FIRST window axis offsets x.
//
// What bounds it on this card. The TPU kernel multiplied tent-weight matrices
// against each pixel's whole h x w map because the TPU has no fast gather.
// Hopper gathers: a window reads only the 10x10 taps around its centre, a few
// sectors per map row, so the lookup is bound by the bytes of those taps
// (about 23 MB per launch at 512x512, 7 pairs) plus its output. The fused
// form adds 2*324*256 operations per pixel (4.75 GFLOP per launch at the slice),
// which would take about 5 us on the tensor cores.
//
// What the design does about it. The kernel stages a tile of 32 pixels'
// samples in shared memory (k-major, so the 32 pixel values of one k are one
// broadcast read of 8 float4) and each of 256 threads owns one output
// channel, walking k with 32 f32 FMAs per weight it reads. This is the simple form: the contraction runs on the CUDA
// cores, not the tensor cores, and is the first thing to move to wgmma.
//
// Arithmetic is written in the order of the plain PyTorch version
// (ops/corr_lookup.py) and built with -fmad=false, so the window samples are
// bit-identical to it; only the fused contraction's sum order differs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kTileP = 32;      // pixels per block in the fused kernel
constexpr int kThreads = 256;

struct Pyramid {
  const void* lvl[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float tap(const T* map, int h, int w, int xi, int yi) {
  const bool valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h);
  return valid ? to_f32(map[(long)yi * w + xi]) : 0.0f;
}

// Window sample k of pixel bp (flat b*P + p) at level-0 centre (cx, cy).
template <typename T>
__device__ float window_sample(const Pyramid& pyr, long bp, float cx, float cy,
                               int k, int radius) {
  const int n = 2 * radius + 1;
  const int nn = n * n;
  const int l = k / nn;
  const int rem = k - l * nn;
  const int i = rem / n;
  const int j = rem - i * n;
  const int h = pyr.h[l];
  const int w = pyr.w[l];
  const T* map = static_cast<const T*>(pyr.lvl[l]) + bp * (long)h * w;
  const float inv = 1.0f / (float)(1 << l);  // a power of two: exact
  const float x = cx * inv + (float)(i - radius);
  const float y = cy * inv + (float)(j - radius);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  float acc = tap(map, h, w, x0, y0) * ((1.0f - wx) * (1.0f - wy));
  acc = acc + tap(map, h, w, x0 + 1, y0) * (wx * (1.0f - wy));
  acc = acc + tap(map, h, w, x0, y0 + 1) * ((1.0f - wx) * wy);
  acc = acc + tap(map, h, w, x0 + 1, y0 + 1) * (wx * wy);
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lookup_conv_kernel(Pyramid pyr, const float* __restrict__ coords,
                   const T* __restrict__ wc, const float* __restrict__ bias,
                   T* __restrict__ out, long BP, int C, int F, int radius) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);  // [C][kTileP], k-major
  const long p0 = (long)blockIdx.x * kTileP;

  // phase 1: the tile's window samples, rounded through the volume dtype
  for (int e = threadIdx.x; e < kTileP * C; e += blockDim.x) {
    const int pl = e / C;
    const int k = e - pl * C;
    const long bp = p0 + pl;
    float v = 0.0f;
    if (bp < BP) {
      v = to_f32(from_f32<T>(
          window_sample<T>(pyr, bp, coords[2 * bp], coords[2 * bp + 1], k, radius)));
    }
    s[k * kTileP + pl] = v;
  }
  __syncthreads();

  // phase 2: out[p, f] = relu(sum_k s[k, p] * wc[k, f] + bias[f])
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc[kTileP];
#pragma unroll
    for (int p = 0; p < kTileP; ++p) acc[p] = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float wv = to_f32(wc[(long)k * F + f]);
      const float4* row = reinterpret_cast<const float4*>(s + k * kTileP);
#pragma unroll
      for (int q = 0; q < kTileP / 4; ++q) {
        const float4 sv = row[q];
        acc[4 * q + 0] = __fmaf_rn(sv.x, wv, acc[4 * q + 0]);
        acc[4 * q + 1] = __fmaf_rn(sv.y, wv, acc[4 * q + 1]);
        acc[4 * q + 2] = __fmaf_rn(sv.z, wv, acc[4 * q + 2]);
        acc[4 * q + 3] = __fmaf_rn(sv.w, wv, acc[4 * q + 3]);
      }
    }
    const float b = bias[f];
#pragma unroll
    for (int p = 0; p < kTileP; ++p) {
      if (p0 + p < BP) out[(p0 + p) * F + f] = from_f32<T>(fmaxf(acc[p] + b, 0.0f));
    }
  }
}

Pyramid make_pyramid(const void* l0, const void* l1, const void* l2, const void* l3,
                     const int* hw) {
  Pyramid pyr;
  const void* lv[kMaxLevels] = {l0, l1, l2, l3};
  for (int l = 0; l < kMaxLevels; ++l) {
    pyr.lvl[l] = lv[l];
    pyr.h[l] = hw[2 * l];
    pyr.w[l] = hw[2 * l + 1];
  }
  return pyr;
}

template <typename T>
cudaError_t launch_lookup_conv(const Pyramid& pyr, const float* coords, const void* wc,
                               const float* bias, void* out, long BP, int C, int F,
                               int radius, cudaStream_t stream) {
  const size_t smem = sizeof(float) * kTileP * (size_t)C;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lookup_conv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long blocks = (BP + kTileP - 1) / kTileP;
  lookup_conv_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      pyr, coords, static_cast<const T*>(wc), bias, static_cast<T*>(out), BP, C, F,
      radius);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Levels beyond num_levels are ignored
// (their pointers may be null); (h_l, w_l) are given for 4 levels.
extern "C" int mft_corr_lookup_conv(void* out, const void* coords, const void* wc,
                                    const void* bias, const void* l0, const void* l1,
                                    const void* l2, const void* l3, int h0, int w0,
                                    int h1, int w1, int h2, int w2, int h3, int w3,
                                    int num_levels, long BP, int radius, int F,
                                    int dtype, void* stream) {
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  if (num_levels < 1 || num_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  const Pyramid pyr = make_pyramid(l0, l1, l2, l3, hw);
  const int n = 2 * radius + 1;
  const int C = num_levels * n * n;
  const float* c = static_cast<const float*>(coords);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_lookup_conv<__nv_bfloat16>(pyr, c, wc, b, out, BP, C, F, radius, s);
  if (dtype == 0)
    return (int)launch_lookup_conv<float>(pyr, c, wc, b, out, BP, C, F, radius, s);
  return (int)cudaErrorInvalidValue;
}
