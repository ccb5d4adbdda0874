// Window lookups on the other stored forms of the RAFT correlation volume,
// for Hopper (sm_90a), four entry points over one templated gather.
//
// mft_corr_lookup_q          replaces mft_tpu/ops/corr_lookup_pallas.py
//                            corr_lookup_pallas_q (_kernel_pixel_major_q):
//                            int8 (B, P, h_l, w_l) levels, value = q * scale[b, l].
// mft_corr_lookup_packed     replaces corr_lookup_pallas_packed (_kernel_packed):
//                            all levels side by side in one (B, P, H0, sum w_l)
//                            map per pixel, level l in columns [off_l, off_l + w_l)
//                            and rows [0, h_l), zeros below.
// mft_corr_lookup_packed_i8  replaces corr_lookup_pallas_packed_i8: that map in
//                            int8 with a scale per (pair, level).
// mft_corr_lookup_t          replaces corr_lookup_pallas_t (_kernel_lane_major):
//                            lane-major (B, h_l, w_l, P) levels, the source pixel
//                            on the fastest axis.
// mft_corr_lookup_folded     replaces corr_lookup_pallas_folded (_kernel_folded):
//                            folded (B, P, rows_l, 128) levels, lane u*w + x of
//                            row q holding image row q*fold + u (fold = 128/w);
//                            a level of fewer than 128 values fills the first
//                            h_l*w_l lanes of its one zero-padded row.
//
// Each writes the same (B, P, L*(2r+1)^2) window samples as mft_corr_lookup
// (corr_gather.cu): per pixel, a bilinear zero-padded (2r+1)^2 window from
// each level of its own correlation map, channel k = l*(2r+1)^2 + i*(2r+1) + j
// sampled at (x/2^l + i - r, y/2^l + j - r). A tap outside its level's own
// h_l x w_l map is zero: in the packed map a tap never reads the columns of a
// neighbouring level, in a folded one never the padding lanes. int8 taps are dequantized (float(q) * scale, f32) before
// they are weighted, and the int8 forms write bfloat16; the others write the
// volume dtype.
//
// What bounds them on this card. Like mft_corr_lookup, the bytes of the taps
// the windows touch plus the output: about 23 MB of bf16 taps and 18.6 MB of
// bf16 samples per launch at 512x512 with 7 pairs. int8 halves the taps but
// not the output. The TPU kernels contracted tent-weight matrices against
// each pixel's whole map (or, lane-major, against every map position for 128
// pixels at once) because the TPU has no fast gather; here every sample
// gathers its own four taps.
//
// What the design does about it. The pixel-major forms (q, packed,
// packed_i8) take one thread per output sample, as mft_corr_lookup does:
// consecutive threads write consecutive samples of one pixel and share its
// taps in L1. The lane-major form puts consecutive pixels on consecutive
// threads (a block holds 32 pixels and its 8 warps walk the channels) and
// stages the block's (32, C) samples in shared memory, so the output is still
// written in whole rows. Its tap reads coalesce only where neighbouring
// pixels read the same map position (a constant flow); a gather of each
// pixel's own window reads one sector per pixel otherwise.
//
// A folded level whose rows hold whole image rows (fold*w = 128) is its
// dense (h_l, w_l) map under another shape: value (y, x) is element y*w + x.
// So the folded form needs only its strides, not the TPU's per-fold dots,
// and reuses the pixel-major gather (the mixed form, whose levels are all
// dense, is corr_gather.cu's mft_corr_lookup_mixed).
//
// Arithmetic is written in the order of the plain PyTorch versions
// (ops/corr_lookup.py) and built with -fmad=false, so each kernel is
// bit-identical to its plain version. All offsets are 64-bit: the int8
// volume of 7 pairs at 1080x1920 holds 9.7e9 values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kThreads = 256;
constexpr int kTileT = 32;  // pixels per block of the lane-major kernel

// Where level l's value at (pair b, source pixel p, row y, column x) lies:
// base[l] + b*bstride + p*pstride + y*rstride + x*cstride + coff (elements).
struct Layout {
  const void* base[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  long bstride[kMaxLevels];
  long pstride[kMaxLevels];
  long rstride[kMaxLevels];
  long cstride[kMaxLevels];
  long coff[kMaxLevels];
  const float* scales;  // (B, L) int8 scales, or null
  int num_levels;
};

// One stored value as f32: float and bf16 are widened, int8 is dequantized.
__device__ __forceinline__ float tap_value(float v, float) { return v; }
__device__ __forceinline__ float tap_value(__nv_bfloat16 v, float) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float tap_value(int8_t v, float scale) {
  return static_cast<float>(v) * scale;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ float tap(const T* map, long rstride, long cstride, int h,
                                     int w, int xi, int yi, float scale) {
  const bool valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h);
  return valid ? tap_value(map[(long)yi * rstride + (long)xi * cstride], scale) : 0.0f;
}

// Window sample k of pixel p of pair b at level-0 centre (cx, cy).
template <typename T>
__device__ float window_sample(const Layout& lay, int b, int p, float cx, float cy,
                               int k, int radius) {
  const int n = 2 * radius + 1;
  const int nn = n * n;
  const int l = k / nn;
  const int rem = k - l * nn;
  const int i = rem / n;
  const int j = rem - i * n;
  const int h = lay.h[l];
  const int w = lay.w[l];
  const T* map = static_cast<const T*>(lay.base[l]) + (long)b * lay.bstride[l]
                 + (long)p * lay.pstride[l] + lay.coff[l];
  const long rs = lay.rstride[l];
  const long cs = lay.cstride[l];
  const float scale = lay.scales ? lay.scales[b * lay.num_levels + l] : 1.0f;
  const float inv = 1.0f / (float)(1 << l);  // a power of two: exact
  const float x = cx * inv + (float)(i - radius);
  const float y = cy * inv + (float)(j - radius);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  float acc = tap(map, rs, cs, h, w, x0, y0, scale) * ((1.0f - wx) * (1.0f - wy));
  acc = acc + tap(map, rs, cs, h, w, x0 + 1, y0, scale) * (wx * (1.0f - wy));
  acc = acc + tap(map, rs, cs, h, w, x0, y0 + 1, scale) * ((1.0f - wx) * wy);
  acc = acc + tap(map, rs, cs, h, w, x0 + 1, y0 + 1, scale) * (wx * wy);
  return acc;
}

// Pixel-major: one thread per output sample, out[(b*P + p)*C + k].
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
pixel_major_kernel(Layout lay, const float* __restrict__ coords, O* __restrict__ out,
                   long total, int P, int C, int radius) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long bp = idx / C;
  const int k = (int)(idx - bp * C);
  const int b = (int)(bp / P);
  const int p = (int)(bp - (long)b * P);
  out[idx] = from_f32<O>(
      window_sample<T>(lay, b, p, coords[2 * bp], coords[2 * bp + 1], k, radius));
}

// Lane-major: a block takes kTileT consecutive pixels of one pair, lane =
// pixel; its warps walk the channels, and the (kTileT, C) samples go through
// shared memory so the output rows are written contiguously.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lane_major_kernel(Layout lay, const float* __restrict__ coords, T* __restrict__ out,
                  int P, int C, int radius) {
  extern __shared__ float4 smem4[];
  T* s = reinterpret_cast<T*>(smem4);  // [kTileT][C]
  const int tiles = (P + kTileT - 1) / kTileT;
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * kTileT;
  const int lane = threadIdx.x % kTileT;
  const int p = p0 + lane;
  const int np = min(kTileT, P - p0);
  if (lane < np) {
    const long bp = (long)b * P + p;
    const float cx = coords[2 * bp];
    const float cy = coords[2 * bp + 1];
    for (int k = threadIdx.x / kTileT; k < C; k += kThreads / kTileT) {
      s[lane * C + k] = from_f32<T>(window_sample<T>(lay, b, p, cx, cy, k, radius));
    }
  }
  __syncthreads();
  T* o = out + ((long)b * P + p0) * C;
  for (int e = threadIdx.x; e < np * C; e += kThreads) o[e] = s[e];
}

int channels(int num_levels, int radius) {
  const int n = 2 * radius + 1;
  return num_levels * n * n;
}

bool bad_levels(int num_levels) { return num_levels < 1 || num_levels > kMaxLevels; }

// Separate (B, P, h_l, w_l) levels.
Layout pixel_major_levels(const void* const* lv, const int* hw, int num_levels, int P) {
  Layout lay = {};
  for (int l = 0; l < num_levels; ++l) {
    const long hwl = (long)hw[2 * l] * hw[2 * l + 1];
    lay.base[l] = lv[l];
    lay.h[l] = hw[2 * l];
    lay.w[l] = hw[2 * l + 1];
    lay.bstride[l] = (long)P * hwl;
    lay.pstride[l] = hwl;
    lay.rstride[l] = hw[2 * l + 1];
    lay.cstride[l] = 1;
    lay.coff[l] = 0;
  }
  lay.num_levels = num_levels;
  return lay;
}

// One (B, P, H0, Wp) map, level l in columns [sum_{m<l} w_m, ... + w_l).
Layout packed_levels(const void* packed, int H0, int Wp, const int* hw, int num_levels,
                     int P) {
  Layout lay = {};
  long off = 0;
  for (int l = 0; l < num_levels; ++l) {
    lay.base[l] = packed;
    lay.h[l] = hw[2 * l];
    lay.w[l] = hw[2 * l + 1];
    lay.bstride[l] = (long)P * H0 * Wp;
    lay.pstride[l] = (long)H0 * Wp;
    lay.rstride[l] = Wp;
    lay.cstride[l] = 1;
    lay.coff[l] = off;
    off += hw[2 * l + 1];
  }
  lay.num_levels = num_levels;
  return lay;
}

// Separate (B, h_l, w_l, P) levels.
Layout lane_major_levels(const void* const* lv, const int* hw, int num_levels, int P) {
  Layout lay = {};
  for (int l = 0; l < num_levels; ++l) {
    const long w = hw[2 * l + 1];
    lay.base[l] = lv[l];
    lay.h[l] = hw[2 * l];
    lay.w[l] = hw[2 * l + 1];
    lay.bstride[l] = (long)hw[2 * l] * w * P;
    lay.pstride[l] = 1;
    lay.rstride[l] = w * P;
    lay.cstride[l] = P;
    lay.coff[l] = 0;
  }
  lay.num_levels = num_levels;
  return lay;
}

// Folded (B, P, rows_l, 128) levels, value (y, x) at lane offset y*w + x.
Layout folded_levels(const void* const* lv, const int* hw, const int* rows, int num_levels,
                     int P) {
  Layout lay = {};
  for (int l = 0; l < num_levels; ++l) {
    const long pstride = (long)rows[l] * 128;
    lay.base[l] = lv[l];
    lay.h[l] = hw[2 * l];
    lay.w[l] = hw[2 * l + 1];
    lay.bstride[l] = (long)P * pstride;
    lay.pstride[l] = pstride;
    lay.rstride[l] = hw[2 * l + 1];
    lay.cstride[l] = 1;
    lay.coff[l] = 0;
  }
  lay.num_levels = num_levels;
  return lay;
}

template <typename T, typename O>
cudaError_t launch_pixel_major(const Layout& lay, const void* coords, void* out, int B,
                               int P, int radius, cudaStream_t stream) {
  const int C = channels(lay.num_levels, radius);
  const long total = (long)B * P * C;
  const long blocks = (total + kThreads - 1) / kThreads;
  pixel_major_kernel<T, O><<<(unsigned)blocks, kThreads, 0, stream>>>(
      lay, static_cast<const float*>(coords), static_cast<O*>(out), total, P, C, radius);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lane_major(const Layout& lay, const void* coords, void* out, int B,
                              int P, int radius, cudaStream_t stream) {
  const int C = channels(lay.num_levels, radius);
  const size_t smem = sizeof(T) * kTileT * (size_t)C;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        lane_major_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long blocks = (long)B * ((P + kTileT - 1) / kTileT);
  lane_major_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      lay, static_cast<const float*>(coords), static_cast<T*>(out), P, C, radius);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Levels beyond num_levels are ignored
// (their pointers may be null); (h_l, w_l) are given for 4 levels.
extern "C" int mft_corr_lookup_q(void* out, const void* coords, const void* scales,
                                 const void* l0, const void* l1, const void* l2,
                                 const void* l3, int h0, int w0, int h1, int w1, int h2,
                                 int w2, int h3, int w3, int num_levels, int B, int P,
                                 int radius, void* stream) {
  if (bad_levels(num_levels)) return (int)cudaErrorInvalidValue;
  const void* lv[kMaxLevels] = {l0, l1, l2, l3};
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  Layout lay = pixel_major_levels(lv, hw, num_levels, P);
  lay.scales = static_cast<const float*>(scales);
  return (int)launch_pixel_major<int8_t, __nv_bfloat16>(
      lay, coords, out, B, P, radius, static_cast<cudaStream_t>(stream));
}

extern "C" int mft_corr_lookup_packed(void* out, const void* coords, const void* packed,
                                      int H0, int Wp, int h0, int w0, int h1, int w1,
                                      int h2, int w2, int h3, int w3, int num_levels,
                                      int B, int P, int radius, int dtype, void* stream) {
  if (bad_levels(num_levels)) return (int)cudaErrorInvalidValue;
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const Layout lay = packed_levels(packed, H0, Wp, hw, num_levels, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_pixel_major<__nv_bfloat16, __nv_bfloat16>(lay, coords, out, B, P,
                                                                  radius, s);
  if (dtype == 0)
    return (int)launch_pixel_major<float, float>(lay, coords, out, B, P, radius, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mft_corr_lookup_packed_i8(void* out, const void* coords, const void* scales,
                                         const void* packed, int H0, int Wp, int h0,
                                         int w0, int h1, int w1, int h2, int w2, int h3,
                                         int w3, int num_levels, int B, int P,
                                         int radius, void* stream) {
  if (bad_levels(num_levels)) return (int)cudaErrorInvalidValue;
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  Layout lay = packed_levels(packed, H0, Wp, hw, num_levels, P);
  lay.scales = static_cast<const float*>(scales);
  return (int)launch_pixel_major<int8_t, __nv_bfloat16>(
      lay, coords, out, B, P, radius, static_cast<cudaStream_t>(stream));
}

extern "C" int mft_corr_lookup_t(void* out, const void* coords, const void* l0,
                                 const void* l1, const void* l2, const void* l3, int h0,
                                 int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                                 int num_levels, int B, int P, int radius, int dtype,
                                 void* stream) {
  if (bad_levels(num_levels)) return (int)cudaErrorInvalidValue;
  const void* lv[kMaxLevels] = {l0, l1, l2, l3};
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const Layout lay = lane_major_levels(lv, hw, num_levels, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch_lane_major<__nv_bfloat16>(lay, coords, out, B, P, radius, s);
  if (dtype == 0) return (int)launch_lane_major<float>(lay, coords, out, B, P, radius, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int mft_corr_lookup_folded(void* out, const void* coords, const void* l0,
                                      const void* l1, const void* l2, const void* l3,
                                      int h0, int w0, int h1, int w1, int h2, int w2,
                                      int h3, int w3, int r0, int r1, int r2, int r3,
                                      int num_levels, int B, int P, int radius, int dtype,
                                      void* stream) {
  if (bad_levels(num_levels)) return (int)cudaErrorInvalidValue;
  const void* lv[kMaxLevels] = {l0, l1, l2, l3};
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const int rows[kMaxLevels] = {r0, r1, r2, r3};
  const Layout lay = folded_levels(lv, hw, rows, num_levels, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_pixel_major<__nv_bfloat16, __nv_bfloat16>(lay, coords, out, B, P,
                                                                  radius, s);
  if (dtype == 0)
    return (int)launch_pixel_major<float, float>(lay, coords, out, B, P, radius, s);
  return (int)cudaErrorInvalidValue;
}
