// Window correlations from the features, with no all-pairs volume, for Hopper
// (sm_90a). Two entry points compute one function.
//
// mft_corr_alt  replaces mft_tpu/ops/alt_corr_pallas.py corr_lookup_alt
//               (_alt_kernel), the TPU form of the reference's alt_cuda_corr.
// mft_corr_win  replaces corr_lookup_win (_win_kernel), which recomputes only
//               the rows of the correlation map that a pixel tile touches.
//
// For pair b, source pixel p, level l and window channel k = i*(2r+1) + j:
//   out[b,p,l,k] = bilinear sample, zeros outside the map, at
//   (x/2^l + i - r, y/2^l + j - r) of q -> <f1[b,p], f2_l[b,q]> / sqrt(C).
// All 81 samples of a window share one fractional offset, so a pixel needs
// only the (2r+2)^2 = 100 dots with the integer taps around its window; the
// kernels compute those dots in f32 and combine them bilinearly in f32, in
// the order of the plain PyTorch version (ops/corr_alt.py), and write the
// samples in the features' dtype.
//
// What bounds it on this card. A pixel does 100 dots of C = 256 channels per
// level: 2*100*256 = 51,200 operations per pixel and level, about 5.9 GFLOP
// per call at 512x512 with 7 pairs, which the tensor cores could do in 6 us.
// Its compulsory bytes are f1, the target pyramid and the output (about
// 53 MB in bf16 at that size, 16 us at 3.35 TB/s), so the bound is bytes.
// But every pixel reads its 100 taps again: 100 * 512 B per level, about
// 5.9 GB of tap reads per call that L1/L2 (mft_corr_alt) or shared memory
// (mft_corr_win) must serve, which is what limits these simple kernels.
//
// What the designs do about it.
// - mft_corr_alt: one warp per (pair, pixel). Lanes form 4 groups of 8; each
//   group takes one tap at a time, its 8 lanes read 8 consecutive 16-byte
//   chunks of the tap's channels (coalesced 128-byte reads, f1 held in
//   registers) and reduce with 3 shuffles. Tap reads come from L2 and L1.
// - mft_corr_win: one block per 8x8 tile of source pixels of one pair. Per
//   level it reduces the tile's tap box. If the box holds at most 1600
//   positions (a quarter of the tile's taps) it is staged in shared memory
//   in bands of whole rows and all channels, each position read from device
//   memory once for the tile; each warp then computes its pixels' dots with
//   the taps of the band, exactly as mft_corr_alt does but reading shared
//   memory. A wider box (wild flow) falls back to mft_corr_alt's reads from
//   device memory; the result is the same (the port's form of the TPU
//   kernel's `fits` fallback). Staging whole channel rows, not channel
//   chunks, keeps one summation order for every dot. The dots run on the
//   CUDA cores; wgmma over the staged taps is the next step.
//
// Numerics: every dot sums its channels in the fixed order of the plain
// version (ops/corr_alt.py _tree_dots): lane s of a group takes channels
// c = 64*m + 8*s + q, forms the f32 products, adds them in halving trees
// over q and over m, and three xor shuffles add the 8 lanes' sums. The
// bilinear combination is the plain version's multiplies and adds; the
// library is built with -fmad=false, so no multiply-add is contracted and
// kernels and plain version give the same bits.
// All offsets into features and output are 64-bit: at 2160x3840 one f32
// output alone holds 7*129600*324*4 B = 1.18 GB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxTaps = 100;      // (2r+2)^2 at the largest radius, 4
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 8;          // lanes of one tap dot
constexpr int kGroups = 32 / kGroup;
constexpr int kMaxChunks = 4;      // 8-channel chunks per lane: C <= 256
constexpr int kTile = 8;           // win: 8x8 source pixels per block
constexpr int kTileP = kTile * kTile;
constexpr int kMaxBox = kTileP * kMaxTaps / 4;  // win: staged box positions
constexpr int kDotsBytes = kTileP * kMaxTaps * (int)sizeof(float);
constexpr int kBandBytes = 80 * 1024;  // win: a band of the staged box; with the
                                       // dots, two blocks fit an SM's 228 KB
static_assert(kMaxChunks == 4, "the m-tree below adds exactly 4 chunk sums");

struct Features {
  const void* lvl[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive channels as f32.
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}

// floor(v) as an int, with out-of-range (and non-finite) values pinned far
// outside any map, so every tap of such a window reads as zero.
__device__ __forceinline__ int floor_to_int(float v) {
  return (int)fminf(fmaxf(v, -1.0e6f), 1.0e6f);
}

// A lane's share of a pixel's source features: chunks lane%8 + 8*m.
template <typename T>
__device__ __forceinline__ void load_f1(const T* __restrict__ f1, int C,
                                        float (&f1v)[kMaxChunks][8]) {
  const int gl = (threadIdx.x & 31) % kGroup;
  const int nchunks = C / 8;
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int ch = gl + kGroup * m;
    if (ch < nchunks) {
      load8(f1 + ch * 8, f1v[m]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q) f1v[m][q] = 0.0f;
    }
  }
}

// Halving tree over 8 products: ((p0+p4) + (p2+p6)) + ((p1+p5) + (p3+p7)).
__device__ __forceinline__ float tree8(const float (&p)[8]) {
  const float a0 = p[0] + p[4], a1 = p[1] + p[5], a2 = p[2] + p[6], a3 = p[3] + p[7];
  return (a0 + a2) + (a1 + a3);
}

// This lane's part of one tap dot: its 4 chunks of 8 channels, each a tree
// of products, then (m0 + m2) + (m1 + m3). Chunks beyond C count as zero.
template <typename T>
__device__ __forceinline__ float lane_dot(const T* row, const float (&f1v)[kMaxChunks][8],
                                          int gl, int nchunks) {
  float sm[kMaxChunks];
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int ch = gl + kGroup * m;
    sm[m] = 0.0f;
    if (ch < nchunks) {
      float v[8];
      load8(row + ch * 8, v);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = f1v[m][q] * v[q];
      sm[m] = tree8(v);
    }
  }
  return (sm[0] + sm[2]) + (sm[1] + sm[3]);
}

// The whole warp computes taps t in [t_begin, t_end) of one pixel at one
// level: dots[tx * side + ty] for the tap at (bx + tx, by + ty), t = ty *
// side + tx, scaled, zero outside the (h, w) map. row(x, y) gives the tap's
// C channels (device or shared memory).
template <typename T, typename RowFn>
__device__ void warp_tap_dots(RowFn row, int h, int w, int C,
                              const float (&f1v)[kMaxChunks][8], int bx, int by,
                              int side, int t_begin, int t_end, float scale,
                              float* dots) {
  const int lane = threadIdx.x & 31;
  const int g = lane / kGroup;
  const int gl = lane % kGroup;
  const int nchunks = C / 8;
  for (int t0 = t_begin; t0 < t_end; t0 += kGroups) {
    const int t = t0 + g;
    const int ty = t / side;
    const int tx = t - ty * side;
    const int x = bx + tx;
    const int y = by + ty;
    const bool valid = (t < t_end) & (x >= 0) & (x < w) & (y >= 0) & (y < h);
    float part = valid ? lane_dot<T>(row(x, y), f1v, gl, nchunks) : 0.0f;
    part = part + __shfl_xor_sync(0xffffffffu, part, 4);
    part = part + __shfl_xor_sync(0xffffffffu, part, 2);
    part = part + __shfl_xor_sync(0xffffffffu, part, 1);
    if (gl == 0 && t < t_end) dots[tx * side + ty] = valid ? part * scale : 0.0f;
  }
}

// Sample k = i*n + j from the tap dots d[tx * side + ty], in the order of the
// plain version.
__device__ __forceinline__ float bilinear(const float* dots, int side, int n, int k,
                                          float wx, float wy) {
  const int i = k / n;
  const int j = k - i * n;
  const float* d = dots + i * side + j;
  float acc = d[0] * ((1.0f - wx) * (1.0f - wy));
  acc = acc + d[side] * (wx * (1.0f - wy));
  acc = acc + d[1] * ((1.0f - wx) * wy);
  acc = acc + d[side + 1] * (wx * wy);
  return acc;
}

// ------------------------------------------------------------------------- //
// mft_corr_alt: one warp per (pair, pixel)
// ------------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads)
alt_kernel(Features f2, const T* __restrict__ f1, const float* __restrict__ coords,
           T* __restrict__ out, long BP, long P, int C, int L, int radius,
           float scale) {
  __shared__ float sdots[kWarps][kMaxTaps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const long bp = (long)blockIdx.x * kWarps + warp;
  if (bp >= BP) return;             // the whole warp leaves; no block barrier
  const long b = bp / P;
  const int n = 2 * radius + 1;
  const int side = n + 1;
  float f1v[kMaxChunks][8];
  load_f1(f1 + bp * C, C, f1v);
  const float cx = coords[2 * bp];
  const float cy = coords[2 * bp + 1];
  T* o = out + bp * (long)(L * n * n);
  float* dots = sdots[warp];
  for (int l = 0; l < L; ++l) {
    const float inv = 1.0f / (float)(1 << l);   // a power of two: exact
    const float x = cx * inv;
    const float y = cy * inv;
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float wx = x - x0f;
    const float wy = y - y0f;
    const int h = f2.h[l];
    const int w = f2.w[l];
    const T* map = static_cast<const T*>(f2.lvl[l]) + b * (long)h * w * C;
    auto row = [&](int xi, int yi) { return map + ((long)yi * w + xi) * C; };
    warp_tap_dots<T>(row, h, w, C, f1v, floor_to_int(x0f) - radius,
                     floor_to_int(y0f) - radius, side, 0, side * side, scale, dots);
    __syncwarp();
    for (int k = lane; k < n * n; k += 32)
      o[l * n * n + k] = from_f32<T>(bilinear(dots, side, n, k, wx, wy));
    __syncwarp();
  }
}

// ------------------------------------------------------------------------- //
// mft_corr_win: one block per 8x8 tile of source pixels
// ------------------------------------------------------------------------- //
template <typename T>
__global__ void __launch_bounds__(kThreads)
win_kernel(Features f2, const T* __restrict__ f1, const float* __restrict__ coords,
           T* __restrict__ out, int H8, int W8, int C, int L, int radius, float scale,
           int* __restrict__ stats) {
  // dynamic shared memory: [the tile's dots][a band of the staged box]
  extern __shared__ uint4 smem[];
  float* sdots = reinterpret_cast<float*>(smem);
  T* band = reinterpret_cast<T*>(reinterpret_cast<char*>(smem) + kDotsBytes);

  __shared__ float s_cx[kTileP], s_cy[kTileP];
  __shared__ int s_bx[kTileP], s_by[kTileP];
  __shared__ int s_box[4];                     // x_lo, x_hi, y_lo, y_hi of all taps

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tiles_x = (W8 + kTile - 1) / kTile;
  const int tiles_y = (H8 + kTile - 1) / kTile;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int t_in = blockIdx.x - b * tiles_x * tiles_y;
  const int ty0 = (t_in / tiles_x) * kTile;
  const int tx0 = (t_in % tiles_x) * kTile;
  const long P = (long)H8 * W8;
  const int n = 2 * radius + 1;
  const int nn = n * n;
  const int side = n + 1;
  const int Cout = L * nn;
  const int units = C * (int)sizeof(T) / 16;   // 16-byte units of one position

  // pixel pl = dy*8 + dx of the tile is source pixel (ty0+dy, tx0+dx)
  auto pixel_ok = [&](int pl) {
    return (ty0 + pl / kTile < H8) & (tx0 + pl % kTile < W8);
  };
  auto pixel_bp = [&](int pl) {
    return (long)b * P + (long)(ty0 + pl / kTile) * W8 + (tx0 + pl % kTile);
  };
  if (tid < kTileP && pixel_ok(tid)) {
    const long bp = pixel_bp(tid);
    s_cx[tid] = coords[2 * bp];
    s_cy[tid] = coords[2 * bp + 1];
  }

  for (int l = 0; l < L; ++l) {
    const int h = f2.h[l];
    const int w = f2.w[l];
    const T* map = static_cast<const T*>(f2.lvl[l]) + (long)b * h * w * C;
    const float inv = 1.0f / (float)(1 << l);

    // the tile's tap box at this level; the dots start at zero (taps outside
    // the map are never staged)
    if (tid == 0) {
      s_box[0] = INT_MAX; s_box[1] = INT_MIN; s_box[2] = INT_MAX; s_box[3] = INT_MIN;
    }
    __syncthreads();   // also: the previous level is done with every buffer
    for (int e = tid; e < kTileP * kMaxTaps; e += kThreads) sdots[e] = 0.0f;
    if (tid < kTileP && pixel_ok(tid)) {
      const int bx = floor_to_int(floorf(s_cx[tid] * inv)) - radius;
      const int by = floor_to_int(floorf(s_cy[tid] * inv)) - radius;
      s_bx[tid] = bx;
      s_by[tid] = by;
      atomicMin(&s_box[0], bx);
      atomicMax(&s_box[1], bx + side - 1);
      atomicMin(&s_box[2], by);
      atomicMax(&s_box[3], by + side - 1);
    }
    __syncthreads();
    const int x_lo = max(s_box[0], 0);
    const int y_lo = max(s_box[2], 0);
    const int nbx = max(min(s_box[1], w - 1) - x_lo + 1, 0);
    const int nby = max(min(s_box[3], h - 1) - y_lo + 1, 0);
    const long nbox = (long)nbx * nby;
    const long row_bytes = (long)nbx * C * (long)sizeof(T);
    const long fit_rows = nbx > 0 ? kBandBytes / row_bytes : 0;
    const int band_rows = fit_rows < nby ? (int)fit_rows : nby;
    const bool staged = nbox == 0 || (band_rows >= 1 && nbox <= kMaxBox);
    if (stats != nullptr && tid == 0) atomicAdd(&stats[staged ? 0 : 1], 1);

    if (staged) {
      for (int y0 = y_lo; y0 < y_lo + nby; y0 += band_rows) {
        const int rows = min(band_rows, y_lo + nby - y0);
        __syncthreads();   // the previous band is read
        const long total = (long)rows * nbx * units;
        uint4* dst = reinterpret_cast<uint4*>(band);
        for (long e = tid; e < total; e += kThreads) {
          const long pos = e / units;
          const int u = (int)(e - pos * units);
          const int py = y0 + (int)(pos / nbx);
          const int px = x_lo + (int)(pos % nbx);
          dst[e] = reinterpret_cast<const uint4*>(map + ((long)py * w + px) * C)[u];
        }
        __syncthreads();
        auto row = [&](int xi, int yi) {
          return (const T*)band + ((long)(yi - y0) * nbx + (xi - x_lo)) * C;
        };
        for (int pl = warp; pl < kTileP; pl += kWarps) {
          if (!pixel_ok(pl)) continue;   // uniform across the warp
          // this pixel's tap rows inside the band: t in [ty_a, ty_b) * side
          const int ty_a = max(y0 - s_by[pl], 0);
          const int ty_b = min(y0 + rows - s_by[pl], side);
          if (ty_a >= ty_b) continue;
          float f1v[kMaxChunks][8];
          load_f1(f1 + pixel_bp(pl) * C, C, f1v);
          warp_tap_dots<T>(row, h, w, C, f1v, s_bx[pl], s_by[pl], side, ty_a * side,
                           ty_b * side, scale, sdots + pl * kMaxTaps);
        }
      }
    } else {
      auto row = [&](int xi, int yi) { return map + ((long)yi * w + xi) * C; };
      for (int pl = warp; pl < kTileP; pl += kWarps) {
        if (!pixel_ok(pl)) continue;   // uniform across the warp
        float f1v[kMaxChunks][8];
        load_f1(f1 + pixel_bp(pl) * C, C, f1v);
        warp_tap_dots<T>(row, h, w, C, f1v, s_bx[pl], s_by[pl], side, 0, side * side,
                         scale, sdots + pl * kMaxTaps);
      }
    }
    __syncthreads();

    for (int e = tid; e < kTileP * nn; e += kThreads) {
      const int pl = e / nn;
      const int k = e - pl * nn;
      if (!pixel_ok(pl)) continue;
      const float x = s_cx[pl] * inv;
      const float y = s_cy[pl] * inv;
      const float wx = x - floorf(x);
      const float wy = y - floorf(y);
      out[pixel_bp(pl) * Cout + l * nn + k] =
          from_f32<T>(bilinear(sdots + pl * kMaxTaps, side, n, k, wx, wy));
    }
  }
}

Features make_features(const void* l0, const void* l1, const void* l2, const void* l3,
                       const int* hw) {
  Features f;
  const void* lv[kMaxLevels] = {l0, l1, l2, l3};
  for (int l = 0; l < kMaxLevels; ++l) {
    f.lvl[l] = lv[l];
    f.h[l] = hw[2 * l];
    f.w[l] = hw[2 * l + 1];
  }
  return f;
}

bool bad_shape(int L, int B, int H8, int W8, int C, int radius) {
  return L < 1 || L > kMaxLevels || B < 1 || H8 < 1 || W8 < 1 || C < 8 || C % 8 != 0 ||
         C > 8 * kGroup * kMaxChunks || radius < 0 || (2 * radius + 2) * (2 * radius + 2) > kMaxTaps;
}

template <typename T>
cudaError_t launch_alt(const Features& f2, const void* f1, const float* coords, void* out,
                       int B, int H8, int W8, int C, int L, int radius, float scale,
                       cudaStream_t stream) {
  const long P = (long)H8 * W8;
  const long BP = (long)B * P;
  const long blocks = (BP + kWarps - 1) / kWarps;
  alt_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      f2, static_cast<const T*>(f1), coords, static_cast<T*>(out), BP, P, C, L, radius,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_win(const Features& f2, const void* f1, const float* coords, void* out,
                       int B, int H8, int W8, int C, int L, int radius, float scale,
                       int* stats, cudaStream_t stream) {
  const int smem = kDotsBytes + kBandBytes;
  cudaError_t err = cudaFuncSetAttribute(
      win_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((H8 + kTile - 1) / kTile) * ((W8 + kTile - 1) / kTile);
  win_kernel<T><<<(unsigned)(B * tiles), kThreads, smem, stream>>>(
      f2, static_cast<const T*>(f1), coords, static_cast<T*>(out), H8, W8, C, L, radius,
      scale, stats);
  return cudaGetLastError();
}

}  // namespace

// f1 (B, H8, W8, C) and the levels (B, h_l, w_l, C) channel-last and 16-byte
// aligned, of one dtype (0 = float32, 1 = bfloat16); coords (B, H8*W8, 2)
// float32; out (B, H8*W8, L*(2r+1)^2) in the same dtype. Levels beyond L are
// ignored (their pointers may be null). scale = 1/sqrt(C) as float32.
extern "C" int mft_corr_alt(void* out, const void* f1, const void* coords, const void* l0,
                            const void* l1, const void* l2, const void* l3, int h0, int w0,
                            int h1, int w1, int h2, int w2, int h3, int w3, int L, int B,
                            int H8, int W8, int C, int radius, float scale, int dtype,
                            void* stream) {
  if (bad_shape(L, B, H8, W8, C, radius)) return (int)cudaErrorInvalidValue;
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const Features f2 = make_features(l0, l1, l2, l3, hw);
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_alt<__nv_bfloat16>(f2, f1, c, out, B, H8, W8, C, L, radius, scale, s);
  if (dtype == 0)
    return (int)launch_alt<float>(f2, f1, c, out, B, H8, W8, C, L, radius, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As mft_corr_alt, plus stats (nullable) int32[2]: counts of the staged and
// the unstaged (tile, level) pairs.
extern "C" int mft_corr_win(void* out, const void* f1, const void* coords, const void* l0,
                            const void* l1, const void* l2, const void* l3, int h0, int w0,
                            int h1, int w1, int h2, int w2, int h3, int w3, int L, int B,
                            int H8, int W8, int C, int radius, float scale, int dtype,
                            void* stats, void* stream) {
  if (bad_shape(L, B, H8, W8, C, radius)) return (int)cudaErrorInvalidValue;
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const Features f2 = make_features(l0, l1, l2, l3, hw);
  const float* c = static_cast<const float*>(coords);
  int* st = static_cast<int*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_win<__nv_bfloat16>(f2, f1, c, out, B, H8, W8, C, L, radius, scale,
                                          st, s);
  if (dtype == 0)
    return (int)launch_win<float>(f2, f1, c, out, B, H8, W8, C, L, radius, scale, st, s);
  return (int)cudaErrorInvalidValue;
}
