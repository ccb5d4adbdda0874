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
// only the (2r+2)^2 = 100 dots with the integer taps around its window; they
// are combined bilinearly in f32, in the order of the plain PyTorch version
// (ops/corr_alt.py), and the samples are written in the features' dtype.
//
// What bounds it on this card. A pixel does 100 dots of C = 256 channels per
// level: 2*100*256 = 51,200 operations per pixel and level, about 5.9 GFLOP
// per call at 512x512 with 7 pairs. Its compulsory bytes are f1, the target
// pyramid and the output (about 53 MB in bf16 at that size, 16 us at
// 3.35 TB/s), so the bound is bytes. But every pixel reads its 100 taps
// again: about 5.9 GB of tap reads per call if each pixel reads its own.
//
// bfloat16: one tile product on the tensor cores (window_tc_kernel, both
// entry points), as the TPU kernels ran one MXU dot of a tile against the map.
// - One block per 8x8 tile of source pixels of one pair, two blocks an SM
//   (107,776 bytes of shared memory at C = 256): the tile's f1 (64 x C,
//   wgmma's M = 64) is staged once as the A operand, K-major with the 32-byte
//   swizzle of tensor_core.cuh, K = C rounded up to 16 with zeros.
// - Per level, the tile's tap box (the union of its windows' (2r+2)^2 taps,
//   clipped to the map) is walked in chunks of 32 positions in row-major
//   order, three chunks in flight (cp.async, 16 bytes a thread): each
//   position's C channels are a K-major row of the B operand. Each warpgroup
//   runs m64n16k16 over its 16 positions of the chunk and scatters the f32
//   products: element (pixel, position) goes, scaled, to that pixel's tap
//   slot if the position lies in its window; the rest are discarded. About
//   2.5x the needed dots, but the box is read from L2 once per tile, not
//   once per pixel.
// - The rounding repair keeps the plain version's bits. A sample is a convex
//   combination of four tap dots, so its tensor-core value lies within the
//   largest of their gaps to the plain version's tree-order dots; each gap is
//   below e = kWindow * scale * ||f1_p|| * ||f2_q||, and the kernel takes the
//   largest ||f2_q|| of the box (one number a tile and level, reduced as the
//   chunks land; e = 0 for a sample with no tap in the map, an exact 0). Pass
//   1, a warp per row of the tile and a lane per sample, writes every sample
//   whose value v has bf16(v - e) == bf16(v + e): the plain value lies in that
//   interval and rounds the same way. Every other sample sets its pixel's bit
//   in a 64-bit mask of each of its four tap positions (in the ring's space).
//   The marked taps become one list in box order (a prefix sum over the
//   block); each of the 32 8-lane groups takes an equal run of it, copies the
//   C channels of each new position from device memory into one of two rows of
//   its own in the ring (cp.async; the next position's copy in flight while
//   this one is used) and computes the tree-order dot with the pixel's row of
//   the A tile. A level that marks more than 2,048 taps recomputes every dot
//   as a wild tile does. Pass 2 combines the marked samples from those dots:
//   the plain version's bits.
// - A box of more than kMaxBox positions (wild flow) is not staged: the
//   tile's taps are read from device memory per pixel on the CUDA cores in
//   the plain order, as mft_corr_alt's float32 kernel does (the port's form
//   of the TPU kernel's `fits` fallback). stats counts both kinds of
//   (tile, level) pairs.
// The result is held to ops.product_error_bound (K = C, scale 1/sqrt(C))
// with S from ops.corr_window_magnitude, and equals the plain version's
// wherever the premise of the repair holds.
//
// float32 keeps the CUDA-core kernels, exact, with no TF32:
// - mft_corr_alt (alt_kernel): one warp per (pair, pixel). Lanes form 4
//   groups of 8; each group takes one tap at a time, its 8 lanes read 8
//   consecutive 16-byte chunks of the tap's channels (f1 held in registers)
//   and reduce with 3 shuffles. Tap reads come from L2 and L1.
// - mft_corr_win (win_kernel): one block per 8x8 tile. Per level, a box of
//   at most kMaxBox positions is staged in shared memory in bands of whole
//   rows and all channels; each warp computes its pixels' dots from the band
//   exactly as alt_kernel does. A wider box reads device memory as
//   alt_kernel does.
//
// Numerics of the CUDA-core dots: every dot sums its channels in the fixed
// order of the plain version (ops/corr_alt.py _tree_dots): lane s of a group
// takes channels c = 64*m + 8*s + q, forms the f32 products, adds them in
// halving trees over q and over m, and three xor shuffles add the 8 lanes'
// sums. The bilinear combination is the plain version's multiplies and adds;
// the library is built with -fmad=false, so no multiply-add is contracted.
// All offsets into features and output are 64-bit: at 2160x3840 one f32
// output alone holds 7*129600*324*4 B = 1.18 GB.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

// Sample (i, j) from the tap dots d[tx * side + ty], in the order of the
// plain version.
__device__ __forceinline__ float bilinear_ij(const float* dots, int side, int i, int j,
                                             float wx, float wy) {
  const float* d = dots + i * side + j;
  float acc = d[0] * ((1.0f - wx) * (1.0f - wy));
  acc = acc + d[side] * (wx * (1.0f - wy));
  acc = acc + d[1] * ((1.0f - wx) * wy);
  acc = acc + d[side + 1] * (wx * wy);
  return acc;
}

// Sample k = i*n + j.
__device__ __forceinline__ float bilinear(const float* dots, int side, int n, int k,
                                          float wx, float wy) {
  const int i = k / n;
  return bilinear_ij(dots, side, i, k - i * n, wx, wy);
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

// ------------------------------------------------------------------------- //
// bfloat16: the tile's taps as one product on the tensor cores
// ------------------------------------------------------------------------- //
constexpr int kChunk = 32;          // box positions per staged chunk: B's N
constexpr int kHalf = kChunk / 2;   // positions of a warpgroup: m64n16
constexpr int kStages = 3;          // chunks in flight
constexpr int kMaskBytes = kMaxBox * 8;   // the repair: 64 pixel bits a position
constexpr int kRowBytes = 8 * kGroup * kMaxChunks * 2;   // a position's bf16 channels, C <= 256
// the repair's ring: the list of marked taps (position << 6 | pixel; a level
// that marks more recomputes every dot), then the masks, which two rows for
// each 8-lane group overlay once the list is made
constexpr int kListCap = 2048;
constexpr int kListBytes = kListCap * 4;
constexpr int kRowsBytes = kWarps * kGroups * 2 * kRowBytes;
constexpr int kRepairBytes = kListBytes + (kMaskBytes > kRowsBytes ? kMaskBytes : kRowsBytes);
constexpr int kSamples = 3;         // samples of a lane per pixel and level: 3 * 32 >= 81
// the repair's window over scale * ||f1_p|| * max_q ||f2_q||; mirrored in
// tests/test_torch_alt_bound.py
constexpr float kWindow = 1.0f / (1 << 21);
static_assert(kWarps == kTile, "pass 1 and 2: a warp per row of the tile");
static_assert(kTileP == 64, "the repair: a 64-bit pixel mask a position");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// d += A * B, m64n16k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n16_k(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : MFT_D8(0)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ unsigned short bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 8 bf16 values of a 16-byte unit as f32.
__device__ __forceinline__ void unpack8(const uint4 x, float v[8]) {
  const uint32_t wd[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(wd[q] << 16);
    v[2 * q + 1] = __uint_as_float(wd[q] & 0xFFFF0000u);
  }
}

// The sum of squares of the first `units` 16-byte units of row `row` of a
// K-major operand of `rows` rows with the 32-byte swizzle, by the PARTS
// consecutive lanes part = 0..PARTS-1 (units part, part + PARTS, ...).
template <int PARTS>
__device__ __forceinline__ float row_sq(const uint8_t* base, int row, int rows, int units,
                                        int part) {
  float sq = 0.0f;
  for (int u = part; u < units; u += PARTS) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(base + sw32_offset(row, 8 * u, rows)), v);
#pragma unroll
    for (int q = 0; q < 8; ++q) sq = fmaf(v[q], v[q], sq);
  }
#pragma unroll
  for (int d = 1; d < PARTS; d <<= 1) sq += __shfl_xor_sync(0xffffffffu, sq, d);
  return sq;
}

// As lane_dot, with the pixel's features from row `row` of the A tile (64
// rows, K-major with the 32-byte swizzle) and the tap's C channels at `tap`
// in shared memory: lane s's chunks s + 8m of 8 channels, each a tree of
// products, then (m0 + m2) + (m1 + m3); the group's three xor shuffles
// complete the dot.
__device__ __forceinline__ float lane_dot_a(const uint8_t* a, int row, const uint8_t* tap, int gl,
                                            int nchunks) {
  float sm[kMaxChunks];
#pragma unroll
  for (int m = 0; m < kMaxChunks; ++m) {
    const int ch = gl + kGroup * m;
    sm[m] = 0.0f;
    if (ch < nchunks) {
      float x[8], y[8];
      unpack8(*reinterpret_cast<const uint4*>(a + sw32_offset(row, 8 * ch, kTileP)), x);
      unpack8(*reinterpret_cast<const uint4*>(tap + 16 * ch), y);
#pragma unroll
      for (int q = 0; q < 8; ++q) x[q] = x[q] * y[q];
      sm[m] = tree8(x);
    }
  }
  return (sm[0] + sm[2]) + (sm[1] + sm[3]);
}

// The ring of kStages chunks (kChunk x K each); after a level's products it
// holds the repair's pixel masks and rows: a multiple of 256 bytes.
__host__ __device__ __forceinline__ int ring_bytes(int K) {
  return kStages * kChunk * K * 2 > kRepairBytes ? kStages * kChunk * K * 2 : kRepairBytes;
}

// Bytes of dynamic shared memory: from a 256-byte aligned base, A (64 x K),
// the ring and the tile's tap dots (64 x 100 f32); K = C rounded up to 16.
// 107,776 bytes at C = 256: two blocks an SM.
__host__ __device__ __forceinline__ int window_tc_smem(int K) {
  return 256 + kTileP * K * 2 + ring_bytes(K) + kDotsBytes;
}

// K = C rounded up to 16; Cout = L * (2r+1)^2.
__global__ void __launch_bounds__(kThreads, 2)
window_tc_kernel(Features f2, const __nv_bfloat16* __restrict__ f1,
                 const float* __restrict__ coords, __nv_bfloat16* __restrict__ out, int H8,
                 int W8, int C, int K, int L, int radius, float scale, int* __restrict__ stats) {
  using T = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* a_s = align256(smem_raw);
  uint8_t* ring = a_s + kTileP * K * 2;
  const int chunk_bytes = kChunk * K * 2;
  float* sdots = reinterpret_cast<float*>(ring + ring_bytes(K));
  // the repair: bit p of word 2Q + p / 32 marks the tap of pixel p at box
  // position Q; then the list of marked taps
  uint32_t* list = reinterpret_cast<uint32_t*>(ring);
  uint32_t* mask = list + kListCap;
  const int n = 2 * radius + 1;
  const int nn = n * n;
  const int side = n + 1;
  const int Cout = L * nn;

  // the level table, indexed by the level below: in shared memory, not in a
  // stack copy of the parameter
  __shared__ Features s_f2;
  __shared__ float s_cx[kTileP], s_cy[kTileP], s_n1[kTileP];
  __shared__ int s_bx[kTileP], s_by[kTileP];
  __shared__ uint32_t s_flag[kTileP][kSamples];  // samples to combine again
  __shared__ int s_box[4];                       // x_lo, x_hi, y_lo, y_hi of all taps
  __shared__ uint32_t s_sq;                      // max_q ||f2_q||^2 over the box, as bits
  __shared__ int s_marked;                       // some tap is marked
  __shared__ int s_warp_sum[kWarps];             // the repair's list: a prefix over warps
  __shared__ int s_count;                        // its entries

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31, wg = tid / 128;
  const int g = lane / kGroup, gl = lane % kGroup;
  const int tiles_x = (W8 + kTile - 1) / kTile;
  const int tiles_y = (H8 + kTile - 1) / kTile;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int t_in = blockIdx.x - b * tiles_x * tiles_y;
  const int ty0 = (t_in / tiles_x) * kTile;
  const int tx0 = (t_in % tiles_x) * kTile;
  const long P = (long)H8 * W8;
  const int KU = K / 8, CU = C / 8;   // 16-byte units of a row: staged, real

  auto pixel_ok = [&](int pl) {
    return (ty0 + pl / kTile < H8) & (tx0 + pl % kTile < W8);
  };
  auto pixel_bp = [&](int pl) {
    return (long)b * P + (long)(ty0 + pl / kTile) * W8 + (tx0 + pl % kTile);
  };

  // A: the tile's f1 rows; zeros past C and for pixels outside the map
  for (int e = tid; e < kTileP * KU; e += kThreads) {
    const int m = e / KU, u = e - m * KU;
    uint8_t* dst = a_s + sw32_offset(m, 8 * u, kTileP);
    if (u < CU && pixel_ok(m))
      cp_async16(smem_u32(dst), f1 + pixel_bp(m) * C + 8 * u);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
  if (tid < kTileP && pixel_ok(tid)) {
    const long bp = pixel_bp(tid);
    s_cx[tid] = coords[2 * bp];
    s_cy[tid] = coords[2 * bp + 1];
  }
  if (tid == 0) s_f2 = f2;
  cp_async_wait_all();
  __syncthreads();
  {   // ||f1_p||, four threads a row
    const float sq = row_sq<4>(a_s, tid >> 2, kTileP, CU, tid & 3);
    if ((tid & 3) == 0) s_n1[tid >> 2] = sqrtf(sq);
  }
  // the samples k = lane + 32 s of this lane: window offsets (i, j)
  int si[kSamples], sj[kSamples];
#pragma unroll
  for (int s = 0; s < kSamples; ++s) {
    const int k = lane + 32 * s;
    si[s] = k / n;
    sj[s] = k - si[s] * n;
  }
  const uint32_t a0 = smem_u32(a_s);

  for (int l = 0; l < L; ++l) {
    const int h = s_f2.h[l];
    const int w = s_f2.w[l];
    const T* map = static_cast<const T*>(s_f2.lvl[l]) + (long)b * h * w * C;
    const float inv = 1.0f / (float)(1 << l);

    if (tid == 0) {
      s_box[0] = INT_MAX; s_box[1] = INT_MIN; s_box[2] = INT_MAX; s_box[3] = INT_MIN;
      s_sq = 0u;
      s_marked = 0;
    }
    __syncthreads();   // also: the previous level is done with every buffer
    for (int e = tid; e < kTileP * kMaxTaps; e += kThreads) sdots[e] = 0.0f;
    if (tid < kTileP * kSamples) (&s_flag[0][0])[tid] = 0u;
    if (tid < kTileP) {
      int bx = -(1 << 20), by = -(1 << 20);   // pixels outside the map: no tap
      if (pixel_ok(tid)) {
        bx = floor_to_int(floorf(s_cx[tid] * inv)) - radius;
        by = floor_to_int(floorf(s_cy[tid] * inv)) - radius;
        atomicMin(&s_box[0], bx);
        atomicMax(&s_box[1], bx + side - 1);
        atomicMin(&s_box[2], by);
        atomicMax(&s_box[3], by + side - 1);
      }
      s_bx[tid] = bx;
      s_by[tid] = by;
    }
    __syncthreads();
    const int x_lo = max(s_box[0], 0);
    const int y_lo = max(s_box[2], 0);
    const int nbx = max(min(s_box[1], w - 1) - x_lo + 1, 0);
    const int nby = max(min(s_box[3], h - 1) - y_lo + 1, 0);
    const long nbox_l = (long)nbx * nby;
    const bool staged = nbox_l <= kMaxBox;
    const int nbox = staged ? (int)nbox_l : 0;
    if (stats != nullptr && tid == 0) atomicAdd(&stats[staged ? 0 : 1], 1);
    // position Q of the box -> its row: exact for Q < 2^20 (the quotient
    // stays 0.5/nbx from an integer, the rounding far closer)
    const float rcp_nbx = 1.0f / (float)max(nbx, 1);
    auto box_row = [&](int Q) { return (int)((Q + 0.5f) * rcp_nbx); };

    // every tap dot of the tile from device memory in the plain order, a warp
    // a pixel: a wild tile, or more marked taps than the repair's list holds
    auto exact_dots = [&]() {
      auto row = [&](int xi, int yi) { return map + ((long)yi * w + xi) * C; };
      for (int pl = warp; pl < kTileP; pl += kWarps) {
        if (!pixel_ok(pl)) continue;   // uniform across the warp
        float f1v[kMaxChunks][8];
        load_f1(f1 + pixel_bp(pl) * C, C, f1v);
        warp_tap_dots<T>(row, h, w, C, f1v, s_bx[pl], s_by[pl], side, 0, side * side, scale,
                         sdots + pl * kMaxTaps);
      }
      __syncthreads();
    };

    if (nbox > 0) {
      // sweep: chunk j holds positions [32 j, 32 j + 32) of the box, row-major,
      // staged a warp a position at a time, a lane a 16-byte unit (rows past
      // the box are left as they are: their columns are never read); three
      // chunks in flight
      const int nchunks = (nbox + kChunk - 1) / kChunk;
      auto stage = [&](int j) {
        uint8_t* buf = ring + (j % kStages) * chunk_bytes;
        for (int q = warp; q < kChunk; q += kWarps) {
          const int Q = j * kChunk + q;
          if (Q >= nbox || lane >= KU) continue;
          uint8_t* dst = buf + sw32_offset(q, 8 * lane, kChunk);
          if (lane < CU) {
            const int qy = box_row(Q);
            cp_async16(smem_u32(dst),
                       map + ((long)(y_lo + qy) * w + x_lo + Q - qy * nbx) * C + 8 * lane);
          } else {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
          }
        }
      };
#pragma unroll
      for (int j = 0; j < kStages - 1; ++j) {
        if (j < nchunks) stage(j);
        cp_async_commit();
      }
      const int r0 = acc_row(0), r1 = acc_row(2);
      const int bx0 = s_bx[r0], by0 = s_by[r0], bx1 = s_bx[r1], by1 = s_by[r1];
      for (int j = 0; j < nchunks; ++j) {
        cp_async_wait_group<kStages - 2>();   // this thread's part of chunk j
        fence_proxy_async();
        __syncthreads();   // chunk j is in; every thread is done with chunk j - 1
        if (j + kStages - 1 < nchunks) stage(j + kStages - 1);
        cp_async_commit();
        const uint8_t* buf = ring + (j % kStages) * chunk_bytes;
        // each warpgroup m64n16 over its 16 positions of the chunk
        float acc[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
        const uint32_t b0 = smem_u32(buf) + wg * kHalf * 32;
        fence_acc(acc);
        wgmma_fence();
        for (int ks = 0; ks < K / 16; ++ks)
          wgmma_ss_n16_k(acc, sw32_desc(a0 + ks * kTileP * 32), sw32_desc(b0 + ks * kChunk * 32));
        wgmma_commit();
        {   // while the tensor cores run: max_q ||f2_q||^2 of the chunk's positions
          const float sq = row_sq<8>(buf, tid >> 3, kChunk, CU, tid & 7);
          const uint32_t mx = __reduce_max_sync(
              0xffffffffu, j * kChunk + (tid >> 3) < nbox ? __float_as_uint(sq) : 0u);
          if (lane == 0) atomicMax(&s_sq, mx);   // non-negative floats order as their bits
        }
        wgmma_wait_all();
        fence_acc(acc);
        // each product to its pixel's tap slot, if the position is in its window
#pragma unroll
        for (int i = 0; i < 8; i += 2) {
          // columns acc_col(i), acc_col(i) + 1 of rows r0 (i % 4 < 2) or r1
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            const int Q = j * kChunk + wg * kHalf + acc_col(i) + h2;
            const int qy = box_row(Q);
            const int tx = x_lo + Q - qy * nbx - ((i & 2) ? bx1 : bx0);
            const int ty = y_lo + qy - ((i & 2) ? by1 : by0);
            if (Q < nbox && (unsigned)tx < (unsigned)side && (unsigned)ty < (unsigned)side)
              sdots[((i & 2) ? r1 : r0) * kMaxTaps + tx * side + ty] = acc[i + h2] * scale;
          }
        }
      }
      cp_async_wait_all();
      __syncthreads();   // every dot is in; the ring is free
      for (int e = tid; e < 2 * nbox; e += kThreads) mask[e] = 0u;
      __syncthreads();
    } else if (!staged) {
      exact_dots();   // a wild tile
    }

    // pass 1, a warp per row of the tile, a lane per sample: each sample out,
    // unless its tensor-core value v has bf16(v - e) != bf16(v + e), e =
    // kWindow * scale * ||f1_p|| * max_q ||f2_q|| over the box (0 if none of
    // its taps is in the map); then it marks its taps and waits for pass 2
    const float n2 = sqrtf(__uint_as_float(s_sq));
    for (int dx = 0; dx < kTile; ++dx) {
      const int pl = warp * kTile + dx;
      if (!pixel_ok(pl)) break;   // uniform across the warp
      const float x = s_cx[pl] * inv;
      const float y = s_cy[pl] * inv;
      const float wx = x - floorf(x), wy = y - floorf(y);
      const int bx = s_bx[pl], by = s_by[pl];
      const bool inside = bx >= 0 && bx + side <= w && by >= 0 && by + side <= h;   // every tap
      const float e = kWindow * scale * s_n1[pl] * n2;
      T* o = out + pixel_bp(pl) * Cout + l * nn;
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        const int k = lane + 32 * s;
        bool flagged = false;
        if (k < nn) {
          const float v = bilinear_ij(sdots + pl * kMaxTaps, side, si[s], sj[s], wx, wy);
          // tensor-core dots (nbox > 0; the others are the plain ones), at
          // least one of its taps in the map (else v is an exact 0)
          uint32_t in_map = 0xFu;
          if (!inside) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int px = bx + si[s] + (q & 1), py = by + sj[s] + (q >> 1);
              if (px < 0 || px >= w || py < 0 || py >= h) in_map &= ~(1u << q);
            }
          }
          flagged = nbox > 0 && in_map != 0u && bf16_bits(v - e) != bf16_bits(v + e);
          if (flagged) {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int px = bx + si[s] + (q & 1), py = by + sj[s] + (q >> 1);
              if ((in_map >> q) & 1u)
                atomicOr(&mask[2 * ((py - y_lo) * nbx + px - x_lo) + (pl >> 5)],
                         1u << (pl & 31));
            }
          } else {
            o[k] = __float2bfloat16_rn(v);
          }
        }
        const uint32_t fb = __ballot_sync(0xffffffffu, flagged);
        if (lane == 0) {
          s_flag[pl][s] = fb;
          if (fb) s_marked = 1;
        }
      }
    }
    __syncthreads();

    // the repair: the marked taps as a list in box order (each thread its
    // share of the positions, an exclusive prefix over the block), then an
    // 8-lane group an equal run of it: each new position's C channels copied
    // from device memory into one of the group's two rows in the ring (the
    // next position's copy in flight while this one is used), the tree-order
    // dot with the pixel's row of the A tile. A lane reads back only the
    // 16-byte units it copied.
    if (s_marked) {
      uint8_t* rows = ring + kListBytes + (warp * kGroups + g) * 2 * kRowBytes;
      {
        const int per = (nbox + kThreads - 1) / kThreads;
        const int q0 = min(tid * per, nbox), q1 = min(q0 + per, nbox);
        int cnt = 0;
        for (int Q = q0; Q < q1; ++Q) cnt += __popc(mask[2 * Q]) + __popc(mask[2 * Q + 1]);
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += t;
        }
        if (lane == 31) s_warp_sum[warp] = incl;
        __syncthreads();
        int base = incl - cnt;
        for (int v = 0; v < warp; ++v) base += s_warp_sum[v];
        if (tid == kThreads - 1) s_count = base + cnt;
        for (int Q = q0; Q < q1 && base < kListCap; ++Q) {
          for (int h2 = 0; h2 < 2; ++h2)
            for (uint32_t m = mask[2 * Q + h2]; m && base < kListCap; m &= m - 1)
              list[base++] = Q << 6 | (32 * h2 + __ffs(m) - 1);
        }
        __syncthreads();   // the list is made; the masks are free for the rows
      }
      const int count = s_count;
      if (count > kListCap) {
        exact_dots();
      } else {
        // group gid takes entries [e_begin, e_end): consecutive entries of one
        // position share its row, copied when the position changes
        const int gid = warp * kGroups + g;
        const int e_begin = count * gid / (kWarps * kGroups);
        const int e_end = count * (gid + 1) / (kWarps * kGroups);
        const int rounds = __reduce_max_sync(0xffffffffu, e_end - e_begin);
        auto fetch = [&](int e, int slot) {   // entry e's row into slot, if e is the group's
          if (e < e_end) {
            const int Q = list[e] >> 6;
            const int qy = box_row(Q);
            const T* src = map + ((long)(y_lo + qy) * w + x_lo + Q - qy * nbx) * C;
#pragma unroll
            for (int m = 0; m < kMaxChunks; ++m) {
              const int ch = gl + kGroup * m;
              if (ch < CU) cp_async16(smem_u32(rows + slot * kRowBytes + 16 * ch), src + 8 * ch);
            }
          }
          cp_async_commit();
        };
        int slot = 0;
        fetch(e_begin, slot);
        for (int r = 0; r < rounds; ++r) {   // warp-uniform
          const int e = e_begin + r;
          const bool ok = e < e_end;
          const uint32_t entry = ok ? list[e] : 0u;
          // the next entry's row, into the other slot if its position differs
          const bool next_new = e + 1 < e_end && (list[e + 1] >> 6) != (entry >> 6);
          if (next_new) fetch(e + 1, slot ^ 1);
          else cp_async_commit();
          cp_async_wait_group<1>();   // this lane's units of entry e
          const int Q = entry >> 6, pl = entry & 63;
          float part = ok ? lane_dot_a(a_s, pl, rows + slot * kRowBytes, gl, CU) : 0.0f;
          part = part + __shfl_xor_sync(0xffffffffu, part, 4);
          part = part + __shfl_xor_sync(0xffffffffu, part, 2);
          part = part + __shfl_xor_sync(0xffffffffu, part, 1);
          if (ok && gl == 0) {
            const int qy = box_row(Q);
            const int tx = x_lo + Q - qy * nbx - s_bx[pl], ty = y_lo + qy - s_by[pl];
            sdots[pl * kMaxTaps + tx * side + ty] = part * scale;
          }
          if (next_new) slot ^= 1;
        }
        cp_async_wait_all();
        __syncthreads();
      }
    }

    // pass 2: the flagged samples from the repaired dots
    for (int dx = 0; dx < kTile; ++dx) {
      const int pl = warp * kTile + dx;
      if (!pixel_ok(pl)) break;
      const float x = s_cx[pl] * inv;
      const float y = s_cy[pl] * inv;
      T* o = out + pixel_bp(pl) * Cout + l * nn;
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        if ((s_flag[pl][s] >> lane) & 1)
          o[lane + 32 * s] = __float2bfloat16_rn(bilinear_ij(
              sdots + pl * kMaxTaps, side, si[s], sj[s], x - floorf(x), y - floorf(y)));
      }
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

cudaError_t launch_alt(const Features& f2, const float* f1, const float* coords, float* out,
                       int B, int H8, int W8, int C, int L, int radius, float scale,
                       cudaStream_t stream) {
  const long P = (long)H8 * W8;
  const long BP = (long)B * P;
  const long blocks = (BP + kWarps - 1) / kWarps;
  alt_kernel<float><<<(unsigned)blocks, kThreads, 0, stream>>>(f2, f1, coords, out, BP, P, C, L,
                                                              radius, scale);
  return cudaGetLastError();
}

cudaError_t launch_win(const Features& f2, const float* f1, const float* coords, float* out,
                       int B, int H8, int W8, int C, int L, int radius, float scale,
                       int* stats, cudaStream_t stream) {
  // set on the current device at every call: another device may come next
  const int smem = kDotsBytes + kBandBytes;
  cudaError_t err = cudaFuncSetAttribute(
      win_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((H8 + kTile - 1) / kTile) * ((W8 + kTile - 1) / kTile);
  win_kernel<float><<<(unsigned)(B * tiles), kThreads, smem, stream>>>(
      f2, f1, coords, out, H8, W8, C, L, radius, scale, stats);
  return cudaGetLastError();
}

cudaError_t launch_tc(const Features& f2, const void* f1, const float* coords, void* out, int B,
                      int H8, int W8, int C, int L, int radius, float scale, int* stats,
                      cudaStream_t stream) {
  const int K = (C + 15) / 16 * 16;
  const int smem = window_tc_smem(K);
  // set on the current device at every call: another device may come next
  cudaError_t err = cudaFuncSetAttribute(
      window_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((H8 + kTile - 1) / kTile) * ((W8 + kTile - 1) / kTile);
  window_tc_kernel<<<(unsigned)(B * tiles), kThreads, smem, stream>>>(
      f2, static_cast<const __nv_bfloat16*>(f1), coords, static_cast<__nv_bfloat16*>(out), H8,
      W8, C, K, L, radius, scale, stats);
  return cudaGetLastError();
}

}  // namespace

// f1 (B, H8, W8, C) and the levels (B, h_l, w_l, C) channel-last and 16-byte
// aligned, of one dtype (0 = float32: alt_kernel; 1 = bfloat16:
// window_tc_kernel); coords (B, H8*W8, 2) float32; out (B, H8*W8,
// L*(2r+1)^2) in the same dtype. Levels beyond L are ignored (their pointers
// may be null). scale = 1/sqrt(C) as float32.
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
    return (int)launch_tc(f2, f1, c, out, B, H8, W8, C, L, radius, scale, nullptr, s);
  if (dtype == 0)
    return (int)launch_alt(f2, static_cast<const float*>(f1), c, static_cast<float*>(out), B, H8,
                           W8, C, L, radius, scale, s);
  return (int)cudaErrorInvalidValue;
}

// As mft_corr_alt (float32: win_kernel; bfloat16: window_tc_kernel), plus
// stats (nullable) int32[2]: counts of the staged and the unstaged
// (tile, level) pairs.
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
    return (int)launch_tc(f2, f1, c, out, B, H8, W8, C, L, radius, scale, st, s);
  if (dtype == 0)
    return (int)launch_win(f2, static_cast<const float*>(f1), c, static_cast<float*>(out), B, H8,
                           W8, C, L, radius, scale, st, s);
  return (int)cudaErrorInvalidValue;
}
