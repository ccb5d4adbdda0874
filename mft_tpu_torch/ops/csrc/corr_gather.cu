// Dense correlation-pyramid window lookup for Hopper (sm_90a): one staged
// per-pixel gather behind two entry points.
//
// mft_corr_lookup        replaces mft_tpu/ops/corr_lookup_pallas.py
//                        corr_lookup_pallas (_kernel_pixel_major): separate
//                        (B, P, h_l, w_l) levels.
// mft_corr_lookup_mixed  replaces corr_lookup_pallas_mixed (_kernel_mixed):
//                        folded big levels, then plain (B, P, h_l, w_l) ones.
//                        A folded level with fold*w = 128 holds each pixel's
//                        dense h_l x w_l map (value (y, x) is element y*w + x),
//                        so the wrapper passes its dense view and both entry
//                        points read the same layout.
//
// Both write, per pixel, a bilinear zero-padded (2r+1)^2 window from each
// level of its own correlation map: channel k = l*(2r+1)^2 + i*(2r+1) + j
// samples at (x/2^l + i - r, y/2^l + j - r), the FIRST window axis offsets x
// (the reference's transposed order), out (B, P, L*(2r+1)^2) in the volume
// dtype (float32 or bfloat16).
//
// What bounds it on this card: bytes. At 512x512 with 7 pairs the windows
// touch about 23 MB of bf16 taps and write 18.6 MB of samples, a bound of
// ~9 us at 3.35 TB/s. Each pixel owns its maps, so no tap is shared between
// pixels; a box row of 11 bf16 taps spans one or two 32-byte sectors, which
// puts the sectors actually read at about twice the compulsory tap bytes.
//
// What the design does about it (a warp per pixel, kPix pixels a block):
// - The pixel's box of (2r+3)^2 taps per level is staged in shared memory as
//   float32. Each lane takes box rows (row job % side of level job / side)
//   and reads each with aligned 8-byte loads along the map row, issuing only
//   the loads that hold a tap inside the map; taps outside [0, h_l) x
//   [0, w_l) are written as zeros, so sampling has no bounds checks. The box
//   starts at the first window column's x0 and row's y0 and is one tap wider
//   than the window's 2r+2: floor(c/2^l + k) can be one more than
//   floor(c/2^l) + k when the sum rounds up to an integer.
// - Lane (i, g) samples window column i for the rows of group g: the
//   column's x-position and weights are computed once, each row's once per
//   row, each position as the plain version's own c/2^l + offset (one
//   fraction per level would round differently), and the four taps are
//   weighted and summed in the plain version's order (built with
//   -fmad=false), so every sample equals the plain PyTorch version bit for
//   bit (ops/corr_lookup.py, core/interp.py). The levels are unrolled at
//   compile time; a box row's level is read from a table in shared memory,
//   so nothing is indexed in a stack frame.
// - The samples go to a shared tile in the output dtype. The warps of the
//   pixels whose outputs together start and end 16-byte aligned (2 pixels in
//   bf16 with 4 levels, 1 in f32) meet at a barrier of their own and write
//   that stretch with 16-byte stores (a ragged tail element by element); no
//   barrier spans the block.
// - Blocks are persistent, as many as fit on the card at once; each warp
//   issues the next pixel's loads (with coordinates read an iteration
//   earlier) before it samples the current one, so the loads' latency hides
//   behind the sampling.
// Offsets into the volume are 64-bit: level 0 of 7 pairs at 1080x1920 holds
// 7.3e9 values.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kPix = 8;                 // pixels (warps) per block
constexpr int kThreads = 32 * kPix;
constexpr int kChunk = 8;               // bytes per staging load

struct Levels {
  const void* base[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Lanes (i, g), i < n, g < groups, read box row g*rows + t and column i + c:
// is every bank of one such read distinct across the lanes?
constexpr bool distinct_banks(int pitch, int n, int rows, int groups) {
  for (int a = 0; a < groups; ++a)
    for (int b = a + 1; b < groups; ++b)
      for (int i = 0; i < n; ++i)
        for (int k = 0; k < n; ++k)
          if ((a * rows * pitch + i) % 32 == (b * rows * pitch + k) % 32) return false;
  return true;
}

// The first pitch from `side` up, even (rows hold float2 pairs), whose reads
// by the sampling lanes fall in distinct banks.
constexpr int box_pitch(int side, int n, int rows, int groups) {
  for (int p = side + (side & 1); p < side + 64; p += 2)
    if (distinct_banks(p, n, rows, groups)) return p;
  return side + (side & 1);
}

template <int R, typename T>
struct Geometry {
  static constexpr int n = 2 * R + 1;                        // window side
  static constexpr int nn = n * n;
  static constexpr int side = n + 2;                         // staged box side
  static constexpr int rows = (n + 32 / n - 1) / (32 / n);   // window rows per lane
  static constexpr int groups = (n + rows - 1) / rows;       // lanes per column
  static constexpr int lanes = n * groups;
  static constexpr int pitch = box_pitch(side, n, rows, groups);
  static constexpr int box = side * pitch;                   // floats per staged box
  static constexpr int per_load = kChunk / (int)sizeof(T);   // values per load
  // loads per box row: its side values start anywhere in an aligned chunk
  static constexpr int loads = (side + 2 * (per_load - 1)) / per_load;
  static constexpr int words = 2 * loads;                    // 32-bit words per box row
  static constexpr int slots = (kMaxLevels * side + 31) / 32;  // box rows per lane
};

// One level of the pyramid, in shared memory so that a lane can read the
// level of its box row with one load.
struct __align__(16) Level {
  long long base;   // byte address of the level
  int h, w;
};

template <typename T> __device__ __forceinline__ float word_value(const uint32_t* a, int c);
template <> __device__ __forceinline__ float word_value<float>(const uint32_t* a, int c) {
  return __uint_as_float(a[c]);
}
template <> __device__ __forceinline__ float word_value<__nv_bfloat16>(const uint32_t* a,
                                                                       int c) {
  const uint32_t word = a[c >> 1];   // little-endian: value c is half c & 1
  return __uint_as_float((c & 1) ? (word & 0xffff0000u) : (word << 16));
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// A box origin that keeps the box outside the map whenever it lies outside
// (coordinates of any size, NaN too); in range it is the exact floor.
__device__ __forceinline__ int box_origin(float o, int extent, int side) {
  return (int)fminf(fmaxf(o, (float)(-side)), (float)extent);
}

// Issue the aligned 8-byte loads of this lane's box rows of pixel bp (level-0
// coordinates cx, cy): box row `job` is row job % side of level job / side.
// Loads that hold no tap inside the map are not issued, nor are rows outside
// it; their words keep whatever they held. info packs, per row, the mask of
// box columns inside the map (bits 0-15; 0 for a row outside it), the byte
// offset of box column 0 in the first load (bits 16-18) and the row's float
// offset in the pixel's boxes (bits 19-31): store_rows writes zeros for every
// tap the mask leaves out.
template <int R, typename T>
__device__ __forceinline__ void load_rows(const Level* levels, long bp, float cx, float cy,
                                          int L, int lane,
                                          uint32_t (&wd)[Geometry<R, T>::slots][Geometry<R, T>::words],
                                          uint32_t (&info)[Geometry<R, T>::slots]) {
  using G = Geometry<R, T>;
  static_assert(G::side <= 16 && kMaxLevels * G::box < (1 << 13), "info fields");
#pragma unroll
  for (int s = 0; s < G::slots; ++s) {
    const int job = lane + 32 * s;
    if (job < L * G::side) {
      const int l = job / G::side;
      const int by = job - l * G::side;
      const Level lvl = levels[l];
      const float inv = __int_as_float((127 - l) << 23);   // 2^-l, exact
      const int ox = box_origin(floorf(cx * inv + (float)(-R)), lvl.w, G::side);
      const int oy = box_origin(floorf(cy * inv + (float)(-R)), lvl.h, G::side);
      const int gy = oy + by;
      const int lo = max(0, -ox), hi = min(G::side, lvl.w - ox);   // box columns in the map
      const long long start =
          lvl.base + (((long long)bp * lvl.h + gy) * lvl.w + ox) * (long long)sizeof(T);
      const int sb = (int)start & (kChunk - 1);
      const bool row_in = gy >= 0 && gy < lvl.h;
      info[s] = (row_in ? ((1u << hi) - 1u) & ~((1u << lo) - 1u) : 0u) | (uint32_t)sb << 16
                | (uint32_t)(l * G::box + by * G::pitch) << 19;
      if (row_in && lo < hi) {
        // load k holds bytes [8k, 8k + 8) of the row from start - sb; the
        // map's columns are bytes [lo, hi) * sizeof(T) + sb
        const int first = lo * (int)sizeof(T) + sb - kChunk, last = hi * (int)sizeof(T) + sb;
        const uint2* a0 = reinterpret_cast<const uint2*>(start - sb);
#pragma unroll
        for (int k = 0; k < G::loads; ++k) {
          if (kChunk * k > first && kChunk * k < last) {
            const uint2 v = __ldg(a0 + k);
            wd[s][2 * k] = v.x;
            wd[s][2 * k + 1] = v.y;
          }
        }
      }
    }
  }
}

// Unpack this lane's loaded box rows into the pixel's boxes: float32, zeros
// outside the map.
template <int R, typename T>
__device__ __forceinline__ void store_rows(int L, int lane, float* boxes,
                                           const uint32_t (&wd)[Geometry<R, T>::slots][Geometry<R, T>::words],
                                           const uint32_t (&info)[Geometry<R, T>::slots]) {
  using G = Geometry<R, T>;
#pragma unroll
  for (int s = 0; s < G::slots; ++s) {
    if (lane + 32 * s < L * G::side) {
      const uint32_t keep = info[s] & 0xffffu, sb = (info[s] >> 16) & 7u;
      // shift the row so that word 0 starts at box column 0
      uint32_t a[G::words];
#pragma unroll
      for (int q = 0; q < G::words; ++q)
        a[q] = (sb & 4u) && q + 1 < G::words ? wd[s][q + 1] : wd[s][q];
      if (sizeof(T) == 2) {
        const uint32_t sh = (sb & 2u) * 8u;
#pragma unroll
        for (int q = 0; q + 1 < G::words; ++q) a[q] = __funnelshift_r(a[q], a[q + 1], sh);
      }
      float* row = boxes + (info[s] >> 19);
#pragma unroll
      for (int c = 0; c < G::side; c += 2) {
        const float v0 = keep & (1u << c) ? word_value<T>(a, c) : 0.0f;
        if (c + 1 < G::side) {
          const float v1 = keep & (2u << c) ? word_value<T>(a, c + 1) : 0.0f;
          *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
        } else {
          row[c] = v0;
        }
      }
    }
  }
}

// x0 - ox (or y0 - oy) as a box index: in [0, 2r+1] for every finite
// coordinate whose box meets the map; clamped otherwise (negative values and
// NaN included), where the box holds only zeros.
template <int R>
__device__ __forceinline__ int box_index(float d) {
  return (int)min((unsigned)(int)d, (unsigned)(2 * R + 1));
}

// The window samples of one pixel from its staged boxes into `dst` (its row
// of the output tile): lane (i, g) takes window column i, rows
// [g*rows, (g+1)*rows).
template <int R, typename T>
__device__ __forceinline__ void sample(const float* boxes, float cx, float cy, int L,
                                       int lane, T* dst) {
  using G = Geometry<R, T>;
  if (lane >= G::lanes) return;
  const int i = lane % G::n;
  const int g = lane / G::n;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < L) {
      const float inv = 1.0f / (float)(1 << l);   // a power of two: exact
      const float ax = cx * inv, ay = cy * inv;
      const float oxf = floorf(ax + (float)(-R));
      const float oyf = floorf(ay + (float)(-R));
      const float x = ax + (float)(i - R);
      const float x0f = floorf(x);
      const float wx = x - x0f;
      const float w0x = 1.0f - wx;
      const int cxi = box_index<R>(x0f - oxf);
      const float* box = boxes + l * G::box;
#pragma unroll
      for (int t = 0; t < G::rows; ++t) {
        const int j = g * G::rows + t;
        if (G::groups * G::rows == G::n || j < G::n) {
          const float y = ay + (float)(j - R);
          const float y0f = floorf(y);
          const float wy = y - y0f;
          const float w0y = 1.0f - wy;
          const int cyi = box_index<R>(y0f - oyf);
          const float* q = box + cyi * G::pitch + cxi;
          float acc = q[0] * (w0x * w0y);
          acc = acc + q[1] * (wx * w0y);
          acc = acc + q[G::pitch] * (w0x * wy);
          acc = acc + q[G::pitch + 1] * (wx * wy);
          dst[l * G::nn + i * G::n + j] = from_f32<T>(acc);
        }
      }
    }
  }
}

// Persistent blocks: block b takes pixel groups b, b + gridDim.x, ... of kPix
// pixels, a warp each; each warp issues the next group's loads (with
// coordinates loaded an iteration earlier) before it samples the current one.
// Two blocks an SM (at most 128 registers) measured faster on the H100 than
// one (f32 took 130 registers) and than three (80 registers, f32 spilled).
template <int R, typename T>
__global__ void __launch_bounds__(kThreads, 2)
corr_gather_kernel(Levels lv, const float* __restrict__ coords, T* __restrict__ out,
                   long BP, int L) {
  using G = Geometry<R, T>;
  constexpr int kTile = kPix * kMaxLevels * G::nn;
  __shared__ __align__(16) float boxes[kPix][kMaxLevels * G::box];
  __shared__ __align__(16) unsigned char tile_bytes[2][kTile * sizeof(T)];
  __shared__ Level levels[kMaxLevels];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l)
      levels[l] = Level{(long long)reinterpret_cast<uintptr_t>(lv.base[l]), lv.h[l], lv.w[l]};
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long groups = (BP + kPix - 1) / kPix;
  const int C = L * G::nn;
  // pixels whose outputs together start and end 16-byte aligned: 1, 2, 4 or 8
  const int bytes = C * (int)sizeof(T);
  const int span = (bytes & 15) ? 16 / (bytes & -bytes) : 1;
  auto pixel_coords = [&](long grp, float& cx, float& cy) {
    const long bp = grp * kPix + warp;
    if (grp < groups && bp < BP) {
      cx = __ldg(coords + 2 * bp);
      cy = __ldg(coords + 2 * bp + 1);
    }
  };

  uint32_t wd[G::slots][G::words] = {};
  uint32_t info[G::slots];
  float cx = 0.0f, cy = 0.0f, nx = 0.0f, ny = 0.0f;
  long grp = blockIdx.x;
  pixel_coords(grp, cx, cy);
  if (grp * kPix + warp < BP) load_rows<R, T>(levels, grp * kPix + warp, cx, cy, L, lane, wd, info);
  pixel_coords(grp + gridDim.x, nx, ny);
  for (int buf = 0; grp < groups; grp += gridDim.x, buf ^= 1) {
    const long p0 = grp * kPix;
    const int np = BP - p0 < kPix ? (int)(BP - p0) : kPix;
    const bool mine = warp < np;
    if (mine) store_rows<R, T>(L, lane, boxes[warp], wd, info);
    const long next = grp + gridDim.x;
    float fx = 0.0f, fy = 0.0f;
    pixel_coords(next + gridDim.x, fx, fy);
    if (next < groups && next * kPix + warp < BP)
      load_rows<R, T>(levels, next * kPix + warp, nx, ny, L, lane, wd, info);
    __syncwarp();
    T* tile = reinterpret_cast<T*>(tile_bytes[buf]);
    if (mine) sample<R, T>(boxes[warp], cx, cy, L, lane, tile + warp * C);

    // the `span` consecutive pixels from `first` are one 16-byte aligned
    // stretch of the output: their warps meet at a barrier of their own and
    // write it with 16-byte stores
    const int first = warp / span * span;
    if (span == 1) {
      __syncwarp();
    } else {
      asm volatile("bar.sync %0, %1;" ::"r"(1 + warp / span), "r"(32 * span) : "memory");
    }
    const int count = min(span, np - first);
    if (count > 0) {
      const int values = count * C;
      const int t = threadIdx.x - 32 * first;
      T* dst = out + (p0 + first) * C;
      const T* src = tile + first * C;
      const int vecs = values * (int)sizeof(T) / 16;
      for (int v = t; v < vecs; v += 32 * span)
        reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
      for (int e = vecs * (16 / (int)sizeof(T)) + t; e < values; e += 32 * span)
        dst[e] = src[e];
    }
    cx = nx; cy = ny; nx = fx; ny = fy;
  }
}

template <int R, typename T>
cudaError_t launch(const Levels& lv, const float* coords, void* out, long BP, int L,
                   cudaStream_t stream) {
  static int per_sm = 0;   // resident blocks per SM, from the occupancy calculator
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, corr_gather_kernel<R, T>, kThreads, 0);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // as many blocks as fit at once, each taking the same number of groups
  const long groups = (BP + kPix - 1) / kPix;
  const long slots = (long)sms * (per_sm > 0 ? per_sm : 1);
  const long rounds = (groups + slots - 1) / slots;
  const long blocks = (groups + rounds - 1) / rounds;
  corr_gather_kernel<R, T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      lv, coords, static_cast<T*>(out), BP, L);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_radius(const Levels& lv, const float* coords, void* out, long BP, int L,
                          int radius, cudaStream_t stream) {
  switch (radius) {
    case 1: return launch<1, T>(lv, coords, out, BP, L, stream);
    case 2: return launch<2, T>(lv, coords, out, BP, L, stream);
    case 3: return launch<3, T>(lv, coords, out, BP, L, stream);
    case 4: return launch<4, T>(lv, coords, out, BP, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

int gather(void* out, const void* coords, const void* l0, const void* l1, const void* l2,
           const void* l3, const int* hw, int num_levels, long BP, int radius, int dtype,
           void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 1 || radius > kMaxRadius
      || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (BP <= 0) return (int)cudaSuccess;   // no pixels: nothing to write
  Levels lv = {};
  const void* base[kMaxLevels] = {l0, l1, l2, l3};
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.base[l] = base[l];
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
  }
  const float* c = static_cast<const float*>(coords);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_radius<__nv_bfloat16>(lv, c, out, BP, num_levels, radius, s);
  if (dtype == 0) return (int)launch_radius<float>(lv, c, out, BP, num_levels, radius, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; radius 1..4. Levels beyond num_levels are
// ignored (their pointers may be null); (h_l, w_l) are given for 4 levels.
// out must be 16-byte aligned.
extern "C" int mft_corr_lookup(void* out, const void* coords, const void* l0,
                               const void* l1, const void* l2, const void* l3,
                               int h0, int w0, int h1, int w1, int h2, int w2,
                               int h3, int w3, int num_levels, long BP, int radius,
                               int dtype, void* stream) {
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  return gather(out, coords, l0, l1, l2, l3, hw, num_levels, BP, radius, dtype, stream);
}

// Levels in their order in the pyramid: the folded ones (fold*w = 128) as
// their dense (B, P, h_l, w_l) views, then the plain ones.
extern "C" int mft_corr_lookup_mixed(void* out, const void* coords, const void* l0,
                                     const void* l1, const void* l2, const void* l3,
                                     int h0, int w0, int h1, int w1, int h2, int w2,
                                     int h3, int w3, int num_levels, int B, int P,
                                     int radius, int dtype, void* stream) {
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  return gather(out, coords, l0, l1, l2, l3, hw, num_levels, (long)B * P, radius, dtype,
                stream);
}
