// The staged per-pixel window gather of the correlation pyramid, as device
// code shared by the lookups (corr_gather.cu: K2 mft_corr_lookup, #9
// mft_corr_lookup_mixed, #4 mft_corr_lookup_folded, K6 mft_corr_lookup_q on
// int8 levels, K7 mft_corr_lookup_packed and K8 mft_corr_lookup_packed_i8 on
// the packed volume) and the lookup fused with convc1 (corr_lookup.cu: K1
// mft_corr_lookup_conv and mft_corr_lookup_conv_tc). box_origin and
// box_index also place the union boxes of the lane-major lookup K9
// (corr_volume.cu).
//
// One warp gathers one pixel's window samples: channel k = l*(2r+1)^2 +
// i*(2r+1) + j samples level l of the pixel's own (h_l, w_l) map at
// (x/2^l + i - r, y/2^l + j - r), the FIRST window axis offsets x (the
// reference's transposed order), bilinear with zeros outside the map.
// Where the maps lie is the level table's (Levels): row y of pixel bp's map
// of level l starts at value bp*pixel_l + y*stride_l from the level's base.
// Separate (B, P, h_l, w_l) levels have pixel = h_l*w_l and stride = w_l;
// the packed (B, P, H0, sum w_l) map has pixel = H0*sum w_l and stride =
// sum w_l for every level, and level l's base is the map's plus its column
// offset; a folded (B, P, rows_l, 128) level has pixel = 128*rows_l and
// stride = w_l (a small level's h_l*w_l values fill the first lanes of its
// one row, whatever w_l is).
// - load_rows: the pixel's box of (2r+3)^2 taps per level. Each lane takes
//   box rows (row job % side of level job / side) and reads each with aligned
//   8-byte loads along the map row into registers, issuing only the loads
//   that hold a tap inside the map. The box starts at the first window
//   column's x0 and row's y0 and is one tap wider than the window's 2r+2:
//   floor(c/2^l + k) can be one more than floor(c/2^l) + k when the sum
//   rounds up to an integer.
// - store_rows: the loaded rows into the pixel's boxes in shared memory, taps
//   outside [0, h_l) x [0, w_l) written as zeros, so sampling has no bounds
//   checks. Boxes are float32, or bfloat16 for a bfloat16 volume where
//   shared memory is short (the taps are bfloat16 values: no loss). int8
//   taps are dequantized here, float(q) * scale of (pair, level) in f32, as
//   the plain version's dequant_levels does, into float32 boxes.
// - sample: lane (i, g) samples window column i for the rows of group g: the
//   column's x-position and weights are computed once, each row's once per
//   row, each position as the plain version's own c/2^l + offset (one
//   fraction per level would round differently), and the four taps are
//   weighted and summed in the plain version's order (built with
//   -fmad=false), so every sample equals the plain PyTorch version bit for
//   bit (ops/corr_lookup.py, core/interp.py). Each sample goes to a sink
//   put(k, value) of the caller: a row of an output tile, or the tensor-core
//   operand tile. The levels are unrolled at compile time; a box row's level
//   is read from a table in shared memory, so nothing is indexed in a stack
//   frame.
// Offsets into the volume are 64-bit: level 0 of 7 pairs at 1080x1920 holds
// 7.3e9 values.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 4;
constexpr int kMaxRadius = 4;
constexpr int kChunk = 8;               // bytes per staging load

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

// T: the volume's type; BoxT: the staged boxes' (float, or T for bfloat16).
template <int R, typename T, typename BoxT = float>
struct Geometry {
  static constexpr int n = 2 * R + 1;                        // window side
  static constexpr int nn = n * n;
  static constexpr int side = n + 2;                         // staged box side
  static constexpr int rows = (n + 32 / n - 1) / (32 / n);   // window rows per lane
  static constexpr int groups = (n + rows - 1) / rows;       // lanes per column
  static constexpr int lanes = n * groups;
  // float boxes: a pitch whose sampling reads are free of bank conflicts;
  // bf16 boxes (where shared memory is short): the least even pitch
  static constexpr int pitch =
      sizeof(BoxT) == 4 ? box_pitch(side, n, rows, groups) : side + (side & 1);
  static constexpr int box = side * pitch;                   // BoxT values per staged box
  static constexpr int per_load = kChunk / (int)sizeof(T);   // values per load
  // loads per box row: its side values start anywhere in an aligned chunk
  static constexpr int loads = (side + 2 * (per_load - 1)) / per_load;
  static constexpr int words = 2 * loads;                    // 32-bit words per box row
  static constexpr int slots = (kMaxLevels * side + 31) / 32;  // box rows per lane
  static_assert(sizeof(BoxT) == 4 || sizeof(T) == 2, "bfloat16 boxes hold bfloat16 taps");
  static_assert(sizeof(T) == 1 || sizeof(T) == 2 || sizeof(T) == 4, "int8, bf16 or f32 taps");
};

// One level of the pyramid, in shared memory so that a lane can read the
// level of its box row with one 16-byte load: its (h, w) map, its row stride
// and where pixel 0's map lies. The sizes are 16-bit (make_levels,
// packed_levels and folded_table refuse larger ones): a 2160x3840 frame's
// level 0 is 270x480, its packed rows 900 values.
struct __align__(16) Level {
  long long base;   // byte address of the level's value (0, 0) of pixel 0
  unsigned short h, w, stride, unused;
};

// The level table, an argument of the kernels and a copy in their shared
// memory: row y of pixel bp's map of level l at value bp*pixel[l] +
// y*level[l].stride from level[l].base. The pixel strides sit beside the
// levels, one 4-byte load more per box row: 32 bits cover a product of two
// 16-bit sizes (65,535^2 values), and a Level of 32 bytes would not fit K1's
// tensor-core kernel.
struct __align__(16) Levels {
  Level level[kMaxLevels];
  unsigned pixel[kMaxLevels];
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
template <> __device__ __forceinline__ float word_value<int8_t>(const uint32_t* a, int c) {
  // byte c & 3 of word c >> 2, sign-extended: float(q), exact
  return (float)((int)(a[c >> 2] << (24 - 8 * (c & 3))) >> 24);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float box_value(float v) { return v; }
__device__ __forceinline__ float box_value(__nv_bfloat16 v) { return __bfloat162float(v); }

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
// offset of box column 0 in the first load (bits 16-18) and the row's offset
// in the pixel's boxes, in BoxT values (bits 19-31): store_rows writes zeros
// for every tap the mask leaves out.
template <int R, typename T, typename BoxT = float>
__device__ __forceinline__ void load_rows(
    const Levels& levels, long bp, float cx, float cy, int L, int lane,
    uint32_t (&wd)[Geometry<R, T, BoxT>::slots][Geometry<R, T, BoxT>::words],
    uint32_t (&info)[Geometry<R, T, BoxT>::slots]) {
  using G = Geometry<R, T, BoxT>;
  static_assert(G::side <= 16 && kMaxLevels * G::box < (1 << 13), "info fields");
#pragma unroll
  for (int s = 0; s < G::slots; ++s) {
    const int job = lane + 32 * s;
    if (job < L * G::side) {
      const int l = job / G::side;
      const int by = job - l * G::side;
      const Level lvl = levels.level[l];
      const unsigned pixel = levels.pixel[l];
      const float inv = __int_as_float((127 - l) << 23);   // 2^-l, exact
      const int ox = box_origin(floorf(cx * inv + (float)(-R)), lvl.w, G::side);
      const int oy = box_origin(floorf(cy * inv + (float)(-R)), lvl.h, G::side);
      const int gy = oy + by;
      const int lo = max(0, -ox), hi = min(G::side, lvl.w - ox);   // box columns in the map
      const long long start =
          lvl.base
          + ((long long)bp * pixel + (long long)gy * lvl.stride + ox) * (long long)sizeof(T);
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

// Unpack this lane's loaded box rows into the pixel's boxes, zeros outside
// the map: float32 values, or the bfloat16 taps as they are, two to a word.
// int8 taps (scales: the pixel's pair's L level scales) become float(q) *
// scale.
template <int R, typename T, typename BoxT = float>
__device__ __forceinline__ void store_rows(
    int L, int lane, BoxT* boxes,
    const uint32_t (&wd)[Geometry<R, T, BoxT>::slots][Geometry<R, T, BoxT>::words],
    const uint32_t (&info)[Geometry<R, T, BoxT>::slots],
    const float* __restrict__ scales = nullptr) {
  using G = Geometry<R, T, BoxT>;
#pragma unroll
  for (int s = 0; s < G::slots; ++s) {
    if (lane + 32 * s < L * G::side) {
      const uint32_t keep = info[s] & 0xffffu, sb = (info[s] >> 16) & 7u;
      // shift the row so that word 0 starts at box column 0
      uint32_t a[G::words];
#pragma unroll
      for (int q = 0; q < G::words; ++q)
        a[q] = (sb & 4u) && q + 1 < G::words ? wd[s][q + 1] : wd[s][q];
      if (sizeof(T) < 4) {
        const uint32_t sh = (sizeof(T) == 2 ? sb & 2u : sb & 3u) * 8u;
#pragma unroll
        for (int q = 0; q + 1 < G::words; ++q) a[q] = __funnelshift_r(a[q], a[q + 1], sh);
      }
      // the level's scale for int8 taps (1 otherwise, and not applied)
      const float sc = sizeof(T) == 1 ? __ldg(scales + (lane + 32 * s) / G::side) : 1.0f;
      auto tap = [&](int c) {
        const float v = word_value<T>(a, c);
        return sizeof(T) == 1 ? v * sc : v;
      };
      BoxT* row = boxes + (info[s] >> 19);
      if constexpr (sizeof(BoxT) == 2) {
        // the even pitch keeps every row word-aligned; column side (past
        // the box, when side is odd) is masked to zero
#pragma unroll
        for (int c = 0; c < G::side; c += 2) {
          const uint32_t m = (keep & (1u << c) ? 0x0000ffffu : 0u) |
                             (keep & (2u << c) ? 0xffff0000u : 0u);
          reinterpret_cast<uint32_t*>(row)[c >> 1] = a[c >> 1] & m;
        }
      } else {
#pragma unroll
        for (int c = 0; c < G::side; c += 2) {
          const float v0 = keep & (1u << c) ? tap(c) : 0.0f;
          if (c + 1 < G::side) {
            const float v1 = keep & (2u << c) ? tap(c + 1) : 0.0f;
            *reinterpret_cast<float2*>(row + c) = make_float2(v0, v1);
          } else {
            row[c] = v0;
          }
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

// The window samples of one pixel from its staged boxes, each handed to
// put(k, value): lane (i, g) takes window column i, rows
// [g*rows, (g+1)*rows).
template <int R, typename T, typename BoxT = float, typename Sink>
__device__ __forceinline__ void sample(const BoxT* boxes, float cx, float cy, int L,
                                       int lane, Sink put) {
  using G = Geometry<R, T, BoxT>;
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
      const BoxT* box = boxes + l * G::box;
#pragma unroll
      for (int t = 0; t < G::rows; ++t) {
        const int j = g * G::rows + t;
        if (G::groups * G::rows == G::n || j < G::n) {
          const float y = ay + (float)(j - R);
          const float y0f = floorf(y);
          const float wy = y - y0f;
          const float w0y = 1.0f - wy;
          const int cyi = box_index<R>(y0f - oyf);
          const BoxT* q = box + cyi * G::pitch + cxi;
          float acc = box_value(q[0]) * (w0x * w0y);
          acc = acc + box_value(q[1]) * (wx * w0y);
          acc = acc + box_value(q[G::pitch]) * (w0x * wy);
          acc = acc + box_value(q[G::pitch + 1]) * (wx * wy);
          put(l * G::nn + i * G::n + j, acc);
        }
      }
    }
  }
}

// The level table in shared memory, written by thread 0.
__device__ __forceinline__ void fill_levels(Levels& levels, const Levels& lv) {
  if (threadIdx.x == 0) levels = lv;
}

inline bool fits_16_bits(long v) { return v >= 0 && v <= 0xffff; }

// Separate (B, P, h_l, w_l) levels, (h_l, w_l) given for 4 levels. false if
// a size exceeds 16 bits.
inline bool make_levels(const void* l0, const void* l1, const void* l2, const void* l3,
                        const int* hw, Levels& lv) {
  const void* base[kMaxLevels] = {l0, l1, l2, l3};
  for (int l = 0; l < kMaxLevels; ++l) {
    const int h = hw[2 * l], w = hw[2 * l + 1];
    if (!fits_16_bits(h) || !fits_16_bits(w)) return false;
    lv.level[l] = Level{(long long)reinterpret_cast<uintptr_t>(base[l]), (unsigned short)h,
                        (unsigned short)w, (unsigned short)w, 0};
    lv.pixel[l] = (unsigned)h * (unsigned)w;
  }
  return true;
}

// The packed (B, P, H0, Wp) map of values of `itemsize` bytes, level l in
// rows [0, h_l) and columns [off_l, off_l + w_l), off_l = sum_{m<l} w_m.
// false if a level does not fit the map or a size exceeds 16 bits.
inline bool packed_levels(const void* packed, int itemsize, int H0, int Wp, const int* hw,
                          int num_levels, Levels& lv) {
  if (!fits_16_bits(H0) || !fits_16_bits(Wp)) return false;
  lv = Levels{};
  long off = 0;
  for (int l = 0; l < num_levels; ++l) {
    const int h = hw[2 * l], w = hw[2 * l + 1];
    if (h < 0 || h > H0 || w < 0 || off + w > Wp) return false;
    lv.level[l] = Level{(long long)reinterpret_cast<uintptr_t>(packed) + off * itemsize,
                        (unsigned short)h, (unsigned short)w, (unsigned short)Wp, 0};
    lv.pixel[l] = (unsigned)H0 * (unsigned)Wp;
    off += w;
  }
  return true;
}

// Folded (B, P, rows_l, 128) levels, value (y, x) of level l at lane offset
// y*w_l + x of the pixel's rows_l*128 values: a level whose rows hold whole
// image rows (fold*w = 128) or a small one (h_l*w_l < 128 values in one
// zero-padded row). false if a level's h_l*w_l values exceed its rows or a
// size exceeds 16 bits (the pixel stride, 32).
inline bool folded_table(const void* l0, const void* l1, const void* l2, const void* l3,
                          const int* hw, const int* rows, int num_levels, Levels& lv) {
  const void* base[kMaxLevels] = {l0, l1, l2, l3};
  lv = Levels{};
  for (int l = 0; l < num_levels; ++l) {
    const int h = hw[2 * l], w = hw[2 * l + 1];
    const long pixel = (long)rows[l] * 128;
    if (!fits_16_bits(h) || !fits_16_bits(w) || rows[l] < 1 || pixel > 0xffffffffL
        || (long)h * w > pixel)
      return false;
    lv.level[l] = Level{(long long)reinterpret_cast<uintptr_t>(base[l]), (unsigned short)h,
                        (unsigned short)w, (unsigned short)w, 0};
    lv.pixel[l] = (unsigned)pixel;
  }
  return true;
}

}  // namespace
