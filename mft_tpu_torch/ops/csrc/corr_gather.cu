// Dense correlation-pyramid window lookup for Hopper (sm_90a): one staged
// per-pixel gather behind six entry points.
//
// mft_corr_lookup            replaces mft_tpu/ops/corr_lookup_pallas.py
//                            corr_lookup_pallas (_kernel_pixel_major):
//                            separate (B, P, h_l, w_l) levels.
// mft_corr_lookup_mixed      replaces corr_lookup_pallas_mixed (_kernel_mixed):
//                            folded big levels, then plain (B, P, h_l, w_l)
//                            ones. A folded level with fold*w = 128 holds each
//                            pixel's dense h_l x w_l map (value (y, x) is
//                            element y*w + x), so the wrapper passes its dense
//                            view and both entry points read the same layout.
// mft_corr_lookup_folded     replaces corr_lookup_pallas_folded (_kernel_folded):
//                            every level folded, (B, P, rows_l, 128), lane
//                            u*w + x of row q holding image row q*fold + u; a
//                            level of fewer than 128 values fills the first
//                            h_l*w_l lanes of its one zero-padded row, whatever
//                            w_l is. The level table (corr_gather.cuh
//                            folded_table) gives each level a pixel stride of
//                            rows_l*128 values and a row stride of w_l; the
//                            padding lanes hold no tap of the map and are never
//                            sampled.
// mft_corr_lookup_q          replaces corr_lookup_pallas_q (_kernel_pixel_major_q):
//                            int8 (B, P, h_l, w_l) levels, value = q * scale[b, l],
//                            dequantized as the boxes are staged (corr_gather.cuh
//                            store_rows); it writes bfloat16.
// mft_corr_lookup_packed     replaces corr_lookup_pallas_packed (_kernel_packed):
//                            all levels side by side in one (B, P, H0, sum w_l)
//                            map per pixel, level l in columns [off_l, off_l +
//                            w_l) and rows [0, h_l), zeros below. The level
//                            table (corr_gather.cuh packed_levels) gives each
//                            level the map's rows and row stride and its column
//                            offset; a tap outside the level's own h_l x w_l
//                            map is zero, never a neighbouring level's value.
// mft_corr_lookup_packed_i8  replaces corr_lookup_pallas_packed_i8: that map in
//                            int8, dequantized as mft_corr_lookup_q's levels.
//
// Each writes, per pixel, a bilinear zero-padded (2r+1)^2 window from each
// level of its own correlation map: channel k = l*(2r+1)^2 + i*(2r+1) + j
// samples at (x/2^l + i - r, y/2^l + j - r), the FIRST window axis offsets x
// (the reference's transposed order), out (B, P, L*(2r+1)^2) in the volume
// dtype (float32 or bfloat16; bfloat16 for int8 levels).
//
// What bounds it on this card: bytes. At 512x512 with 7 pairs the windows
// touch about 23 MB of bf16 taps and write 18.6 MB of samples, a bound of
// ~9 us at 3.35 TB/s. Each pixel owns its maps, so no tap is shared between
// pixels; a box row of 11 bf16 taps spans one or two 32-byte sectors, which
// puts the sectors actually read at about twice the compulsory tap bytes.
// int8 levels halve the taps' bytes, not the output's.
//
// What the design does about it (a warp per pixel, kPix pixels a block):
// - The pixel's box of (2r+3)^2 taps per level is staged in shared memory as
//   float32 (int8 taps dequantized on the way) and sampled from there in
//   the plain version's operation order
//   (the staging and sampling device code is corr_gather.cuh, shared with
//   the fused lookup K1 in corr_lookup.cu), so every sample equals the plain
//   PyTorch version bit for bit. A packed level's box rows lie sum w_l
//   values apart and start at any byte, as separate levels' rows of odd
//   widths do: the staging reads aligned 8-byte chunks and shifts them.
// - The samples go to a shared tile in the output dtype. The warps of the
//   pixels whose outputs together start and end 16-byte aligned (2 pixels in
//   bf16 with 4 levels, 1 in f32) meet at a barrier of their own and write
//   that stretch with 16-byte stores (a ragged tail element by element); no
//   barrier spans the block.
// - Blocks are persistent, as many as fit on the card at once; each warp
//   issues the next pixel's loads (with coordinates read an iteration
//   earlier) before it samples the current one, so the loads' latency hides
//   behind the sampling.

#include "corr_gather.cuh"

namespace {

constexpr int kPix = 8;                 // pixels (warps) per block
constexpr int kThreads = 32 * kPix;

// Persistent blocks: block b takes pixel groups b, b + gridDim.x, ... of kPix
// pixels, a warp each; each warp issues the next group's loads (with
// coordinates loaded an iteration earlier) before it samples the current one.
// Two blocks an SM (at most 128 registers) measured faster on the H100 than
// one (f32 took 130 registers) and than three (80 registers, f32 spilled).
// T: the volume's type, O: the output's (T, or bfloat16 for int8 levels,
// whose (B, L) scales and pixels per pair P are given).
template <int R, typename T, typename O = T>
__global__ void __launch_bounds__(kThreads, 2)
corr_gather_kernel(Levels lv, const float* __restrict__ coords, O* __restrict__ out,
                   long BP, int L, const float* __restrict__ scales, int P) {
  using G = Geometry<R, T>;
  constexpr int kTile = kPix * kMaxLevels * G::nn;
  __shared__ __align__(16) float boxes[kPix][kMaxLevels * G::box];
  __shared__ __align__(16) unsigned char tile_bytes[2][kTile * sizeof(O)];
  __shared__ Levels levels;
  fill_levels(levels, lv);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long groups = (BP + kPix - 1) / kPix;
  const int C = L * G::nn;
  // pixels whose outputs together start and end 16-byte aligned: 1, 2, 4 or 8
  const int bytes = C * (int)sizeof(O);
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
    if (mine) {
      if constexpr (sizeof(T) == 1) {   // the scales of the pixel's pair
        const int b = (int)(p0 + warp) / P;
        store_rows<R, T>(L, lane, boxes[warp], wd, info, scales + b * L);
      } else {
        store_rows<R, T>(L, lane, boxes[warp], wd, info);
      }
    }
    const long next = grp + gridDim.x;
    float fx = 0.0f, fy = 0.0f;
    pixel_coords(next + gridDim.x, fx, fy);
    if (next < groups && next * kPix + warp < BP)
      load_rows<R, T>(levels, next * kPix + warp, nx, ny, L, lane, wd, info);
    __syncwarp();
    O* tile = reinterpret_cast<O*>(tile_bytes[buf]);
    O* samples = tile + warp * C;
    if (mine)
      sample<R, T>(boxes[warp], cx, cy, L, lane,
                   [&](int k, float v) { samples[k] = from_f32<O>(v); });

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
      O* dst = out + (p0 + first) * C;
      const O* src = tile + first * C;
      const int vecs = values * (int)sizeof(O) / 16;
      for (int v = t; v < vecs; v += 32 * span)
        reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(src)[v];
      for (int e = vecs * (16 / (int)sizeof(O)) + t; e < values; e += 32 * span)
        dst[e] = src[e];
    }
    cx = nx; cy = ny; nx = fx; ny = fy;
  }
}

template <int R, typename T, typename O>
cudaError_t launch(const Levels& lv, const float* coords, const float* scales, int P,
                   void* out, long BP, int L, cudaStream_t stream) {
  static int per_sm = 0;   // resident blocks per SM, from the occupancy calculator
  if (per_sm == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, corr_gather_kernel<R, T, O>, kThreads, 0);
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
  corr_gather_kernel<R, T, O><<<(unsigned)blocks, kThreads, 0, stream>>>(
      lv, coords, static_cast<O*>(out), BP, L, scales, P);
  return cudaGetLastError();
}

template <typename T, typename O = T>
cudaError_t launch_radius(const Levels& lv, const float* coords, const float* scales, int P,
                          void* out, long BP, int L, int radius, cudaStream_t stream) {
  switch (radius) {
    case 1: return launch<1, T, O>(lv, coords, scales, P, out, BP, L, stream);
    case 2: return launch<2, T, O>(lv, coords, scales, P, out, BP, L, stream);
    case 3: return launch<3, T, O>(lv, coords, scales, P, out, BP, L, stream);
    case 4: return launch<4, T, O>(lv, coords, scales, P, out, BP, L, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype 0 float32, 1 bfloat16, 2 int8 (with its (B, L) scales and P pixels a
// pair; out in bfloat16)
int gather(void* out, const void* coords, const Levels& lv, int num_levels, long BP,
           int radius, int dtype, void* stream, const void* scales = nullptr, int P = 1) {
  if (num_levels < 1 || num_levels > kMaxLevels || radius < 1 || radius > kMaxRadius
      || (reinterpret_cast<uintptr_t>(out) & 15) != 0 || (dtype == 2 && scales == nullptr))
    return (int)cudaErrorInvalidValue;
  if (BP <= 0) return (int)cudaSuccess;   // no pixels: nothing to write
  const float* c = static_cast<const float*>(coords);
  const float* sc = static_cast<const float*>(scales);
  const int L = num_levels;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 2)
    return (int)launch_radius<int8_t, __nv_bfloat16>(lv, c, sc, P, out, BP, L, radius, s);
  if (dtype == 1)
    return (int)launch_radius<__nv_bfloat16>(lv, c, sc, P, out, BP, L, radius, s);
  if (dtype == 0) return (int)launch_radius<float>(lv, c, sc, P, out, BP, L, radius, s);
  return (int)cudaErrorInvalidValue;
}

// Separate levels: (h_l, w_l) given for 4 levels, pointers beyond
// num_levels ignored.
int gather_levels(void* out, const void* coords, const void* l0, const void* l1,
                  const void* l2, const void* l3, const int* hw, int num_levels, long BP,
                  int radius, int dtype, void* stream, const void* scales = nullptr,
                  int P = 1) {
  Levels lv;
  if (!make_levels(l0, l1, l2, l3, hw, lv)) return (int)cudaErrorInvalidValue;
  return gather(out, coords, lv, num_levels, BP, radius, dtype, stream, scales, P);
}

// Folded (B, P, rows_l, 128) levels: (h_l, w_l) and rows_l given for 4
// levels, pointers beyond num_levels ignored.
int gather_folded(void* out, const void* coords, const void* l0, const void* l1,
                  const void* l2, const void* l3, const int* hw, const int* rows,
                  int num_levels, long BP, int radius, int dtype, void* stream) {
  Levels lv;
  if (num_levels < 1 || num_levels > kMaxLevels || dtype < 0 || dtype > 1
      || !folded_table(l0, l1, l2, l3, hw, rows, num_levels, lv))
    return (int)cudaErrorInvalidValue;
  return gather(out, coords, lv, num_levels, BP, radius, dtype, stream);
}

// The packed (B, P, H0, Wp) map.
int gather_packed(void* out, const void* coords, const void* packed, int H0, int Wp,
                  const int* hw, int num_levels, int B, int P, int radius, int dtype,
                  void* stream, const void* scales = nullptr) {
  constexpr int kItemsize[3] = {4, 2, 1};   // by dtype
  Levels lv;
  if (dtype < 0 || dtype > 2 || num_levels < 1 || num_levels > kMaxLevels
      || !packed_levels(packed, kItemsize[dtype], H0, Wp, hw, num_levels, lv))
    return (int)cudaErrorInvalidValue;
  return gather(out, coords, lv, num_levels, (long)B * P, radius, dtype, stream, scales, P);
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
  return gather_levels(out, coords, l0, l1, l2, l3, hw, num_levels, BP, radius, dtype,
                       stream);
}

// Levels in their order in the pyramid: the folded ones (fold*w = 128) as
// their dense (B, P, h_l, w_l) views, then the plain ones.
extern "C" int mft_corr_lookup_mixed(void* out, const void* coords, const void* l0,
                                     const void* l1, const void* l2, const void* l3,
                                     int h0, int w0, int h1, int w1, int h2, int w2,
                                     int h3, int w3, int num_levels, int B, int P,
                                     int radius, int dtype, void* stream) {
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  return gather_levels(out, coords, l0, l1, l2, l3, hw, num_levels, (long)B * P, radius,
                       dtype, stream);
}

// Folded (B, P, rows_l, 128) levels, value (y, x) at lane offset y*w_l + x;
// dtype: 0 = float32, 1 = bfloat16; radius 1..4. (h_l, w_l) and rows_l are
// given for 4 levels, those beyond num_levels ignored. out must be 16-byte
// aligned.
extern "C" int mft_corr_lookup_folded(void* out, const void* coords, const void* l0,
                                      const void* l1, const void* l2, const void* l3,
                                      int h0, int w0, int h1, int w1, int h2, int w2,
                                      int h3, int w3, int r0, int r1, int r2, int r3,
                                      int num_levels, int B, int P, int radius, int dtype,
                                      void* stream) {
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const int rows[kMaxLevels] = {r0, r1, r2, r3};
  return gather_folded(out, coords, l0, l1, l2, l3, hw, rows, num_levels, (long)B * P, radius,
                       dtype, stream);
}

// int8 levels with their (B, L) float32 scales, value = q * scale[b, l];
// bfloat16 samples; radius 1..4. out must be 16-byte aligned.
extern "C" int mft_corr_lookup_q(void* out, const void* coords, const void* scales,
                                 const void* l0, const void* l1, const void* l2,
                                 const void* l3, int h0, int w0, int h1, int w1, int h2,
                                 int w2, int h3, int w3, int num_levels, int B, int P,
                                 int radius, void* stream) {
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  return gather_levels(out, coords, l0, l1, l2, l3, hw, num_levels, (long)B * P, radius, 2,
                       stream, scales, P);
}

// The packed (B, P, H0, Wp) map, Wp = sum w_l; dtype: 0 = float32,
// 1 = bfloat16; radius 1..4. (h_l, w_l) are given for 4 levels, those beyond
// num_levels ignored. out must be 16-byte aligned.
extern "C" int mft_corr_lookup_packed(void* out, const void* coords, const void* packed,
                                      int H0, int Wp, int h0, int w0, int h1, int w1,
                                      int h2, int w2, int h3, int w3, int num_levels,
                                      int B, int P, int radius, int dtype, void* stream) {
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  return gather_packed(out, coords, packed, H0, Wp, hw, num_levels, B, P, radius, dtype,
                       stream);
}

// That map in int8 with its (B, L) float32 scales, value = q * scale[b, l];
// bfloat16 samples; radius 1..4. out must be 16-byte aligned.
extern "C" int mft_corr_lookup_packed_i8(void* out, const void* coords, const void* scales,
                                         const void* packed, int H0, int Wp, int h0,
                                         int w0, int h1, int w1, int h2, int w2, int h3,
                                         int w3, int num_levels, int B, int P,
                                         int radius, void* stream) {
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  return gather_packed(out, coords, packed, H0, Wp, hw, num_levels, B, P, radius, 2, stream,
                       scales);
}
