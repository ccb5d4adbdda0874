// Window lookup on the lane-major form of the RAFT correlation volume, for
// Hopper (sm_90a).
//
// mft_corr_lookup_t          replaces mft_tpu/ops/corr_lookup_pallas.py
//                            corr_lookup_pallas_t (_kernel_lane_major):
//                            lane-major (B, h_l, w_l, P) levels, the source pixel
//                            on the fastest axis.
// (The other stored forms, int8, packed and folded, run the staged per-pixel
// gather of corr_gather.cu.)
//
// It writes the same (B, P, L*(2r+1)^2) window samples as mft_corr_lookup
// (corr_gather.cu): per pixel, a bilinear zero-padded (2r+1)^2 window from
// each level of its own correlation map, channel k = l*(2r+1)^2 + i*(2r+1) + j
// sampled at (x/2^l + i - r, y/2^l + j - r), in the volume dtype.
//
// What bounds it on this card. Like mft_corr_lookup, the bytes of the taps
// the windows touch plus the output: about 23 MB of bf16 taps and 18.6 MB of
// bf16 samples per launch at 512x512 with 7 pairs. The TPU kernel contracted
// tent-weight matrices against every map position for 128 pixels at once,
// because the TPU has no fast gather; here every sample gathers its own four
// taps.
//
// What the design does about it (lane_group_kernel). A group of G
// consecutive pixels of one pair a block (G = 16 in bf16, 8 in f32: 32
// bytes, one sector, a map position). A pixel's own window reads one value of
// each sector it touches, so per level the block stages the group's union
// box, the bounding box of its pixels' (2r+3)^2 boxes (the gather's box, one
// tap wider than the window because floor(c/2^l + k) can round up), as
// G-value runs: 16-byte cp.async copies where every run is 16-byte aligned (P
// * itemsize a multiple of 16) and the group is whole, else value by value;
// zeros outside the map, so sampling has no bounds checks. Level l + 1 is
// copied while level l is sampled. Thread (column i, pixel g) samples its
// pixel's window column at each level in the plain version's operation order
// (as corr_gather.cuh sample(): x-weights once per column, y-weights once per
// row, each position as c/2^l + offset, the four taps summed in order); g is
// the fastest index, so a warp's taps fall in distinct banks where the
// pixels' positions advance by one. A union of more than kCap positions
// (wild coordinates; a group that straddles two image rows; flow
// discontinuities) is read per pixel from device memory in the same launch,
// in the same order. The (G, C) samples leave through shared memory with
// 16-byte stores. Local coordinates (the grid + U(-2, 2)) at 512x512 give
// unions within kCap at every level (tests/test_torch_corr_split.py).
// cp.async rather than TMA: a tensor map's box is fixed when it is encoded,
// while the union's size changes from group to group, and P not a multiple
// of 8 needs the value-by-value route anyway.
//
// Arithmetic is written in the order of the plain PyTorch version
// (ops/corr_lookup.py) and built with -fmad=false, so the kernel is
// bit-identical to it. All offsets are 64-bit: the lane-major level 0 of 7
// pairs at 1080x1920 holds 7.3e9 values.

#include "corr_gather.cuh"   // kMaxLevels, from_f32, box_value, box_origin, box_index

namespace {

constexpr int kCap = 512;   // map positions of a staged union box (lane-major)

// (group, level)s of the lane-major lookup: staged ones in the low 32 bits,
// those read per pixel in the high 32; read and reset by
// mft_corr_lookup_t_counts. A device global, so that mft_corr_lookup_t keeps
// its C signature.
__device__ unsigned long long g_lane_group_counts;

// Where level l's value at (pair b, source pixel p, row y, column x) lies:
// base[l] + b*bstride + p + y*rstride + x*cstride (elements).
struct Layout {
  const void* base[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  long bstride[kMaxLevels];
  long rstride[kMaxLevels];
  long cstride[kMaxLevels];
  int num_levels;
};

// One stored value as f32 (box_value widens bf16), zero outside the map.
template <typename T>
__device__ __forceinline__ float tap(const T* map, long rstride, long cstride, int h,
                                     int w, int xi, int yi) {
  const bool valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h);
  return valid ? box_value(map[(long)yi * rstride + (long)xi * cstride]) : 0.0f;
}

// The lane-major kernel's shape: a group of G pixels a block, 32 bytes a map
// position; thread (column i, pixel g), g the fastest.
template <int R, typename T>
struct GroupShape {
  static constexpr int n = 2 * R + 1;
  static constexpr int nn = n * n;
  static constexpr int side = n + 2;                      // a pixel's box side
  static constexpr int G = 32 / (int)sizeof(T);
  static constexpr int threads = G * n;
  static constexpr int parts = G * (int)sizeof(T) / 16;   // 16-byte copies a position
  static constexpr int per_part = 16 / (int)sizeof(T);
  static constexpr unsigned mask = (1u << G) - 1u;        // the lanes of the group's pixels
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// Copy level l's union box u = (x, y, width, height) of the group's pixels
// p0.. (np of them) of pair b into buf, [height][width][G], zeros outside the
// map. vec: every run is 16-byte aligned. A position's row is
// (e + 0.5) / width, exact in f32 for e < kCap.
template <int R, typename T>
__device__ __forceinline__ void stage_union(T* buf, const Layout& lay, int l, int4 u, int b,
                                            int p0, int np, bool vec) {
  using S = GroupShape<R, T>;
  const int h = lay.h[l], w = lay.w[l];
  const long rs = lay.rstride[l], cs = lay.cstride[l];
  const T* map = static_cast<const T*>(lay.base[l]) + (long)b * lay.bstride[l] + p0;
  const int positions = u.z * u.w;
  const float inv = 1.0f / (float)u.z;
  if (vec && np == S::G) {
    for (int c = threadIdx.x; c < positions * S::parts; c += S::threads) {
      const int e = c / S::parts, part = c - e * S::parts;
      const int ry = (int)(((float)e + 0.5f) * inv);
      const int x = u.x + e - ry * u.z, y = u.y + ry;
      T* dst = buf + e * S::G + part * S::per_part;
      if (x >= 0 && x < w && y >= 0 && y < h)
        cp_async16(dst, map + (long)y * rs + (long)x * cs + part * S::per_part);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int c = threadIdx.x; c < positions * S::G; c += S::threads) {
      const int e = c / S::G, g = c - e * S::G;
      const int ry = (int)(((float)e + 0.5f) * inv);
      const int x = u.x + e - ry * u.z, y = u.y + ry;
      const bool in = g < np && x >= 0 && x < w && y >= 0 && y < h;
      buf[c] = in ? map[(long)y * rs + (long)x * cs + g] : from_f32<T>(0.0f);
    }
  }
}

// Lane-major: block = group blockIdx.x % groups of pair blockIdx.x / groups.
template <int R, typename T>
__global__ void __launch_bounds__(GroupShape<R, T>::threads)
lane_group_kernel(Layout lay, const float* __restrict__ coords, T* __restrict__ out, int P,
                  int groups, int vec) {
  using S = GroupShape<R, T>;
  constexpr int G = S::G, n = S::n, nn = S::nn;
  __shared__ __align__(16) unsigned char box_bytes[2][kCap * G * sizeof(T)];
  __shared__ __align__(16) unsigned char tile_bytes[G * kMaxLevels * nn * sizeof(T)];
  __shared__ int4 unions[kMaxLevels];
  T* tile = reinterpret_cast<T*>(tile_bytes);
  const int L = lay.num_levels, C = L * nn;
  const int b = blockIdx.x / groups;
  const int p0 = (blockIdx.x - b * groups) * G;
  const int np = min(G, P - p0);
  const int g = threadIdx.x % G, i = threadIdx.x / G;
  const bool mine = g < np;
  const long bp = (long)b * P + p0 + g;
  float cx = 0.0f, cy = 0.0f;
  if (mine) {
    cx = __ldg(coords + 2 * bp);
    cy = __ldg(coords + 2 * bp + 1);
  }
  if (threadIdx.x < G) {   // i = 0: each level's union of the pixels' boxes
    int staged = 0;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l < L) {
        const float inv = __int_as_float((127 - l) << 23);   // 2^-l, exact
        const int ox = box_origin(floorf(cx * inv + (float)(-R)), lay.w[l], S::side);
        const int oy = box_origin(floorf(cy * inv + (float)(-R)), lay.h[l], S::side);
        int x0 = mine ? ox : 0x7fffffff, y0 = mine ? oy : 0x7fffffff;
        int x1 = mine ? ox : -0x7fffffff, y1 = mine ? oy : -0x7fffffff;
#pragma unroll
        for (int m = G / 2; m > 0; m >>= 1) {
          x0 = min(x0, __shfl_xor_sync(S::mask, x0, m));
          y0 = min(y0, __shfl_xor_sync(S::mask, y0, m));
          x1 = max(x1, __shfl_xor_sync(S::mask, x1, m));
          y1 = max(y1, __shfl_xor_sync(S::mask, y1, m));
        }
        const int4 u = make_int4(x0, y0, x1 - x0 + S::side, y1 - y0 + S::side);
        if (threadIdx.x == 0) unions[l] = u;
        staged += u.z * u.w <= kCap;
      }
    }
    if (threadIdx.x == 0)
      atomicAdd(&g_lane_group_counts,
                (unsigned long long)staged | (unsigned long long)(L - staged) << 32);
  }
  __syncthreads();

  auto buffer = [&](int l) { return reinterpret_cast<T*>(box_bytes[l & 1]); };
  auto staged = [&](int l) { return unions[l].z * unions[l].w <= kCap; };
  if (staged(0)) stage_union<R, T>(buffer(0), lay, 0, unions[0], b, p0, np, vec);
  cp_async_commit();
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < L) {
      // level l + 1's box is copied while level l is sampled
      if (l + 1 < kMaxLevels && l + 1 < L && staged(l + 1))
        stage_union<R, T>(buffer(l + 1), lay, l + 1, unions[l + 1], b, p0, np, vec);
      cp_async_commit();
      cp_async_wait_one();
      __syncthreads();
      if (mine) {
        const int h = lay.h[l], w = lay.w[l];
        const float inv = 1.0f / (float)(1 << l);   // a power of two: exact
        const float ax = cx * inv, ay = cy * inv;
        const float oxf = floorf(ax + (float)(-R));
        const float oyf = floorf(ay + (float)(-R));
        const float x = ax + (float)(i - R);
        const float x0f = floorf(x);
        const float wx = x - x0f;
        const float w0x = 1.0f - wx;
        T* samples = tile + g * C + l * nn + i * n;
        if (staged(l)) {
          const int4 u = unions[l];
          const int col = box_origin(oxf, w, S::side) - u.x + box_index<R>(x0f - oxf);
          const int row = box_origin(oyf, h, S::side) - u.y;
          const int pitch = u.z * G;
          const T* base = buffer(l) + col * G + g;
#pragma unroll
          for (int j = 0; j < n; ++j) {
            const float y = ay + (float)(j - R);
            const float y0f = floorf(y);
            const float wy = y - y0f;
            const float w0y = 1.0f - wy;
            const T* q = base + (row + box_index<R>(y0f - oyf)) * pitch;
            float acc = box_value(q[0]) * (w0x * w0y);
            acc = acc + box_value(q[G]) * (wx * w0y);
            acc = acc + box_value(q[pitch]) * (w0x * wy);
            acc = acc + box_value(q[pitch + G]) * (wx * wy);
            samples[j] = from_f32<T>(acc);
          }
        } else {   // per pixel from device memory, taps outside the map zero
          const T* map = static_cast<const T*>(lay.base[l]) + (long)b * lay.bstride[l] + p0 + g;
          const long rs = lay.rstride[l], cs = lay.cstride[l];
          const int x0 = (int)x0f;
#pragma unroll
          for (int j = 0; j < n; ++j) {
            const float y = ay + (float)(j - R);
            const float y0f = floorf(y);
            const float wy = y - y0f;
            const float w0y = 1.0f - wy;
            const int y0 = (int)y0f;
            float acc = tap(map, rs, cs, h, w, x0, y0) * (w0x * w0y);
            acc = acc + tap(map, rs, cs, h, w, x0 + 1, y0) * (wx * w0y);
            acc = acc + tap(map, rs, cs, h, w, x0, y0 + 1) * (w0x * wy);
            acc = acc + tap(map, rs, cs, h, w, x0 + 1, y0 + 1) * (wx * wy);
            samples[j] = from_f32<T>(acc);
          }
        }
      }
      __syncthreads();   // the box of level l is free for level l + 2's
    }
  }

  // the group's (np, C) samples are one stretch of the output
  T* dst = out + ((long)b * P + p0) * C;
  const int values = np * C;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int vecs = values * (int)sizeof(T) / 16;
    for (int v = threadIdx.x; v < vecs; v += S::threads)
      reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(tile)[v];
    done = vecs * S::per_part;
  }
  for (int e = done + threadIdx.x; e < values; e += S::threads) dst[e] = tile[e];
}

bool bad_levels(int num_levels) { return num_levels < 1 || num_levels > kMaxLevels; }

// Separate (B, h_l, w_l, P) levels.
Layout lane_major_levels(const void* const* lv, const int* hw, int num_levels, int P) {
  Layout lay = {};
  for (int l = 0; l < num_levels; ++l) {
    const long w = hw[2 * l + 1];
    lay.base[l] = lv[l];
    lay.h[l] = hw[2 * l];
    lay.w[l] = hw[2 * l + 1];
    lay.bstride[l] = (long)hw[2 * l] * w * P;
    lay.rstride[l] = w * P;
    lay.cstride[l] = P;
  }
  lay.num_levels = num_levels;
  return lay;
}

template <int R, typename T>
cudaError_t launch_lane_group(const Layout& lay, const void* coords, void* out, int B, int P,
                              cudaStream_t stream) {
  using S = GroupShape<R, T>;
  const int groups = (P + S::G - 1) / S::G;
  bool vec = (long)P * (long)sizeof(T) % 16 == 0;
  for (int l = 0; l < lay.num_levels; ++l)
    vec = vec && (reinterpret_cast<uintptr_t>(lay.base[l]) & 15) == 0;
  lane_group_kernel<R, T><<<(unsigned)((long)B * groups), S::threads, 0, stream>>>(
      lay, static_cast<const float*>(coords), static_cast<T*>(out), P, groups, (int)vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lane_group_radius(const Layout& lay, const void* coords, void* out, int B,
                                     int P, int radius, cudaStream_t stream) {
  switch (radius) {
    case 1: return launch_lane_group<1, T>(lay, coords, out, B, P, stream);
    case 2: return launch_lane_group<2, T>(lay, coords, out, B, P, stream);
    case 3: return launch_lane_group<3, T>(lay, coords, out, B, P, stream);
    case 4: return launch_lane_group<4, T>(lay, coords, out, B, P, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int mft_corr_lookup_t(void* out, const void* coords, const void* l0,
                                 const void* l1, const void* l2, const void* l3, int h0,
                                 int w0, int h1, int w1, int h2, int w2, int h3, int w3,
                                 int num_levels, int B, int P, int radius, int dtype,
                                 void* stream) {
  if (bad_levels(num_levels) || radius < 1 || radius > kMaxRadius)
    return (int)cudaErrorInvalidValue;
  if ((long)B * P <= 0) return (int)cudaSuccess;   // no pixels: nothing to write
  const void* lv[kMaxLevels] = {l0, l1, l2, l3};
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  const Layout lay = lane_major_levels(lv, hw, num_levels, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch_lane_group_radius<__nv_bfloat16>(lay, coords, out, B, P, radius, s);
  if (dtype == 0) return (int)launch_lane_group_radius<float>(lay, coords, out, B, P, radius, s);
  return (int)cudaErrorInvalidValue;
}

// The (group, level)s of mft_corr_lookup_t's launches so far whose union box
// was staged (counts[0]) and that were read per pixel (counts[1]), two int64
// in host memory; reset: zero them after reading. Waits for the device.
extern "C" int mft_corr_lookup_t_counts(void* counts, int reset) {
  unsigned long long v = 0;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(&v, g_lane_group_counts, sizeof(v));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_lane_group_counts, &zero, sizeof(zero));
  }
  long long* c = static_cast<long long*>(counts);
  c[0] = (long long)(v & 0xffffffffull);
  c[1] = (long long)(v >> 32);
  return (int)err;
}
