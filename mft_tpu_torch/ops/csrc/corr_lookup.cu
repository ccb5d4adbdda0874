// RAFT correlation-pyramid window lookup fused with convc1, for Hopper (sm_90a).
//
// mft_corr_lookup_conv_tc  (bfloat16) and
// mft_corr_lookup_conv     (float32) replace mft_tpu/ops/corr_lookup_pallas.py
//                          corr_lookup_pallas_fused (_kernel_pixel_major_fused):
//                          per pixel, a bilinear zero-padded (2r+1)^2 window
//                          from each level of its own (h_l, w_l) correlation
//                          map (the samples of mft_corr_lookup, corr_gather.cu),
//                          rounded through the volume dtype, then
//                          relu(samples @ Wc + b), the motion encoder's
//                          324->256 1x1 convc1, accumulated in f32 and
//                          written (B, P, F) in the volume dtype.
//
// Both take their samples from the staged per-pixel gather of corr_gather.cuh
// (the code of K2 and #9), so every sample equals the plain version's bit for
// bit (ops/corr_lookup.py corr_lookup_fused_ref); radius 1..4, 1..4 levels.
//
// What bounds it on this card. The TPU kernel multiplied tent-weight matrices
// against each pixel's whole h x w map because the TPU has no fast gather.
// Hopper gathers: a window reads only the (2r+3)^2 taps around its centre, so
// the lookup is bound by the bytes of those taps (about 23 MB per launch at
// 512x512, 7 pairs) plus its output (14.7 MB in bf16): ~8 us at 3.35 TB/s.
// The contraction adds 2*324*256 operations per pixel, 4.75 GFLOP per launch
// at the slice: ~5 us on the tensor cores at 989 TFLOP/s.
//
// What the bfloat16 design (lookup_conv_tc_kernel) does about it:
// - Persistent blocks, one per SM, each over an equal share of the pixels in
//   tiles of 64 (wgmma's M; its last tile ragged).
//   Each block loads Wc once: the (F, C) row-major conv weight, already
//   wgmma's K-major B operand, copied (cp.async) into shared memory with F
//   padded to a multiple of 64 and C to one of 16 with zeros, and kept there
//   for all its tiles (172 KB at F = 256, C = 324).
// - 16 gather warps (four warpgroups) take the tile's pixels, warp w pixels
//   w, w + 16, w + 32, w + 48; each stages a pixel's boxes in bf16 (the taps
//   are bf16 values, so nothing is lost; f32 boxes would not fit beside Wc)
//   and writes its samples, rounded to bf16 as the plain version rounds
//   them, straight into the shared A tile (64 x K). A warp issues its next
//   pixel's loads before it samples the current one, across tiles too.
// - Both operands are K-major with the 32-byte swizzle: K in chunks of 16
//   values (32 bytes a row), so C = 324 pads only to 336 and a k16 step is
//   one chunk.
// - Warpgroup g computes output columns [64 g, 64 g + 64): m64n64k16 wgmma
//   over the K/16 steps into f32 accumulators. The epilogue adds the f32
//   bias, applies relu, rounds once to bf16 and stages the tile in the A
//   tile's space, from which the block writes the tile's contiguous 64 x F
//   output with 16-byte stores.
// - The rounding repair. The tensor cores sum in their own order; where an
//   output's f32 sum lies near a bf16 rounding boundary, it may round the
//   other way than the plain version's sum (sequential f32 FMAs over k, also
//   cuBLAS's order at these shapes): 429-627 of 7.3 million outputs at the
//   slice, which moves a random-weight frame 0.05 px. So each thread tests
//   its outputs v = acc + b before the A tile is overwritten: where
//   relu(v - e) and relu(v + e) round to two bf16 values, with the window
//   e = 2^-20 ||a_p|| max_f ||w_f|| (a_p the pixel's bf16 samples, whose
//   norm the gather warps sum as they write them; no partial sum of either
//   order exceeds ||a_p|| ||w_f||), it recomputes the output with the plain
//   version's sequential FMAs from the A tile and the resident Wc. The
//   result is held to ops.product_error_bound (K = C terms), as #5 and #13
//   are, and equals the plain version's wherever the two orders' sums
//   differ by less than e; its samples always do (with +-1 diagonal
//   weights every sum is exact).
// Shared memory at F = 256, r = 4, 4 levels: Wc 172,032 + A 43,008 + boxes
// 16 x 1,056 = 231,936 bytes (+ 256 to align the base), and 224 static (the
// level table, the row norms in bf16, max_f ||w_f||), of the 232,448 a block
// may use, one block an SM; the boxes' rows use the least even pitch (12
// values) to fit.
//
// The float32 form (lookup_conv_kernel) keeps a CUDA-core contraction, exact
// to its stated tolerance and free of TF32: 8 warps gather a tile of 32
// pixels into a k-major shared tile (f32 boxes), then each of 256 threads owns
// one output channel and walks k with 32 FMAs per weight it reads.

#include "corr_gather.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int kSmemPerBlock = 232448;   // 227 KB, sm_90's opt-in maximum

// ------------------------------------------------------------------------- //
// float32: the samples of a 32-pixel tile, then a CUDA-core contraction
// ------------------------------------------------------------------------- //
constexpr int kTileP = 32;      // pixels per block
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the k-major sample tile at the most channels (4 levels, r = 4)
constexpr int kF32Dyn = kMaxLevels * (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1) * kTileP * 4;

template <int R>
__global__ void __launch_bounds__(kThreads)
lookup_conv_kernel(Levels lv, const float* __restrict__ coords, const float* __restrict__ wc,
                   const float* __restrict__ bias, float* __restrict__ out, long BP, int L,
                   int F) {
  using G = Geometry<R, float>;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);  // [C][kTileP], k-major
  __shared__ __align__(16) float boxes[kWarps][kMaxLevels * G::box];
  __shared__ Levels levels;
  fill_levels(levels, lv);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int C = L * G::nn;
  const long p0 = (long)blockIdx.x * kTileP;

  // phase 1: the tile's window samples, a warp per pixel
  uint32_t wd[G::slots][G::words] = {};
  uint32_t info[G::slots];
  for (int pl = warp; pl < kTileP; pl += kWarps) {
    const long bp = p0 + pl;
    if (bp < BP) {
      const float cx = __ldg(coords + 2 * bp), cy = __ldg(coords + 2 * bp + 1);
      load_rows<R, float>(levels, bp, cx, cy, L, lane, wd, info);
      store_rows<R, float>(L, lane, boxes[warp], wd, info);
      __syncwarp();
      sample<R, float>(boxes[warp], cx, cy, L, lane,
                       [&](int k, float v) { s[k * kTileP + pl] = v; });
      __syncwarp();
    }
  }
  __syncthreads();

  // phase 2: out[p, f] = relu(sum_k s[k, p] * wc[k, f] + bias[f])
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc[kTileP];
#pragma unroll
    for (int p = 0; p < kTileP; ++p) acc[p] = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float wv = wc[(long)k * F + f];
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
      if (p0 + p < BP) out[(p0 + p) * F + f] = fmaxf(acc[p] + b, 0.0f);
    }
  }
}

template <int R>
cudaError_t launch_f32(const Levels& lv, const float* coords, const float* wc,
                       const float* bias, float* out, long BP, int L, int F,
                       cudaStream_t stream) {
  // set on the current device at every call: another device may come next
  const cudaError_t allowed = cudaFuncSetAttribute(
      lookup_conv_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32Dyn);
  if (allowed != cudaSuccess) return allowed;
  const size_t smem = sizeof(float) * kTileP * (size_t)(L * (2 * R + 1) * (2 * R + 1));
  const long blocks = (BP + kTileP - 1) / kTileP;
  lookup_conv_kernel<R><<<(unsigned)blocks, kThreads, smem, stream>>>(lv, coords, wc, bias,
                                                                       out, BP, L, F);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------- //
// bfloat16: the samples straight into a wgmma operand, Wc resident
// ------------------------------------------------------------------------- //
constexpr int kTcWarps = 16;                 // gather warps: four warpgroups
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kRows = 64;                    // pixels per tile: wgmma's M
constexpr int kPixPerWarp = kRows / kTcWarps;
constexpr float kWindow = 1.0f / (1 << 20);   // the repair's window, over ||a_p|| max ||w_f||

// The tensor-core kernel's static shared memory.
struct TcStatic {
  Levels levels;
  __nv_bfloat16 norm[kRows];   // ||a_p|| of the tile's rows, rounded up
  float wmax;                  // max_f ||w_f||
  int listed;                  // outputs on the repair's list
};
constexpr int kTcDynMax = kSmemPerBlock - (int)sizeof(TcStatic);

// d += A * B, m64n64k16, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64_k(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MFT_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MFT_D8(0), MFT_D8(8), MFT_D8(16), MFT_D8(24)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// The plain version's sum of output (row, col): sequential f32 FMAs over
// k = 0..C-1 of the A tile's row and Wc's row col, both K-major with the
// 32-byte swizzle: chunk c of 16 values is rows x 32 bytes, and its two
// 16-byte halves of 8 values trade places in rows 4-7 of every 8. A chunk
// at a time, not unrolled: it runs beside the live accumulators.
__device__ __forceinline__ float plain_sum(const uint8_t* a, const uint8_t* b, int row, int col,
                                           int C, int NP) {
  const auto lo = [](uint32_t w) { return __uint_as_float(w << 16); };
  const auto hi = [](uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); };
  const auto fma8 = [&](uint4 x, uint4 y, float s) {
    s = __fmaf_rn(lo(x.x), lo(y.x), s);
    s = __fmaf_rn(hi(x.x), hi(y.x), s);
    s = __fmaf_rn(lo(x.y), lo(y.y), s);
    s = __fmaf_rn(hi(x.y), hi(y.y), s);
    s = __fmaf_rn(lo(x.z), lo(y.z), s);
    s = __fmaf_rn(hi(x.z), hi(y.z), s);
    s = __fmaf_rn(lo(x.w), lo(y.w), s);
    return __fmaf_rn(hi(x.w), hi(y.w), s);
  };
  const uint8_t* pa = a + row * 32;
  const uint8_t* pb = b + col * 32;
  const int ha = (row << 2) & 16, hb = (col << 2) & 16;   // where k = 0..7 lie
  float s = 0.0f;
  int k = 0;
#pragma unroll 1
  for (; k + 16 <= C; k += 16, pa += kRows * 32, pb += NP * 32) {
    const uint4 x0 = *reinterpret_cast<const uint4*>(pa + ha);
    const uint4 y0 = *reinterpret_cast<const uint4*>(pb + hb);
    const uint4 x1 = *reinterpret_cast<const uint4*>(pa + (ha ^ 16));
    const uint4 y1 = *reinterpret_cast<const uint4*>(pb + (hb ^ 16));
    s = fma8(x0, y0, s);
    s = fma8(x1, y1, s);
  }
  if (k + 8 <= C) {
    s = fma8(*reinterpret_cast<const uint4*>(pa + ha), *reinterpret_cast<const uint4*>(pb + hb), s);
    k += 8;
  }
#pragma unroll 1
  for (; k < C; ++k) {
    const uint32_t x = *reinterpret_cast<const unsigned short*>(a + sw32_offset(row, k, kRows));
    const uint32_t y = *reinterpret_cast<const unsigned short*>(b + sw32_offset(col, k, NP));
    s = __fmaf_rn(lo(x), lo(y), s);
  }
  return s;
}

// The zero columns [C, K) of the A tile.
__device__ __forceinline__ void zero_a_pad(uint8_t* a, int C, int K) {
  const int pad = K - C;
  for (int e = threadIdx.x; e < kRows * pad; e += blockDim.x) {
    const int row = e / pad;
    *reinterpret_cast<unsigned short*>(a + sw32_offset(row, C + e - row * pad, kRows)) = 0;
  }
}

// K = C rounded up to 16, NP = F rounded up to 64 (zeros past C and F); the
// A tile holds 64 x K samples, then the 64 x F outputs at `pitch` bytes a row.
template <int R>
__global__ void __launch_bounds__(kTcThreads, 1)
lookup_conv_tc_kernel(Levels lv, const float* __restrict__ coords,
                      const __nv_bfloat16* __restrict__ wt, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, long BP, int L, int F, int K, int NP,
                      int a_bytes, int pitch) {
  using T = __nv_bfloat16;
  using G = Geometry<R, T, T>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ TcStatic st;
  Levels& levels = st.levels;
  uint8_t* bsm = align256(smem_raw);           // Wc: NP x K
  uint8_t* asm_ = bsm + NP * K * 2;            // samples: 64 x K; then the outputs
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, wg = tid >> 7;
  T* boxes = reinterpret_cast<T*>(asm_ + a_bytes) + warp * (kMaxLevels * G::box);
  // the repair's list of (row | col << 8, sum) in the boxes' space, which
  // no warp uses between a tile's last samples and the next tile
  uint2* list = reinterpret_cast<uint2*>(asm_ + a_bytes);
  constexpr int list_cap = kTcWarps * kMaxLevels * G::box * (int)sizeof(T) / (int)sizeof(uint2);
  const int C = L * G::nn;
  fill_levels(levels, lv);
  if (tid == 0) {
    st.wmax = 0.0f;
    st.listed = 0;
  }

  // Wc once: rows f of the (F, C) weight, pairs of k, zeros past F and C
  {
    const int KH = K / 2;
    const bool even = (C & 1) == 0;
    for (int f = warp; f < NP; f += kTcWarps) {
      for (int kp = lane; kp < KH; kp += 32) {
        const int k = 2 * kp;
        uint8_t* dst = bsm + sw32_offset(f, k, NP);
        const T* src = wt + (long)f * C + k;
        if (f < F && k < C && even) {
          cp_async4(smem_u32(dst), src);
        } else {
          const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
          const uint32_t lo = f < F && k < C ? __ldg(s) : 0u;
          const uint32_t hi = f < F && k + 1 < C ? __ldg(s + 1) : 0u;
          *reinterpret_cast<uint32_t*>(dst) = lo | (hi << 16);
        }
      }
    }
  }
  zero_a_pad(asm_, C, K);
  __syncthreads();   // the level table

  // the block's pixels [begin, end): an equal share of BP, in tiles of 64
  // (the last one ragged); job n of this warp: pixel warp + 16 (n % 4) of
  // tile n / 4
  const long begin = BP * blockIdx.x / gridDim.x, end = BP * (blockIdx.x + 1) / gridDim.x;
  const long jobs = (end - begin + kRows - 1) / kRows * kPixPerWarp;
  auto pixel = [&](long n) {
    return begin + n / kPixPerWarp * kRows + warp + kTcWarps * (n % kPixPerWarp);
  };
  auto read_coords = [&](long n, float& x, float& y) {
    if (n < jobs && pixel(n) < end) {
      x = __ldg(coords + 2 * pixel(n));
      y = __ldg(coords + 2 * pixel(n) + 1);
    }
  };

  uint32_t wd[G::slots][G::words] = {};
  uint32_t info[G::slots];
  float cx = 0.0f, cy = 0.0f, nx = 0.0f, ny = 0.0f;
  read_coords(0, cx, cy);
  if (pixel(0) < end) load_rows<R, T, T>(levels, pixel(0), cx, cy, L, lane, wd, info);
  read_coords(1, nx, ny);
  for (long n = 0; n < jobs; ++n) {
    const bool mine = pixel(n) < end;
    if (mine) store_rows<R, T, T>(L, lane, boxes, wd, info);
    float fx = 0.0f, fy = 0.0f;
    read_coords(n + 2, fx, fy);
    if (n + 1 < jobs && pixel(n + 1) < end)
      load_rows<R, T, T>(levels, pixel(n + 1), nx, ny, L, lane, wd, info);
    __syncwarp();
    if (mine) {
      const int m = warp + kTcWarps * (int)(n % kPixPerWarp);
      float sq = 0.0f;   // ||a_p||^2, for the repair's window
      sample<R, T, T>(boxes, cx, cy, L, lane, [&](int k, float v) {
        const T q = __float2bfloat16_rn(v);
        *reinterpret_cast<T*>(asm_ + sw32_offset(m, k, kRows)) = q;
        sq = fmaf(__bfloat162float(q), __bfloat162float(q), sq);
      });
      sq = warp_sum(sq);
      if (lane == 0) st.norm[m] = __float2bfloat16_ru(sqrtf(sq));
    }
    __syncwarp();
    cx = nx; cy = ny; nx = fx; ny = fy;
    if (n % kPixPerWarp != kPixPerWarp - 1) continue;

    // the tile's samples are in: warpgroup wg computes output columns
    // [64 wg, 64 wg + 64) on the tensor cores
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
    if (n == kPixPerWarp - 1) {
      // max_f ||w_f|| from the resident Wc, once: thread 2 f + h sums the
      // squares of half h of row f's 16-byte units, chunk by chunk
      float sq = 0.0f;
      if (tid < 2 * F) {
        const uint8_t* p = bsm + tid * 16;
        for (int c = 0; c < K / 16; ++c, p += NP * 32) {
          const uint4 x = *reinterpret_cast<const uint4*>(p);
          const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float lo = __uint_as_float(w[q] << 16), hi = __uint_as_float(w[q] & 0xFFFF0000u);
            sq = fmaf(hi, hi, fmaf(lo, lo, sq));
          }
        }
      }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
#pragma unroll
      for (int d = 2; d < 32; d <<= 1) sq = fmaxf(sq, __shfl_xor_sync(0xffffffffu, sq, d));
      // non-negative floats order as their bits
      if (lane == 0) atomicMax(reinterpret_cast<int*>(&st.wmax), __float_as_int(sqrtf(sq)));
      __syncthreads();
    }
    const long p0 = begin + n / kPixPerWarp * kRows;
    const int rows = end - p0 < kRows ? (int)(end - p0) : kRows;
    const int col0 = 64 * wg;
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
    uint32_t near = 0;   // this thread's outputs that the repair recomputes,
    uint32_t redo = 0;   // those of them past the list's end
    int first = 0;       // the list slot of its first
    if (col0 < NP) {
      const uint32_t a0 = smem_u32(asm_), b0 = smem_u32(bsm) + col0 * 32;
      fence_acc(acc);
      wgmma_fence();
      for (int ks = 0; ks < K / 16; ++ks)
        wgmma_ss_n64_k(acc, sw32_desc(a0 + ks * kRows * 32), sw32_desc(b0 + ks * NP * 32));
      wgmma_commit();
      wgmma_wait_all();
      fence_acc(acc);

      // the bias added; the rounding repair, 1: the outputs within the
      // window of a bf16 rounding boundary (this thread's rows: acc_row(0)
      // and acc_row(0) + 8)
      const float e0 = kWindow * st.wmax * __bfloat162float(st.norm[acc_row(0)]);
      const float e1 = kWindow * st.wmax * __bfloat162float(st.norm[acc_row(2)]);
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = col0 + acc_col(i);
        if (col < F) {
          acc[i] = __fadd_rn(acc[i], __ldg(bias + col));
          acc[i + 1] = __fadd_rn(acc[i + 1], __ldg(bias + col + 1));
          const float e = (i & 2) ? e1 : e0;
          const uint32_t x0 = pack_bf16x2(fmaxf(acc[i] - e, 0.0f), fmaxf(acc[i] + e, 0.0f));
          const uint32_t x1 = pack_bf16x2(fmaxf(acc[i + 1] - e, 0.0f), fmaxf(acc[i + 1] + e, 0.0f));
          const uint32_t pair = (uint32_t)((x0 ^ (x0 >> 16)) & 0xFFFFu ? 1 : 0) |
                                (uint32_t)((x1 ^ (x1 >> 16)) & 0xFFFFu ? 2 : 0);
          if (acc_row(i) < rows) near |= pair << i;
        }
      }
      // go on the block's list (in the boxes' space) in lane order, a slot
      // range per warp; past its end they stay with their thread
      const int count = __popc(near);
      int upto = count;   // inclusive prefix over the warp's lanes
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, upto, d);
        if (lane >= d) upto += t;
      }
      int base = 0;
      if (lane == 31) base = atomicAdd(&st.listed, upto);
      first = __shfl_sync(0xffffffffu, base, 31) + upto - count;
      int slot = first;
      for (uint32_t m = near; m; m &= m - 1, ++slot) {
        const int i = __ffs(m) - 1;
        if (slot < list_cap) list[slot].x = (uint32_t)(acc_row(i) | (col0 + acc_col(i)) << 8);
        else redo |= 1u << i;
      }
    }
    __syncthreads();
    // 2: the plain version's sums of the listed outputs, by every thread,
    // then of this thread's others
    const int listed = min(st.listed, list_cap);
    for (int j = tid;;) {
      int row, col, i = -1;
      if (j < listed) {
        row = list[j].x & 255;
        col = list[j].x >> 8;
      } else if (redo) {
        i = __ffs(redo) - 1;
        redo &= redo - 1;
        row = acc_row(i);
        col = col0 + acc_col(i);
      } else {
        break;
      }
      const float v = __fadd_rn(plain_sum(asm_, bsm, row, col, C, NP), __ldg(bias + col));
      if (i < 0) {
        list[j].y = __float_as_uint(v);
        j += kTcThreads;
      }
#pragma unroll
      for (int q = 0; q < 32; ++q)
        if (q == i) acc[q] = v;
    }
    __syncthreads();   // every warpgroup is done with the A tile

    // 3: this thread's listed sums back from its slots; relu and one
    // rounding; staged as the tile's rows of F values
    if (col0 < NP) {
      int slot = first;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if ((near >> i) & 1) {
          if (slot < list_cap) acc[i] = __uint_as_float(list[slot].y);
          ++slot;
        }
      }
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int col = col0 + acc_col(i);
        if (col < F) {
          *reinterpret_cast<uint32_t*>(asm_ + acc_row(i) * pitch + col * 2) =
              pack_bf16x2(fmaxf(acc[i], 0.0f), fmaxf(acc[i + 1], 0.0f));
        }
      }
    }
    __syncthreads();
    // the tile's outputs are one contiguous span of rows of F values
    const int per_row = F / 8;   // 16-byte pieces of a row
    uint4* dst = reinterpret_cast<uint4*>(out + p0 * F);
    for (int v = tid; v < rows * per_row; v += kTcThreads) {
      const int row = v / per_row;
      dst[v] = *reinterpret_cast<const uint4*>(asm_ + row * pitch + (v - row * per_row) * 16);
    }
    if (tid == 0) st.listed = 0;
    __syncthreads();
    zero_a_pad(asm_, C, K);
  }
}

template <int R>
cudaError_t launch_tc(const Levels& lv, const float* coords, const void* wt, const float* bias,
                      void* out, long BP, int L, int F, cudaStream_t stream) {
  // the current device's SM count and shared-memory opt-in, at every call
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(lookup_conv_tc_kernel<R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kTcDynMax);
  if (err != cudaSuccess) return err;
  using G = Geometry<R, __nv_bfloat16, __nv_bfloat16>;
  const int C = L * G::nn;
  const int K = (C + 15) / 16 * 16;
  const int NP = (F + 63) / 64 * 64;
  const int pitch = 2 * F + 16;   // staged output rows: 16 bytes apart in banks
  const int a_bytes = kRows * (2 * K > pitch ? 2 * K : pitch);
  const int boxes = kTcWarps * kMaxLevels * G::box * 2;
  const int smem = NP * K * 2 + a_bytes + boxes + 256;   // 256: aligning the base
  if (smem > kTcDynMax) return cudaErrorInvalidValue;
  // one block an SM, each taking an equal share of the pixels
  const long tiles = (BP + kRows - 1) / kRows;
  const long blocks = tiles < sms ? tiles : sms;
  lookup_conv_tc_kernel<R><<<(unsigned)blocks, kTcThreads, smem, stream>>>(
      lv, coords, static_cast<const __nv_bfloat16*>(wt), bias,
      static_cast<__nv_bfloat16*>(out), BP, L, F, K, NP, a_bytes, pitch);
  return cudaGetLastError();
}

// The arguments both entry points check.
bool valid_args(int num_levels, int radius, long BP) {
  return num_levels >= 1 && num_levels <= kMaxLevels && radius >= 1 && radius <= kMaxRadius &&
         BP >= 0;
}

}  // namespace

// bfloat16 volume, wt the (F, C) row-major conv weight (C = levels *
// (2r+1)^2; 4-byte aligned), bias float32 (F,), out (BP, F) bfloat16,
// 16-byte aligned; F a multiple of 8 up to 256; radius 1..4. Levels beyond
// num_levels are ignored (their pointers may be null); (h_l, w_l) are given
// for 4 levels.
extern "C" int mft_corr_lookup_conv_tc(void* out, const void* coords, const void* wt,
                                       const void* bias, const void* l0, const void* l1,
                                       const void* l2, const void* l3, int h0, int w0,
                                       int h1, int w1, int h2, int w2, int h3, int w3,
                                       int num_levels, long BP, int radius, int F,
                                       void* stream) {
  if (!valid_args(num_levels, radius, BP) || F < 8 || F > 256 || F % 8 ||
      (reinterpret_cast<uintptr_t>(out) & 15) || (reinterpret_cast<uintptr_t>(wt) & 3))
    return (int)cudaErrorInvalidValue;
  if (BP == 0) return (int)cudaSuccess;
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  Levels lv;
  if (!make_levels(l0, l1, l2, l3, hw, lv)) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return (int)launch_tc<1>(lv, c, wt, b, out, BP, num_levels, F, s);
    case 2: return (int)launch_tc<2>(lv, c, wt, b, out, BP, num_levels, F, s);
    case 3: return (int)launch_tc<3>(lv, c, wt, b, out, BP, num_levels, F, s);
    default: return (int)launch_tc<4>(lv, c, wt, b, out, BP, num_levels, F, s);
  }
}

// float32 volume, wc the (C, F) row-major conv kernel, bias (F,), out
// (BP, F) float32; radius 1..4. Levels as for mft_corr_lookup_conv_tc.
extern "C" int mft_corr_lookup_conv(void* out, const void* coords, const void* wc,
                                    const void* bias, const void* l0, const void* l1,
                                    const void* l2, const void* l3, int h0, int w0,
                                    int h1, int w1, int h2, int w2, int h3, int w3,
                                    int num_levels, long BP, int radius, int F,
                                    void* stream) {
  if (!valid_args(num_levels, radius, BP) || F < 1) return (int)cudaErrorInvalidValue;
  if (BP == 0) return (int)cudaSuccess;
  const int hw[2 * kMaxLevels] = {h0, w0, h1, w1, h2, w2, h3, w3};
  Levels lv;
  if (!make_levels(l0, l1, l2, l3, hw, lv)) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(coords);
  const float* w = static_cast<const float*>(wc);
  const float* b = static_cast<const float*>(bias);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return (int)launch_f32<1>(lv, c, w, b, o, BP, num_levels, F, s);
    case 2: return (int)launch_f32<2>(lv, c, w, b, o, BP, num_levels, F, s);
    case 3: return (int)launch_f32<3>(lv, c, w, b, o, BP, num_levels, F, s);
    default: return (int)launch_f32<4>(lv, c, w, b, o, BP, num_levels, F, s);
  }
}
