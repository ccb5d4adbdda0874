// The tiled products in bfloat16 on Hopper's tensor cores (sm_90a, wgmma):
// the correlation volume written straight into the folded layout, and the
// update block's SAME-size convolutions. Their float32 versions stay in
// product.cu, summed in one fixed order and bit-identical to the plain ones.
//
// mft_corr_build_folded_tc  replaces mft_tpu/ops/corr_lookup_pallas.py
//                           build_corr_pyramid_pallas (_build_kernel):
//                           out_l[b, p, q] = bf16(f32(sum_c f1[b, c, p] *
//                           f2_l[b, c, q]) * s), s = 1/sqrt(C), f1 (B, C, P)
//                           and f2_l (B, C, Q_l) with Q_l a multiple of 128,
//                           out_l the folded (B, P, Q_l/128, 128) level; all
//                           levels of all pairs in one launch.
// mft_conv_tc               replaces mft_tpu/ops/conv_pallas.py conv_pallas
//                           (_conv_kernel): out[b, n, y, x] = act(sum_k
//                           x[b, c, y + ky - pt, x + kx - pl] * w[n, c, ky, kx]
//                           + bias[n]) in NCHW, zeros outside the image, the
//                           sum and the bias in f32, one cast at the end; act
//                           none, relu, sigmoid or tanh; x with any strides.
//
// Summation order. The TPU kernels are bf16 MXU products with f32
// accumulation in an order the TPU chooses (one dot per tap, one dot_general
// per 128-lane row). These are the same: bf16 products, exact in f32, summed
// by the tensor cores in their own order into f32 accumulators. They are held
// to an error bound against the plain versions (ops/product.py
// product_error_bound): |got - want| <= K * 2^-22 * S * s + 2^-7 * |want|,
// S = sum_k |a_k * b_k|, s the scale (1/sqrt(C) or 1).
//
// What bounds them on this card. The volume: 350 MB of bytes (0.1045 ms at
// 3.35 TB/s) against 80.8 GFLOP (0.082 ms at 989 TFLOP/s); its 315 MB bf16
// output dominates. The convolutions: operations, ~1.78 TFLOP per 512x512
// frame (1.8 ms at the bf16 peak); their operand bytes are a few percent.
//
// What the designs do about it.
// - Volume: one block per 128 (p) x 128 (q) output tile of a pair and level,
//   two warpgroups of m64 x n128 (two m64n64k16 per k16 step). Both operands
//   are MN-major in memory (C is the outer axis); TMA loads them as 64 x 64
//   boxes with 128-byte swizzle into a ring of three stages, and wgmma reads
//   them through transposed descriptors. The epilogue scales in f32, rounds
//   once to bf16 and writes the tile through swizzled shared memory with
//   16-byte stores. Two blocks share an SM (96 KB each), so one block's
//   stores overlap the other's loads and products. (Persistent blocks that
//   keep the f1 tile resident read half the operand bytes from L2 but
//   measured slower: see PERF.md.)
// - Convolution: implicit GEMM, M = output pixels (a tile of 2 rows x 64
//   columns), N = output channels (up to 256 in one tile), K = (channel
//   chunk of 64, tap). Each channel chunk's zero-padded halo (tile rows +
//   kh - 1, columns + kw - 1) is staged once into shared memory,
//   channel-minor and swizzled, read through x's strides (16-byte loads of 8
//   pixels for NCHW maps with aligned rows, else coalesced along x or, for
//   channel-last, along c), double-buffered. One warp loads the weights of
//   each (chunk, tap), reordered by the wrapper to (tap, Cout, Cin) and
//   padded, by TMA into a ring of stages. Two consumer warpgroups take each
//   tap as a shifted view of the halo (ldmatrix with per-lane pixel
//   addresses) and run wgmma with A from registers and B from shared memory;
//   while a tap's wgmma run, their 8 warps stage that tap's share of the next
//   chunk's halo (for the 16-byte layout one tap ahead, so the load latency
//   spans a tap), so the staging overlaps the tensor cores. Tiles of N >= 192
//   move registers from the weight warpgroup to the consumers (setmaxnreg).
//   The epilogue adds the f32 bias, applies the activation, casts once and
//   stores through shared memory, so NCHW rows coalesce. Cout = 2 takes n8
//   tiles; Cout = 126 is masked in a 128-wide tile.

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kSmemPerBlock = 232448;  // 227 KB, sm_90's opt-in maximum
constexpr int kKTile = 64;             // k of one stage: 64 bf16 = 128 bytes
constexpr int kBox = 64 * 64 * 2;      // one 64 x 64 bf16 TMA box

// ------------------------------------------------------------------------- //
// PTX wrappers: mbarriers, TMA, wgmma, ldmatrix (the ones shared with
// corr_lookup.cu are in tensor_core.cuh)
// ------------------------------------------------------------------------- //
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity ``parity`` has completed. The suspend-time
// hint (ns) lets a waiting warp sleep until the phase completes instead of
// spinning on the barrier, which would take issue slots and shared-memory
// bandwidth from the warps that fill it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity), "r"(10000000)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// One 3-D box of the tensor map into shared memory; completes on ``bar``.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand tile.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_a(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[k][i])::"memory");
}

// d += A * B, m64n64k16, A and B from shared memory, both MN-major.
__device__ __forceinline__ void wgmma_ss_n64_mn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MFT_D32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : MFT_D8(0), MFT_D8(8), MFT_D8(16), MFT_D8(24)
      : "l"(da), "l"(db), "r"(1));
}

// d += A * B, m64n64k16, A from registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " MFT_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : MFT_D8(0), MFT_D8(8), MFT_D8(16), MFT_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A * B, m64n8k16, A from registers, B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ------------------------------------------------------------------------- //
// host: tensor maps, encoded through cudaGetDriverEntryPoint (the library links no
// libcuda)
// ------------------------------------------------------------------------- //
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of dims {d0, d1, d2} (d0 contiguous) read in boxes of
// {b0, b1, 1}, 128-byte swizzle, zeros outside.
cudaError_t make_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
                     uint32_t b0, uint32_t b1) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ------------------------------------------------------------------------- //
// the folded volume: m = source pixel p (f1), n = target position q (f2_l)
// ------------------------------------------------------------------------- //
constexpr int kBuildThreads = 256;
constexpr int kBuildStages = 3;
constexpr int kBuildStage = 4 * kBox;  // f1: two 64-p boxes, f2: two 64-q boxes
constexpr int kBuildSmem = kBuildStages * kBuildStage + 1024;

struct BuildMaps {
  CUtensorMap f1;              // (B, C, Pp) as {Pp, C, B}
  CUtensorMap f2[kMaxLevels];  // (B, C, Q_l) as {Q_l, C, B}
};

struct BuildLevels {
  __nv_bfloat16* out[kMaxLevels];  // (B, P, Q_l)
  int q[kMaxLevels];               // Q_l, multiples of 128
  int tile0[kMaxLevels + 1];       // first q tile of each level
  int num_levels;
};

__global__ void __launch_bounds__(kBuildThreads, 2)
build_folded_tc_kernel(__grid_constant__ const BuildMaps maps, const BuildLevels lv, int C,
                       int P, float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kBuildStages];
  uint8_t* smem = align1024(smem_raw);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int b = blockIdx.z;
  int l = 0;
  while (l + 1 < lv.num_levels && (int)blockIdx.x >= lv.tile0[l + 1]) ++l;
  const int Q = lv.q[l];
  const int q0 = ((int)blockIdx.x - lv.tile0[l]) * 128;
  const int p0 = blockIdx.y * 128;
  const int ksteps = (C + kKTile - 1) / kKTile;
  const CUtensorMap* f2map = &maps.f2[l];

  if (tid == 0) {
    for (int s = 0; s < kBuildStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int ks) {
    const int s = ks % kBuildStages;
    uint8_t* st = smem + s * kBuildStage;
    mbar_expect_tx(&full[s], kBuildStage);
    tma_load_3d(st, &maps.f1, &full[s], p0, ks * kKTile, b);
    tma_load_3d(st + kBox, &maps.f1, &full[s], p0 + 64, ks * kKTile, b);
    tma_load_3d(st + 2 * kBox, f2map, &full[s], q0, ks * kKTile, b);
    tma_load_3d(st + 3 * kBox, f2map, &full[s], q0 + 64, ks * kKTile, b);
  };
  if (tid == 0)
    for (int ks = 0; ks < kBuildStages && ks < ksteps; ++ks) issue(ks);

  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;

  for (int ks = 0; ks < ksteps; ++ks) {
    const int s = ks % kBuildStages;
    mbar_wait(&full[s], (ks / kBuildStages) & 1);
    const uint32_t st = smem_u32(smem + s * kBuildStage);
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    wgmma_fence();
    // A: this warpgroup's 64 p of the stage; B: the two 64-q halves. Each
    // box is 64 rows of k, 128 bytes of MN each (MN-major, 128-byte swizzle);
    // a k16 step is 16 rows (2048 bytes), 8-row groups 1024 bytes apart. The
    // MN extent of every operand is one 64-wide swizzle atom, so the
    // descriptor's other offset is never stepped (set to the same 1024).
#pragma unroll
    for (int kk = 0; kk < kKTile / 16; ++kk) {
      const uint64_t da = sw128_desc(st + wg * kBox + kk * 2048, 1024, 1024);
      wgmma_ss_n64_mn(acc[0], da, sw128_desc(st + 2 * kBox + kk * 2048, 1024, 1024));
      wgmma_ss_n64_mn(acc[1], da, sw128_desc(st + 3 * kBox + kk * 2048, 1024, 1024));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    __syncthreads();  // both warpgroups are done with stage s
    if (tid == 0 && ks + kBuildStages < ksteps) issue(ks + kBuildStages);
  }

  // epilogue: scale in f32, round once, stage 128 x 128 bf16 in shared
  // memory (16-byte chunks of a 256-byte row swizzled by row % 8), then
  // 16-byte stores along q
  uint8_t* tile = smem;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = wg * 64 + acc_row(i);
      const int col = h * 64 + acc_col(i);
      const int chunk = (col >> 3) ^ (row & 7);
      *reinterpret_cast<uint32_t*>(tile + row * 256 + chunk * 16 + (col & 7) * 2) =
          pack_bf16x2(__fmul_rn(acc[h][i], scale), __fmul_rn(acc[h][i + 1], scale));
    }
  __syncthreads();
  __nv_bfloat16* out = lv.out[l] + (long)b * P * Q + q0;
#pragma unroll
  for (int it = 0; it < 128 * 16 / kBuildThreads; ++it) {
    const int e = it * kBuildThreads + tid;
    const int row = e >> 4, j = e & 15;
    const int p = p0 + row;
    const uint4 v = *reinterpret_cast<const uint4*>(tile + row * 256 + ((j ^ (row & 7)) * 16));
    if (p < P) *reinterpret_cast<uint4*>(out + (long)p * Q + j * 8) = v;
  }
}

// ------------------------------------------------------------------------- //
// the convolution: m = output pixel of a 2 x 64 tile, n = output channel
// ------------------------------------------------------------------------- //
constexpr int kConvThreads = 384;   // consumer warpgroups 0-1; warpgroup 2: warp 8 loads weights
constexpr int kConsumers = 256;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kSlots = 3;           // halo columns a lane covers (64 + 6 <= 96)
constexpr int kUnitBatch = 2;       // halo units a warp loads before it stores
constexpr int kTileW = 64;
constexpr int kTileH = 2;
constexpr int kMaxTap = 7;
constexpr int kMaxHaloPix = (kTileH + kMaxTap - 1) * (kTileW + kMaxTap - 1);
constexpr int kMaxStages = 4;
constexpr int kEpiPitch = 72;       // staged channel row: 64 pixels + 8 (banks)
constexpr int kEpiBytes = 64 * kEpiPitch * 4;
constexpr int kConvStatic = kMaxHaloPix * 4 + 2 * kMaxStages * 8;
constexpr int kConvDynMax = kSmemPerBlock - kConvStatic - 1024;  // 1024: margin

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kTanh = 3 };

// The plain version's epilogue: torch.relu, sigmoid as 1 / (1 + exp(-v)) in
// f32, torch.tanh.
__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return v > 0.0f ? v : 0.0f;
    case kSigmoid: return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
    case kTanh: return tanhf(v);
    default: return v;
  }
}

struct ConvTc {
  const __nv_bfloat16* x;
  const float* bias;
  void* out;
  long sb, sc, sy, sx;  // strides of x in elements
  int Cin, H, W, Cout, kh, kw, pt, pl;
  int chunks;      // channel chunks of 64
  int xtiles;      // column tiles of 64
  int stages;      // weight ring depth
  int halo_bytes;  // one halo buffer (multiple of 1024)
  int act;
  int vec;         // NCHW rows of 16-byte aligned 8-pixel groups (HaloStager)
};

// Byte offset of channel pair cp (channels 2cp, 2cp + 1 of the chunk) of
// halo pixel i: 128 bytes a pixel, 16-byte chunks swizzled by i % 8.
__device__ __forceinline__ int halo_at(int i, int cp) {
  return i * 128 + ((((cp >> 2) ^ i) & 7) << 4) + ((cp & 3) << 2);
}

// Stages halo units [ub, ue) of one channel chunk (channels c0..c0+63) into
// ``h``, one unit per warp at a time, in one of three layouts of x:
// - vec (NCHW, 16-byte aligned rows, W a multiple of 8): a unit is one halo
//   row hy of three channel pairs, u = 11 hy + t (t < 11); lane = 10 q + g
//   loads 8 pixels (16 bytes) of each channel of pair 3t + q at columns
//   x0 - 8 + 8g (the halo's columns lie in [x0 - 8, x0 + 72));
// - pixels along lanes (any other layout whose channels are not the unit
//   stride): a unit is one halo row hy of channel pair cp, u = 32 hy + cp,
//   lane covering columns lane + 32 s;
// - channels along lanes (channel-last): a unit is one halo pixel, lane = cp.
// Loads are branch-free from always-valid addresses (masked afterwards), a
// warp's batch all in flight before its stores.
struct HaloStager {
  const unsigned short* xb;  // x of this image
  long xoff[kSlots];         // per lane: x offset of column slot s (NCHW)
  bool xok[kSlots];
  const int* pix_off;        // per halo pixel: offset in x, or -1 (channel-last)
  bool vec, pix_fast;
  int hcols, units, x0, y0, lane, warp;

  // one batch of the vec layout: units u0 + warp + 8v, v < kUnitBatch, below ue
  struct VecBatch {
    uint4 lo[kUnitBatch], hi[kUnitBatch];
  };
  __device__ __forceinline__ void vec_load(const ConvTc& p, VecBatch& r, int c0, int u0,
                                           int ue) const {
    const int q = lane / 10, g = lane - 10 * q;
    const int xs = x0 - 8 + 8 * g;  // first column of this lane's 8
    const long xo = lane < 30 && xs >= 0 && xs < p.W ? xs : 0;
#pragma unroll
    for (int v = 0; v < kUnitBatch; ++v) {
      const int u = u0 + warp + 8 * v, hy = u / 11, cp = 3 * (u - 11 * hy) + q;
      const int ch = c0 + 2 * cp, y = y0 - p.pt + hy;
      const long yoff = (u < ue && y >= 0 && y < p.H) ? y * p.sy : 0;
      r.lo[v] = __ldg(reinterpret_cast<const uint4*>(xb + min(ch, p.Cin - 1) * p.sc + yoff + xo));
      r.hi[v] = __ldg(reinterpret_cast<const uint4*>(xb + min(ch + 1, p.Cin - 1) * p.sc + yoff + xo));
    }
  }
  __device__ __forceinline__ void vec_store(const ConvTc& p, const VecBatch& r, uint8_t* h, int c0,
                                            int u0, int ue) const {
    const int q = lane / 10, g = lane - 10 * q;
    const int xs = x0 - 8 + 8 * g;
    const bool xin = lane < 30 && xs >= 0 && xs < p.W;
#pragma unroll
    for (int v = 0; v < kUnitBatch; ++v) {
      const int u = u0 + warp + 8 * v, hy = u / 11, cp = 3 * (u - 11 * hy) + q;
      const int ch = c0 + 2 * cp, y = y0 - p.pt + hy;
      if (u >= ue || lane >= 30 || cp >= 32) continue;
      const bool row = xin && y >= 0 && y < p.H;
      const uint32_t m0 = row && ch < p.Cin ? 0xFFFFu : 0u;
      const uint32_t m1 = row && ch + 1 < p.Cin ? 0xFFFF0000u : 0u;
      const uint32_t l[4] = {r.lo[v].x, r.lo[v].y, r.lo[v].z, r.lo[v].w};
      const uint32_t hw[4] = {r.hi[v].x, r.hi[v].y, r.hi[v].z, r.hi[v].w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int hx = 8 * g + e - 8 + p.pl;  // halo column of pixel e
        if (hx >= 0 && hx < hcols) {
          // pixel e: channel ch in the low half, ch + 1 in the high half
          const uint32_t w = __byte_perm(l[e >> 1], hw[e >> 1], (e & 1) ? 0x7632 : 0x5410);
          *reinterpret_cast<uint32_t*>(h + halo_at(hy * hcols + hx, cp)) = w & (m0 | m1);
        }
      }
    }
  }

  __device__ void stage(const ConvTc& p, uint8_t* h, int c0, int ub, int ue) const {
    if (vec) {
      for (int u0 = ub; u0 < ue; u0 += 8 * kUnitBatch) {
        VecBatch r;
        vec_load(p, r, c0, u0, ue);
        vec_store(p, r, h, c0, u0, ue);
      }
    } else if (pix_fast) {
      for (int u0 = ub + warp; u0 < ue; u0 += 8 * kUnitBatch) {
        unsigned short lo[kUnitBatch][kSlots], hi[kUnitBatch][kSlots];
#pragma unroll
        for (int v = 0; v < kUnitBatch; ++v) {
          const int u = u0 + 8 * v, cp = u & 31, hy = u >> 5;
          const int ch = c0 + 2 * cp, y = y0 - p.pt + hy;
          const long yoff = (u < ue && y >= 0 && y < p.H) ? y * p.sy : 0;
          const unsigned short* r0 = xb + min(ch, p.Cin - 1) * p.sc + yoff;
          const unsigned short* r1 = xb + min(ch + 1, p.Cin - 1) * p.sc + yoff;
#pragma unroll
          for (int sl = 0; sl < kSlots; ++sl) {
            lo[v][sl] = __ldg(r0 + xoff[sl]);
            hi[v][sl] = __ldg(r1 + xoff[sl]);
          }
        }
#pragma unroll
        for (int v = 0; v < kUnitBatch; ++v) {
          const int u = u0 + 8 * v, cp = u & 31, hy = u >> 5;
          const int ch = c0 + 2 * cp, y = y0 - p.pt + hy;
          const bool row = u < ue && y >= 0 && y < p.H;
          const bool ok0 = row && ch < p.Cin, ok1 = row && ch + 1 < p.Cin;
#pragma unroll
          for (int sl = 0; sl < kSlots; ++sl) {
            const int hx = lane + 32 * sl;
            if (u < ue && hx < hcols) {
              const uint32_t l = ok0 && xok[sl] ? lo[v][sl] : 0;
              const uint32_t hv = ok1 && xok[sl] ? hi[v][sl] : 0;
              *reinterpret_cast<uint32_t*>(h + halo_at(hy * hcols + hx, cp)) = l | (hv << 16);
            }
          }
        }
      }
    } else {
      const int ch = c0 + 2 * lane;
      const unsigned short* r0 = xb + (long)min(ch, p.Cin - 1) * p.sc;
      const unsigned short* r1 = xb + (long)min(ch + 1, p.Cin - 1) * p.sc;
      constexpr int kPix = kUnitBatch * kSlots;
      for (int i0 = ub + warp; i0 < ue; i0 += 8 * kPix) {
        unsigned short lo[kPix], hi[kPix];
        int off[kPix];
#pragma unroll
        for (int v = 0; v < kPix; ++v) {
          const int i = i0 + 8 * v;
          off[v] = i < ue ? pix_off[i] : -1;
          lo[v] = __ldg(r0 + max(off[v], 0));
          hi[v] = __ldg(r1 + max(off[v], 0));
        }
#pragma unroll
        for (int v = 0; v < kPix; ++v) {
          const int i = i0 + 8 * v;
          if (i < ue) {
            const uint32_t l = off[v] >= 0 && ch < p.Cin ? lo[v] : 0;
            const uint32_t hv = off[v] >= 0 && ch + 1 < p.Cin ? hi[v] : 0;
            *reinterpret_cast<uint32_t*>(h + halo_at(i, lane)) = l | (hv << 16);
          }
        }
      }
    }
  }
};

template <int BN, typename O>
__global__ void __launch_bounds__(kConvThreads, 1)
conv_tc_kernel(__grid_constant__ const CUtensorMap wmap, const ConvTc p) {
  constexpr int NB = BN == 8 ? 1 : BN / 64;  // wgmma per k16 step
  constexpr int NACC = BN == 8 ? 4 : 32;     // accumulators per wgmma
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t w_full[kMaxStages], w_empty[kMaxStages];
  __shared__ int pix_off[kMaxHaloPix];
  uint8_t* smem = align1024(smem_raw);
  const int tid = threadIdx.x;
  const int x0 = ((int)blockIdx.x % p.xtiles) * kTileW;
  const int y0 = ((int)blockIdx.x / p.xtiles) * kTileH;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int taps = p.kh * p.kw;
  const int hcols = kTileW + p.kw - 1;
  const int npix = (kTileH + p.kh - 1) * hcols;
  const int steps = p.chunks * taps;
  uint8_t* halo0 = smem;
  uint8_t* wst = smem + 2 * p.halo_bytes;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&w_full[s], 1);
      mbar_init(&w_empty[s], kConsumerWarps);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // The wide tiles need more than the 168 registers a thread of a
  // 384-thread block starts with: the third warpgroup, which only loads
  // weights, gives 128 of its own back and the consumer warpgroups take them
  // (128 x (168 - 40) = 256 x (232 - 168)).
  constexpr bool kMoreRegs = BN >= 192;
  if (tid >= kConsumers) {
    if constexpr (kMoreRegs) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    // weights: one box of (64 channels, BN outputs) per (chunk, tap)
    if (tid == kConsumers) {
      for (int j = 0; j < steps; ++j) {
        const int s = j % p.stages;
        mbar_wait(&w_empty[s], ((j / p.stages) & 1) ^ 1);
        mbar_expect_tx(&w_full[s], BN * 128);
        const int c = j / taps;
        tma_load_3d(wst + s * BN * 128, &wmap, &w_full[s], c * kKTile, n0, j - c * taps);
      }
    }
    return;
  }

  // consumers: warpgroup wg computes output row y0 + wg, 64 pixels x BN, and
  // all 8 warps stage the next chunk's halo while a tap's wgmma run
  if constexpr (kMoreRegs) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid >> 7;
  const int lane = tid & 31;
  HaloStager st;
  st.xb = reinterpret_cast<const unsigned short*>(p.x) + b * p.sb;
  st.pix_fast = p.sc != 1 || p.sx == 1;
  st.vec = p.vec;
  st.hcols = hcols;
  st.units = st.vec ? 11 * (kTileH + p.kh - 1) : st.pix_fast ? 32 * (kTileH + p.kh - 1) : npix;
  st.x0 = x0;
  st.y0 = y0;
  st.lane = lane;
  st.warp = tid >> 5;
  st.pix_off = pix_off;
#pragma unroll
  for (int sl = 0; sl < kSlots; ++sl) {
    const int hx = lane + 32 * sl, xx = x0 - p.pl + hx;
    st.xok[sl] = hx < hcols && xx >= 0 && xx < p.W;
    st.xoff[sl] = st.xok[sl] ? xx * p.sx : 0;
  }
  if (!st.pix_fast) {
    for (int i = tid; i < npix; i += kConsumers) {
      const int hy = i / hcols, hx = i - hy * hcols;
      const int y = y0 - p.pt + hy, xx = x0 - p.pl + hx;
      pix_off[i] = (y >= 0 && y < p.H && xx >= 0 && xx < p.W) ? (int)(y * p.sy + xx * p.sx) : -1;
    }
    bar_sync(1, kConsumers);
  }
  st.stage(p, halo0, 0, 0, st.units);
  bar_sync(1, kConsumers);

  const int prow = ((tid >> 5) & 3) * 16 + (lane & 15);  // this lane's ldmatrix row
  const int khalf = lane >> 4;                           // k 0-7 or 8-15 of a k16 step
  float acc[NB][NACC];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[nb][i] = 0.0f;

  // Halo units staged per tap. vec: one batch per warp a tap, pipelined by
  // one tap (tap t stores the batch loaded during tap t - 1, then loads the
  // next), so its load latency spans a tap's wgmma; batches beyond the taps
  // are staged at the last tap. Other layouts: the chunk's units spread over
  // its taps, at least one full batch per warp (a tap whose wgmma are short
  // waits one load latency for its share, so light convs stage in few taps).
  const int batch = st.vec || st.pix_fast ? kUnitBatch : kUnitBatch * kSlots;
  const int per = st.vec ? 8 * kUnitBatch : max(8 * batch, (st.units + taps - 1) / taps);
  const int nbatch = (st.units + per - 1) / per;
  HaloStager::VecBatch pend;  // vec: the loaded batch the next tap stores
  if (st.vec && p.chunks > 1) st.vec_load(p, pend, kKTile, 0, min(per, st.units));

  int s = 0, phase = 0;  // weight stage of the step, its barrier phase
  for (int c = 0; c < p.chunks; ++c) {
    const uint32_t hbase = smem_u32(halo0 + (c & 1) * p.halo_bytes);
    uint8_t* hnext = halo0 + ((c + 1) & 1) * p.halo_bytes;
    for (int t = 0, ky = 0, kx = 0; t < taps; ++t) {
      const int pix = (wg + ky) * hcols + prow + kx;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldmatrix_x4(a[kk], hbase + pix * 128 + ((((2 * kk + khalf) ^ pix) & 7) << 4));
      mbar_wait(&w_full[s], phase);
      const uint32_t wbase = smem_u32(wst + s * BN * 128);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_acc(acc[nb]);
      wgmma_fence();
      // B: BN rows of 128 bytes (64 channels), K-major, 8-row groups 1024
      // bytes apart; a k16 step is 32 bytes along the row
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const uint64_t db = sw128_desc(wbase + nb * 64 * 128 + kk * 32, 16, 1024);
          if constexpr (BN == 8)
            wgmma_rs_n8(acc[nb], a[kk], db);
          else
            wgmma_rs_n64(acc[nb], a[kk], db);
        }
      wgmma_commit();
      // while the tensor cores run: this tap's share of the next chunk's halo
      // (its buffer was last read in chunk c - 1, before the barrier below)
      if (st.vec) {
        if (c + 1 < p.chunks && t < nbatch)
          st.vec_store(p, pend, hnext, (c + 1) * kKTile, t * per, min((t + 1) * per, st.units));
        if (t + 1 < taps) {
          if (c + 1 < p.chunks && t + 1 < nbatch)
            st.vec_load(p, pend, (c + 1) * kKTile, (t + 1) * per, min((t + 2) * per, st.units));
        } else {
          if (c + 1 < p.chunks && nbatch > taps)
            st.stage(p, hnext, (c + 1) * kKTile, taps * per, st.units);
          if (c + 2 < p.chunks)
            st.vec_load(p, pend, (c + 2) * kKTile, 0, min(per, st.units));
        }
      } else if (c + 1 < p.chunks && t * per < st.units) {
        st.stage(p, hnext, (c + 1) * kKTile, t * per, min((t + 1) * per, st.units));
      }
      wgmma_wait_all();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) fence_acc(acc[nb]);
      fence_a(a);  // the A registers stay live (unclobbered) until the wait
      __syncwarp();
      if (lane == 0) mbar_arrive(&w_empty[s]);
      if (++s == p.stages) s = 0, phase ^= 1;
      if (++kx == p.kw) kx = 0, ++ky;
    }
    bar_sync(1, kConsumers);  // the next chunk's halo is complete, this one's read
  }

  // epilogue: bias, activation and one cast, staged as [channel][pixel] so
  // that each channel's 64 pixels store as one coalesced row
  O* stage = reinterpret_cast<O*>(smem + wg * kEpiBytes);
  O* out = static_cast<O*>(p.out);
  const int y = y0 + wg;
  constexpr int CH = BN == 8 ? 8 : 64;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int col = acc_col(i);
      const int n = n0 + nb * 64 + col;
      const float bn = n < p.Cout ? p.bias[n] : 0.0f;
      stage[col * kEpiPitch + acc_row(i)] =
          from_f32<O>(activate(__fadd_rn(acc[nb][i], bn), p.act));
    }
    bar_sync(2 + wg, 128);
    for (int e = tid & 127; e < CH * 64; e += 128) {
      const int col = e >> 6, px = e & 63;
      const int n = n0 + nb * 64 + col, xx = x0 + px;
      if (n < p.Cout && xx < p.W && y < p.H)
        out[(((long)b * p.Cout + n) * p.H + y) * p.W + xx] = stage[col * kEpiPitch + px];
    }
    bar_sync(2 + wg, 128);
  }
}

template <int BN, typename O>
cudaError_t launch_conv_tc(const CUtensorMap& wmap, ConvTc p, int B, int nblocks,
                           cudaStream_t stream) {
  // set on the current device at every call: another device may come next
  const cudaError_t allowed = cudaFuncSetAttribute(
      conv_tc_kernel<BN, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, kConvDynMax);
  if (allowed != cudaSuccess) return allowed;
  const int stage = BN * 128;
  const int budget = kConvDynMax - 1024;  // 1024: aligning the base
  const int npix = (kTileH + p.kh - 1) * (kTileW + p.kw - 1);
  p.halo_bytes = (npix * 128 + 1023) / 1024 * 1024;
  p.stages = (budget - 2 * p.halo_bytes) / stage;
  if (p.stages > kMaxStages) p.stages = kMaxStages;
  if (p.stages < 2) return cudaErrorInvalidConfiguration;
  int bytes = 2 * p.halo_bytes + p.stages * stage;
  if (bytes < 2 * kEpiBytes) bytes = 2 * kEpiBytes;
  const int ytiles = (p.H + kTileH - 1) / kTileH;
  const dim3 grid((unsigned)(p.xtiles * ytiles), (unsigned)nblocks, (unsigned)B);
  conv_tc_kernel<BN, O><<<grid, kConvThreads, bytes + 1024, stream>>>(wmap, p);
  return cudaGetLastError();
}

template <typename O>
cudaError_t conv_tc_by_width(const CUtensorMap& wmap, const ConvTc& p, int B, int bn,
                             int nblocks, cudaStream_t stream) {
  switch (bn) {
    case 8: return launch_conv_tc<8, O>(wmap, p, B, nblocks, stream);
    case 64: return launch_conv_tc<64, O>(wmap, p, B, nblocks, stream);
    case 128: return launch_conv_tc<128, O>(wmap, p, B, nblocks, stream);
    case 192: return launch_conv_tc<192, O>(wmap, p, B, nblocks, stream);
    case 256: return launch_conv_tc<256, O>(wmap, p, B, nblocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 features and outputs. f1 is (B, C, Pp) with Pp >= P a multiple of 8
// (zero columns past P); rows p < P of each level are written. Levels beyond
// num_levels are ignored; Q_l must be multiples of 128. Pointers 16-byte
// aligned.
extern "C" int mft_corr_build_folded_tc(const void* f1, const void* f2_0, const void* f2_1,
                                        const void* f2_2, const void* f2_3, void* out0,
                                        void* out1, void* out2, void* out3, int q0, int q1,
                                        int q2, int q3, int num_levels, int B, int C, int P,
                                        int Pp, float scale, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || Pp % 8 || Pp < P || P < 1)
    return (int)cudaErrorInvalidValue;
  // set on the current device at every call: another device may come next
  const cudaError_t allowed = cudaFuncSetAttribute(
      build_folded_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBuildSmem);
  if (allowed != cudaSuccess) return (int)allowed;
  BuildMaps maps;
  BuildLevels lv = {};
  const void* f2[kMaxLevels] = {f2_0, f2_1, f2_2, f2_3};
  void* out[kMaxLevels] = {out0, out1, out2, out3};
  const int q[kMaxLevels] = {q0, q1, q2, q3};
  cudaError_t e = make_map(&maps.f1, f1, Pp, C, B, 64, 64);
  if (e != cudaSuccess) return (int)e;
  lv.num_levels = num_levels;
  lv.tile0[0] = 0;
  for (int l = 0; l < num_levels; ++l) {
    if (q[l] <= 0 || q[l] % 128) return (int)cudaErrorInvalidValue;
    e = make_map(&maps.f2[l], f2[l], q[l], C, B, 64, 64);
    if (e != cudaSuccess) return (int)e;
    lv.out[l] = static_cast<__nv_bfloat16*>(out[l]);
    lv.q[l] = q[l];
    lv.tile0[l + 1] = lv.tile0[l] + q[l] / 128;
  }
  for (int l = num_levels; l < kMaxLevels; ++l) maps.f2[l] = maps.f2[0];
  const dim3 grid((unsigned)lv.tile0[num_levels], (unsigned)((P + 127) / 128), (unsigned)B);
  build_folded_tc_kernel<<<grid, kBuildThreads, kBuildSmem, static_cast<cudaStream_t>(stream)>>>(
      maps, lv, C, P, scale);
  return (int)cudaGetLastError();
}

// bf16 x (strides sb, sc, sy, sx in elements) and weights wt, the wrapper's
// (kh * kw, npad, cpad) reordering of (Cout, Cin, kh, kw), zero-padded: cpad
// a multiple of 64, npad 8 (Cout <= 8) or a multiple of 64. bias float32;
// out contiguous NCHW, out_dtype 0 = float32, 1 = bfloat16. act: 0 none,
// 1 relu, 2 sigmoid, 3 tanh. kh, kw <= 7.
extern "C" int mft_conv_tc(const void* x, const void* wt, const void* bias, void* out, long sb,
                           long sc, long sy, long sx, int B, int Cin, int H, int W, int Cout,
                           int kh, int kw, int pt, int pl, int cpad, int npad, int act,
                           int out_dtype, void* stream) {
  if (act < kNone || act > kTanh || kh < 1 || kw < 1 || kh > kMaxTap || kw > kMaxTap ||
      cpad % kKTile || cpad < Cin || npad < Cout)
    return (int)cudaErrorInvalidValue;
  int bn = 0;
  if (npad == 8) {
    bn = 8;
  } else {
    for (int c = 256; c >= 64 && bn == 0; c -= 64)
      if (npad % c == 0) bn = c;
  }
  if (bn == 0) return (int)cudaErrorInvalidValue;
  CUtensorMap wmap;
  cudaError_t e = make_map(&wmap, wt, cpad, npad, kh * kw, kKTile, bn);
  if (e != cudaSuccess) return (int)e;
  // 16-byte loads of 8 pixels: unit x stride, every row start and W a
  // multiple of 8 elements, x 16-byte aligned
  const int vec = sx == 1 && sb % 8 == 0 && sc % 8 == 0 && sy % 8 == 0 && W % 8 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  ConvTc p{static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(bias), out, sb, sc,
           sy, sx, Cin, H, W, Cout, kh, kw, pt, pl, cpad / kKTile, (W + kTileW - 1) / kTileW,
           0, 0, act, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return (int)conv_tc_by_width<__nv_bfloat16>(wmap, p, B, bn, npad / bn, st);
  if (out_dtype == 0) return (int)conv_tc_by_width<float>(wmap, p, B, bn, npad / bn, st);
  return (int)cudaErrorInvalidValue;
}
