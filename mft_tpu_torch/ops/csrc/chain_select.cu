// MFT chain + select for Hopper (sm_90a): one thread per pixel does the whole step.
//
// Replaces mft_tpu/ops/warp_pallas.py bilinear_warp_blocked (_blocked_kernel) as
// mft_tpu/tracker/fused.py chain_select_pallas uses it, and the element-wise
// chain, argmax and winner pick around it. The TPU sampled all candidates'
// flow (split into bf16 hi/lo), occlusion and sigma as tent-weight matmuls,
// with sample positions snapped to 1/256 px, because the TPU has no fast
// gather. This kernel holds to the exact f32 math of chain_select_ref
// (mft_tpu/tracker/fused.py:150) instead:
//   for each of N candidates: sample the right occlusion and sigma at
//   grid + left flow (bilinear, zeros outside the map); chain them (max of
//   occlusions, NaN if either is NaN; hypot of sigmas); score (occluded or
//   invalid -> -inf, else -sigma); the first maximum wins, and a NaN score
//   counts as the maximum (argmax: the first NaN wins, a NaN best is never
//   replaced). Then sample only the winner's right flow at grid + its left
//   flow (zeros outside that candidate's map), add, and mark endpoints
//   outside the image as occluded.
//
// C clips in one launch: blockIdx.z is the clip, its maps the clip's (N, H, W[, 2])
// slices of (C, N, H, W[, 2]) tensors, its outputs the clip's (H, W[, 2]) slices;
// valid (N,) is shared by every clip (the streaming tracker's clips run in
// lockstep); the single-clip tracker launches it with C = 1. The map index
// clip * N + n and the map size H * W are 32-bit values, widened where they
// form an offset: with 64-bit ones the 4- and 6-candidate instances spilled
// 8 bytes under the 64-register cap.
//
// What bounds it on this card: bytes. Per pixel it needs the left flows,
// occlusions and sigmas (16 B each) and the four-tap neighbourhoods of the
// right occlusion and sigma maps of the valid candidates (an invalid one
// scores -inf whatever its maps hold, and is needed only where it wins),
// the taps of one right flow map, and writes 16 B; no contraction. With all
// 7 candidates valid at 512x512 that is about 54 MB of compulsory traffic,
// ~16 us at 3.35 TB/s. In practice a thread's chain of dependent loads sets
// the time: walking the candidates one after another costs two round trips
// each.
//
// What the design does about it:
// - The candidate count N = 1..8 is a compile-time instance (any larger N
//   takes a generic loop), so the candidate loop unrolls and every load of
//   every candidate is issued before any returns: the left flows,
//   occlusions and sigmas, then the occlusion and sigma taps at each left
//   flow. The loads are branch-free (each tap read at its column and row
//   clamped into the map, and dropped where it lies outside), and sqrtf,
//   which branches to a slow path, comes after them. The selection runs in
//   registers; the winner's left flow is kept, not reloaded. A pixel's
//   loads are three dependent round trips, not 2N + 2.
// - At most 64 registers a thread, four blocks an SM: caps of 128 and 80
//   registers measured 1.16x and 1.06x slower on local flows, and caps of
//   51 or fewer spill and measured 1.2-2x slower.
// - A block is a 32 x 8 tile of pixels, a warp one row of 32: the left maps'
//   reads coalesce, and the warps of neighbouring rows share the lines of
//   their taps (1-D blocks of 256 pixels measured 1.5x slower on uniform
//   flows, 32 x 4 tiles 1.2x).
// - Taps are 4-byte loads. One aligned 16-byte load per tap pair (3 of 4
//   positions hold both) measured 1.2x slower on uniform flows and 1.5x on
//   local ones: each lane then moves 16 bytes through the L1 for 8 it uses.
// - The flow leaves as one 8-byte store a pixel.
// - Every candidate's loads are issued, the invalid ones' too. Skipping
//   them (a warp-uniform branch on valid, or their taps read at the pixel
//   itself) measured up to 1.28x faster on uniform flows with 2 of 7
//   candidates invalid, but 1.07-1.11x slower with all 7 valid, as MFT's
//   are from frame 32 after the start on (the branch with no spills; the
//   select spilled 12 bytes under the 64-register cap). One instance for
//   1..8 candidates with warp-uniform guards measured 1.06x slower than
//   the instance for 7.
//
// The arithmetic is written in the order of the plain PyTorch version
// (ops/chain_select.py) and built with -fmad=false, so results are
// bit-identical to it, and selections never differ at ties or NaN.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;   // a block's pixels: 32 x 8, a warp a row of 32
constexpr int kTileY = 8;

struct Maps {
  const float* lflow;   // (N, H, W, 2)
  const float* locc;    // (N, H, W)
  const float* lsig;
  const float* rflow;
  const float* rocc;
  const float* rsig;
  const uint8_t* valid;   // (N,)
  float thresh;
  int C, N, H, W;
};

// floor, fraction and bilinear weights of a sample position, as
// core/interp.py sample_stacked computes them.
struct Position {
  int x0, y0;
  float w00, w10, w01, w11;
};

__device__ __forceinline__ Position position(float x, float y) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  return Position{(int)x0f, (int)y0f, (1.0f - wx) * (1.0f - wy), wx * (1.0f - wy),
                  (1.0f - wx) * wy, wx * wy};
}

// x clamped to [0, n - 1]: a column or row inside the map.
__device__ __forceinline__ int inside(int x, int n) { return min(max(x, 0), n - 1); }

// x + 1 clamped to [0, n - 1], x + 1 formed only where it cannot overflow.
__device__ __forceinline__ int inside_next(int x, int n) {
  return x < n - 1 ? max(x + 1, 0) : n - 1;
}

// Taps (x0, y) and (x0 + 1, y) of a one-channel map of width W, zero outside
// it: row, row y clamped into the map; ok, y itself is inside. Branch-free,
// so that every candidate's loads issue before any returns: each tap is
// read at its column clamped into the map, and dropped where it lies
// outside. x0 + 1 is formed only where it cannot overflow: (int) of a huge
// position saturates.
__device__ __forceinline__ float2 tap_pair(const float* __restrict__ row, int x0, int W,
                                           bool ok) {
  const bool in0 = ok & (x0 >= 0) & (x0 < W);
  const bool in1 = ok & (x0 >= -1) & (x0 < W - 1);
  const float a = __ldg(row + inside(x0, W));
  const float b = __ldg(row + inside_next(x0, W));
  return make_float2(in0 ? a : 0.0f, in1 ? b : 0.0f);
}

// Taps (x0, y) and (x0 + 1, y) of an interleaved two-channel map, each one
// 8-byte load, clamped as tap_pair's: (x, y) of the first tap, then of the
// second.
__device__ __forceinline__ float4 flow_pair(const float* __restrict__ row, int x0, int W,
                                            bool ok) {
  const bool in0 = ok & (x0 >= 0) & (x0 < W);
  const bool in1 = ok & (x0 >= -1) & (x0 < W - 1);
  const float2* r = reinterpret_cast<const float2*>(row);
  const float2 a = __ldg(r + inside(x0, W));
  const float2 b = __ldg(r + inside_next(x0, W));
  return make_float4(in0 ? a.x : 0.0f, in0 ? a.y : 0.0f, in1 ? b.x : 0.0f, in1 ? b.y : 0.0f);
}

// Bilinear sample of a one-channel (H, W) map, the four taps summed in the
// plain version's order.
__device__ __forceinline__ float sample1(const float* __restrict__ map, const Position& s,
                                         int H, int W) {
  const float* row0 = map + (long)inside(s.y0, H) * W;
  const float* row1 = map + (long)inside_next(s.y0, H) * W;
  const float2 t0 = tap_pair(row0, s.x0, W, (s.y0 >= 0) & (s.y0 < H));
  const float2 t1 = tap_pair(row1, s.x0, W, (s.y0 >= -1) & (s.y0 < H - 1));
  float acc = t0.x * s.w00;
  acc = acc + t0.y * s.w10;
  acc = acc + t1.x * s.w01;
  acc = acc + t1.y * s.w11;
  return acc;
}

// A candidate's loads: its left flow, occlusion and sigma, and its right
// occlusion and sigma sampled at grid + left flow. No branch: every
// candidate's loads can issue before the first returns.
struct Sampled {
  float2 lf;
  float l_occ, l_sig, s_occ, s_sig;
  bool valid;
};

// plane: the candidate's map index in the (C, N) stack, clip * N + n.
__device__ __forceinline__ Sampled gather(const Maps& m, int n, int plane, int HW, long pix,
                                          float gx, float gy) {
  Sampled c;
  c.lf = __ldg(reinterpret_cast<const float2*>(m.lflow) + (long)plane * HW + pix);
  c.l_occ = __ldg(m.locc + (long)plane * HW + pix);
  c.l_sig = __ldg(m.lsig + (long)plane * HW + pix);
  c.valid = __ldg(m.valid + n) != 0;
  const Position s = position(gx + c.lf.x, gy + c.lf.y);
  c.s_occ = sample1(m.rocc + (long)plane * HW, s, m.H, m.W);
  c.s_sig = sample1(m.rsig + (long)plane * HW, s, m.H, m.W);
  return c;
}

// A candidate, chained: its left flow, occlusion and sigma, and its score.
struct Chained {
  float lfx, lfy, occ, sig, score;
};

// sqrtf branches to a slow path for some inputs, so it comes after the loads.
__device__ __forceinline__ Chained chain(const Maps& m, const Sampled& c) {
  // torch.maximum: NaN if either operand is NaN, else the larger
  const float c_occ = (c.l_occ >= c.s_occ || c.l_occ != c.l_occ) ? c.l_occ : c.s_occ;
  const float c_sig = sqrtf(c.l_sig * c.l_sig + c.s_sig * c.s_sig);
  float score = c_occ > m.thresh ? -INFINITY : -c_sig;
  if (!c.valid) score = -INFINITY;
  return Chained{c.lf.x, c.lf.y, c_occ, c_sig, score};
}

// argmax's order: a NaN score beats every number, a NaN best is kept, and
// among numbers the first maximum wins.
__device__ __forceinline__ bool beats(float score, float best) {
  return best == best && (score > best || score != score);
}

// NC: the candidate count, or 0 for a runtime m.N (loop not unrolled);
// blockIdx.z is the clip.
template <int NC>
__global__ void __launch_bounds__(kTileX * kTileY, 4)
chain_select_kernel(Maps m, float* __restrict__ oflow, float* __restrict__ oocc,
                    float* __restrict__ osig) {
  const int px = blockIdx.x * kTileX + threadIdx.x;
  const int py = blockIdx.y * kTileY + threadIdx.y;
  if (px >= m.W || py >= m.H) return;
  const int HW = m.H * m.W;
  const long pix = (long)py * m.W + px;
  const int clip = (int)blockIdx.z * m.N;   // the clip's first map
  const float gx = (float)px;
  const float gy = (float)py;

  int best = 0;
  Chained win{};
  if constexpr (NC > 0) {
    Sampled c[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n) c[n] = gather(m, n, clip + n, HW, pix, gx, gy);
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      const Chained d = chain(m, c[n]);
      if (n == 0 || beats(d.score, win.score)) {
        best = n;
        win = d;
      }
    }
  } else {
#pragma unroll 1
    for (int n = 0; n < m.N; ++n) {
      const Chained d = chain(m, gather(m, n, clip + n, HW, pix, gx, gy));
      if (n == 0 || beats(d.score, win.score)) {
        best = n;
        win = d;
      }
    }
  }

  // the winner's right flow at grid + its left flow
  const Position s = position(gx + win.lfx, gy + win.lfy);
  const float* fmap = m.rflow + 2 * ((long)(clip + best) * HW);
  const float* row0 = fmap + 2 * ((long)inside(s.y0, m.H) * m.W);
  const float* row1 = fmap + 2 * ((long)inside_next(s.y0, m.H) * m.W);
  const float4 t0 = flow_pair(row0, s.x0, m.W, (s.y0 >= 0) & (s.y0 < m.H));
  const float4 t1 = flow_pair(row1, s.x0, m.W, (s.y0 >= -1) & (s.y0 < m.H - 1));
  float sx = t0.x * s.w00;
  sx = sx + t0.z * s.w10;
  sx = sx + t1.x * s.w01;
  sx = sx + t1.z * s.w11;
  float sy = t0.y * s.w00;
  sy = sy + t0.w * s.w10;
  sy = sy + t1.y * s.w01;
  sy = sy + t1.w * s.w11;
  const float fx = win.lfx + sx;
  const float fy = win.lfy + sy;
  const float ex = gx + fx;
  const float ey = gy + fy;
  const bool invalid = (ex < 0.0f) | (ey < 0.0f) | (ex >= (float)m.W) | (ey >= (float)m.H);
  const long out = (long)blockIdx.z * HW + pix;
  reinterpret_cast<float2*>(oflow)[out] = make_float2(fx, fy);
  oocc[out] = invalid ? 1.0f : win.occ;
  osig[out] = win.sig;
}

template <int NC>
cudaError_t launch(const Maps& m, float* oflow, float* oocc, float* osig,
                   cudaStream_t stream) {
  const dim3 grid((unsigned)((m.W + kTileX - 1) / kTileX),
                  (unsigned)((m.H + kTileY - 1) / kTileY), (unsigned)m.C);
  chain_select_kernel<NC><<<grid, dim3(kTileX, kTileY), 0, stream>>>(m, oflow, oocc, osig);
  return cudaGetLastError();
}

}  // namespace

// All maps float32, contiguous: left/right flow (C, N, H, W, 2), occlusion and
// sigma (C, N, H, W); valid (N,) uint8, shared by the C clips. Outputs flow
// (C, H, W, 2), occlusion and sigma (C, H, W). The flows (lflow, rflow, oflow)
// must be 8-byte aligned (then so is every clip's slice).
extern "C" int mft_chain_select(void* oflow, void* oocc, void* osig, const void* lflow,
                                const void* locc, const void* lsig, const void* rflow,
                                const void* rocc, const void* rsig, const void* valid,
                                float thresh, int C, int N, int H, int W, void* stream) {
  const uintptr_t flows = reinterpret_cast<uintptr_t>(oflow) |
                          reinterpret_cast<uintptr_t>(lflow) | reinterpret_cast<uintptr_t>(rflow);
  if (C < 1 || C > 65535 || N < 1 || H < 0 || W < 0 || (H + kTileY - 1) / kTileY > 65535 ||
      (long)H * W > INT32_MAX || (long)C * N > INT32_MAX || (flows & 7) != 0)
    return (int)cudaErrorInvalidValue;
  if ((long)H * W == 0) return (int)cudaSuccess;   // no pixels: nothing to write
  const Maps m{static_cast<const float*>(lflow), static_cast<const float*>(locc),
               static_cast<const float*>(lsig),  static_cast<const float*>(rflow),
               static_cast<const float*>(rocc),  static_cast<const float*>(rsig),
               static_cast<const uint8_t*>(valid), thresh, C, N, H, W};
  float* f = static_cast<float*>(oflow);
  float* o = static_cast<float*>(oocc);
  float* g = static_cast<float*>(osig);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 1: err = launch<1>(m, f, o, g, s); break;
    case 2: err = launch<2>(m, f, o, g, s); break;
    case 3: err = launch<3>(m, f, o, g, s); break;
    case 4: err = launch<4>(m, f, o, g, s); break;
    case 5: err = launch<5>(m, f, o, g, s); break;
    case 6: err = launch<6>(m, f, o, g, s); break;
    case 7: err = launch<7>(m, f, o, g, s); break;
    case 8: err = launch<8>(m, f, o, g, s); break;
    default: err = launch<0>(m, f, o, g, s); break;
  }
  return (int)err;
}
