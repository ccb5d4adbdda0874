// MFT chain + select for Hopper (sm_90a): one thread per pixel does the whole step.
//
// Replaces mft_tpu/ops/warp_pallas.py bilinear_warp_blocked (_blocked_kernel) as
// mft_tpu/tracker/fused.py chain_select_pallas uses it, and the element-wise
// chain, argmax and winner pick around it. The TPU sampled all candidates'
// flow (split into bf16 hi/lo), occlusion and sigma as tent-weight matmuls,
// with sample positions snapped to 1/256 px, because the TPU has no fast
// gather. This kernel holds to the exact f32 math of chain_select_ref
// (mft_tpu/tracker/fused.py:148-186) instead:
//   for each of N candidates: sample the right occlusion and sigma at
//   grid + left flow (bilinear, zeros outside the map); chain them (max of
//   occlusions, hypot of sigmas); score (occluded or invalid -> -inf, else
//   -sigma); the first maximum wins. Then sample only the winner's right flow
//   at grid + its left flow (zeros outside that candidate's map), add, and
//   mark endpoints outside the image as occluded.
//
// What bounds it on this card: bytes. Per pixel it reads N left flows,
// occlusions and sigmas (16 B each), the four-tap neighbourhoods of N right
// occlusion and sigma maps and of one right flow map, and writes 16 B; no
// contraction. At N=7, 512x512 that is about 30 MB of compulsory traffic,
// about 9 us at 3.35 TB/s.
//
// What the design does about it: nothing is staged. Neighbouring threads
// are neighbouring pixels, so left-map reads coalesce, and the right-map taps
// of a smooth flow field land in the same L1/L2 lines for a warp. Selection
// happens in registers, so losing candidates' flows are never read.
//
// The arithmetic is written in the order of the plain PyTorch version
// (ops/chain_select.py) and built with -fmad=false, so results are
// bit-identical to it and selections never differ at ties.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// Bilinear zero-padded sample of channel c of a (H, W, C) map.
__device__ __forceinline__ float sample(const float* __restrict__ map, int H, int W,
                                        int C, int c, float x, float y) {
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int x0 = (int)x0f;
  const int y0 = (int)y0f;
  float taps[4];
  const int xs[4] = {x0, x0 + 1, x0, x0 + 1};
  const int ys[4] = {y0, y0, y0 + 1, y0 + 1};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const bool valid = (xs[t] >= 0) & (xs[t] < W) & (ys[t] >= 0) & (ys[t] < H);
    taps[t] = valid ? map[((long)ys[t] * W + xs[t]) * C + c] : 0.0f;
  }
  float acc = taps[0] * ((1.0f - wx) * (1.0f - wy));
  acc = acc + taps[1] * (wx * (1.0f - wy));
  acc = acc + taps[2] * ((1.0f - wx) * wy);
  acc = acc + taps[3] * (wx * wy);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
chain_select_kernel(const float* __restrict__ lflow, const float* __restrict__ locc,
                    const float* __restrict__ lsig, const float* __restrict__ rflow,
                    const float* __restrict__ rocc, const float* __restrict__ rsig,
                    const uint8_t* __restrict__ valid, float thresh, int N, int H,
                    int W, float* __restrict__ oflow, float* __restrict__ oocc,
                    float* __restrict__ osig) {
  const long HW = (long)H * W;
  const long pix = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= HW) return;
  const int py = (int)(pix / W);
  const int px = (int)(pix - (long)py * W);
  const float gx = (float)px;
  const float gy = (float)py;

  int best = 0;
  float best_score = 0.0f, best_occ = 0.0f, best_sig = 0.0f;
  for (int n = 0; n < N; ++n) {
    const long o = n * HW + pix;
    const float sx = gx + lflow[2 * o];
    const float sy = gy + lflow[2 * o + 1];
    const float s_occ = sample(rocc + n * HW, H, W, 1, 0, sx, sy);
    const float s_sig = sample(rsig + n * HW, H, W, 1, 0, sx, sy);
    const float l_occ = locc[o];
    const float l_sig = lsig[o];
    const float c_occ = l_occ >= s_occ ? l_occ : s_occ;
    const float c_sig = sqrtf(l_sig * l_sig + s_sig * s_sig);
    float score = c_occ > thresh ? -INFINITY : -c_sig;
    if (!valid[n]) score = -INFINITY;
    if (n == 0 || score > best_score) {
      best = n;
      best_score = score;
      best_occ = c_occ;
      best_sig = c_sig;
    }
  }

  const long ob = best * HW + pix;
  const float lfx = lflow[2 * ob];
  const float lfy = lflow[2 * ob + 1];
  const float sx = gx + lfx;
  const float sy = gy + lfy;
  const float* rmap = rflow + best * HW * 2;
  const float fx = lfx + sample(rmap, H, W, 2, 0, sx, sy);
  const float fy = lfy + sample(rmap, H, W, 2, 1, sx, sy);
  const float ex = gx + fx;
  const float ey = gy + fy;
  const bool invalid = (ex < 0.0f) | (ey < 0.0f) | (ex >= (float)W) | (ey >= (float)H);
  oflow[2 * pix] = fx;
  oflow[2 * pix + 1] = fy;
  oocc[pix] = invalid ? 1.0f : best_occ;
  osig[pix] = best_sig;
}

}  // namespace

// All maps float32, contiguous: left/right flow (N, H, W, 2), occlusion and
// sigma (N, H, W); valid (N,) uint8. Outputs flow (H, W, 2), occlusion and
// sigma (H, W).
extern "C" int mft_chain_select(void* oflow, void* oocc, void* osig, const void* lflow,
                                const void* locc, const void* lsig, const void* rflow,
                                const void* rocc, const void* rsig, const void* valid,
                                float thresh, int N, int H, int W, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  const long HW = (long)H * W;
  const long blocks = (HW + kThreads - 1) / kThreads;
  chain_select_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lflow), static_cast<const float*>(locc),
      static_cast<const float*>(lsig), static_cast<const float*>(rflow),
      static_cast<const float*>(rocc), static_cast<const float*>(rsig),
      static_cast<const uint8_t*>(valid), thresh, N, H, W, static_cast<float*>(oflow),
      static_cast<float*>(oocc), static_cast<float*>(osig));
  return (int)cudaGetLastError();
}
