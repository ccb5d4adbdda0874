// Dense bilinear warp (gather) for Hopper (sm_90a): one thread per output pixel.
//
// Replaces the three tent-matmul warps of mft_tpu/ops/warp_pallas.py:
// bilinear_warp_pallas (_warp_kernel), bilinear_warp_banded (_banded_kernel)
// and bilinear_warp_tiled (_tiled_kernel), and serves bilinear_warp_blocked's
// entry point too. All of them sample a channel-last (N, H, W, C) map at
// per-pixel (x, y) coordinates, align_corners pixel convention, zeros outside
// the map. The TPU had no fast gather, so it contracted every map row with a
// row of tent weights on the MXU and every column with a row of column
// weights on the VPU. Only two rows and two columns have nonzero weight, so
// this kernel reads those four taps directly.
//
// Two compile-time flags give every mode of the TPU kernels:
//   SNAP  snap each coordinate's fraction to 1/256 px, rounding half to even
//         (jnp.round); then the tent weights are multiples of 2^-8;
//   BF16  round the map taps and the row weights wy to bfloat16 (the MXU's
//         operands); the column weights wx stay float32.
// 'exact' is neither flag (bilinear_warp_pallas with dot_dtype float32 and
// snap False); 'tpu' is both (its defaults, and banded, blocked and tiled).
//
// The arithmetic is the TPU kernels' in the order they sum, and that of the
// plain version (ops/warp.py bilinear_warp_ref); built with -fmad=false, the
// two give the same bits:
//   wy_k = max(0, 1 - |sy - (y0 + k)|), wx_k likewise, y0 = floor(sy)
//   r_x  = wy_0 * m[y0, x] + wy_1 * m[y0 + 1, x]       (the MXU's row sum)
//   out  = wx_0 * r_x0 + wx_1 * r_x1                   (the column sum)
// with taps outside [0, H) x [0, W) contributing zero. The TPU's sums add
// only zeros besides these two terms, which changes no bit.
//
// What bounds it on this card: bytes. Per pixel it reads its coordinates (8 B)
// and four taps of C channels, and writes C float32 values; the maps are read
// about once overall when neighbouring pixels sample neighbouring positions.
// At 7 x 512 x 480 x 6 in bf16 (banded) that is about 76 MB, 0.023 ms at
// 3.35 TB/s; the output is more than half of it.
//
// What the design does about it: it issues few memory instructions per pixel,
// since their count, not the bytes, limited the one-scalar-per-channel form.
// - The channel counts of the entry points (1, 2, 4, 6) are compile-time
//   instances; any other C <= 16 takes a generic instance with a loop over
//   the channels. A compiled C reads each tap's C values as whole words: in
//   units of the largest power of two (at most 16 bytes) that divides a tap's
//   bytes, so every load is aligned (bf16 C = 6: three 4-byte loads a tap,
//   not six 2-byte ones). A tap outside the map is not read; it is zero.
// - Interleaved (x, y) coordinates (the (N, P, 2) tensor of every entry point
//   but the tiled one) are read with one 8-byte load.
// - A channel-last (N, P, C) output, contiguous, is staged per block in
//   shared memory and written as the block's one contiguous span with 16-byte
//   stores (a ragged tail value by value). Any other layout, as the tiled
//   kernel's C planes (already coalesced per plane), is written in place
//   through its strides.
// Neighbouring threads are neighbouring pixels, so the taps of a smooth flow
// fall in the same L1 lines for a warp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 16;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// _snap256: f + round((s - f) * 256) / 256, rounding half to even.
__device__ __forceinline__ float snap256(float s) {
  const float f = floorf(s);
  return f + rintf((s - f) * 256.0f) * (1.0f / 256.0f);
}

// One tap of C channels of MapT, read as `loads` aligned units of `unit`
// bytes into `words` 32-bit words (the last one half-filled for one bf16).
template <typename MapT, int C>
struct Tap {
  static constexpr int bytes = C * (int)sizeof(MapT);
  static constexpr int unit = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
  static constexpr int loads = bytes / unit;
  static constexpr int words = (bytes + 3) / 4;

  __device__ __forceinline__ static void read(const MapT* p, uint32_t (&w)[words]) {
    const char* b = reinterpret_cast<const char*>(p);
#pragma unroll
    for (int k = 0; k < loads; ++k) {
      if constexpr (unit == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(b) + k);
        w[4 * k] = v.x, w[4 * k + 1] = v.y, w[4 * k + 2] = v.z, w[4 * k + 3] = v.w;
      } else if constexpr (unit == 8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(b) + k);
        w[2 * k] = v.x, w[2 * k + 1] = v.y;
      } else if constexpr (unit == 4) {
        w[k] = __ldg(reinterpret_cast<const uint32_t*>(b) + k);
      } else {
        w[k] = __ldg(reinterpret_cast<const unsigned short*>(b) + k);
      }
    }
  }

  // channel c of the tap (little-endian: bf16 value c is half c & 1 of word c / 2)
  __device__ __forceinline__ static float value(const uint32_t (&w)[words], int c) {
    if constexpr (sizeof(MapT) == 4) {
      return __uint_as_float(w[c]);
    } else {
      const uint32_t word = w[c >> 1];
      return __uint_as_float((c & 1) ? (word & 0xffff0000u) : (word << 16));
    }
  }
};

// CC: the channel count as a compile-time constant, or 0 for any C <= 16 (a
// loop over the channels, read one value at a time).
template <typename MapT, int CC, bool SNAP, bool BF16>
__global__ void __launch_bounds__(kThreads)
warp_kernel(const MapT* __restrict__ maps, const float* __restrict__ cx,
            const float* __restrict__ cy, int N, int H, int W, int C_, long P,
            long c_n_stride, long c_p_stride, int xy, float* __restrict__ out,
            long o_n_stride, long o_p_stride, long o_c_stride, int staged) {
  extern __shared__ float stage[];   // kThreads x C outputs, channel-last
  const int C = CC > 0 ? CC : C_;
  const long total = (long)N * P;
  const long i0 = (long)blockIdx.x * kThreads;
  const long i = i0 + threadIdx.x;
  if (i < total) {
    const long n = i / P;
    const long p = i - n * P;
    const long co = n * c_n_stride + p * c_p_stride;
    float sx, sy;
    if (xy) {   // (x, y) interleaved at an 8-byte aligned offset: one load
      const float2 v = __ldg(reinterpret_cast<const float2*>(cx + co));
      sx = v.x;
      sy = v.y;
    } else {
      sx = __ldg(cx + co);
      sy = __ldg(cy + co);
    }
    if (SNAP) {
      sx = snap256(sx);
      sy = snap256(sy);
    }
    const float x0f = floorf(sx);
    const float y0f = floorf(sy);
    float wx[2], wy[2];
    bool in_x[2], in_y[2];
    long xi[2], yi[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float xk = x0f + (float)k;
      const float yk = y0f + (float)k;
      wx[k] = fmaxf(0.0f, 1.0f - fabsf(sx - xk));
      wy[k] = fmaxf(0.0f, 1.0f - fabsf(sy - yk));
      if (BF16) wy[k] = round_bf16(wy[k]);
      in_x[k] = (xk >= 0.0f) & (xk < (float)W);
      in_y[k] = (yk >= 0.0f) & (yk < (float)H);
      xi[k] = in_x[k] ? (long)xk : 0;
      yi[k] = in_y[k] ? (long)yk : 0;
    }
    const MapT* m = maps + n * (long)H * W * C;
    float* o = out + n * o_n_stride + p * o_p_stride;
    float* so = stage + threadIdx.x * C;
    // bf16 taps of a bf16 map are already rounded
    constexpr bool kRound = BF16 && sizeof(MapT) == 4;
    if constexpr (CC > 0) {
      using TapT = Tap<MapT, CC>;
      uint32_t t[2][2][TapT::words];   // [kx][ky]
#pragma unroll
      for (int kx = 0; kx < 2; ++kx)
#pragma unroll
        for (int ky = 0; ky < 2; ++ky) {
          if (in_x[kx] & in_y[ky]) {
            TapT::read(m + (yi[ky] * W + xi[kx]) * CC, t[kx][ky]);
          } else {
#pragma unroll
            for (int q = 0; q < TapT::words; ++q) t[kx][ky][q] = 0u;
          }
        }
      float res[CC];
#pragma unroll
      for (int c = 0; c < CC; ++c) {
        float r[2];
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          float v0 = TapT::value(t[kx][0], c), v1 = TapT::value(t[kx][1], c);
          if (kRound) {
            v0 = round_bf16(v0);
            v1 = round_bf16(v1);
          }
          r[kx] = wy[0] * v0 + wy[1] * v1;
        }
        res[c] = wx[0] * r[0] + wx[1] * r[1];
      }
      if (staged) {
#pragma unroll
        for (int c = 0; c < CC; c += CC % 4 == 0 ? 4 : CC % 2 == 0 ? 2 : 1) {
          if constexpr (CC % 4 == 0)
            *reinterpret_cast<float4*>(so + c) = make_float4(res[c], res[c + 1], res[c + 2], res[c + 3]);
          else if constexpr (CC % 2 == 0)
            *reinterpret_cast<float2*>(so + c) = make_float2(res[c], res[c + 1]);
          else
            so[c] = res[c];
        }
      } else {
#pragma unroll
        for (int c = 0; c < CC; ++c) o[c * o_c_stride] = res[c];
      }
    } else {
      for (int c = 0; c < C; ++c) {
        float r[2];
#pragma unroll
        for (int kx = 0; kx < 2; ++kx) {
          float tv[2];
#pragma unroll
          for (int ky = 0; ky < 2; ++ky) {
            float v = 0.0f;
            if (in_x[kx] & in_y[ky]) v = load(m + (yi[ky] * W + xi[kx]) * C + c);
            if (kRound) v = round_bf16(v);
            tv[ky] = wy[ky] * v;
          }
          r[kx] = tv[0] + tv[1];
        }
        const float v = wx[0] * r[0] + wx[1] * r[1];
        if (staged)
          so[c] = v;
        else
          o[c * o_c_stride] = v;
      }
    }
  }
  if (staged) {
    // the block's pixels are one contiguous span of the output, starting
    // 16-byte aligned (kThreads * C * 4 bytes per block)
    __syncthreads();
    const long rest = total - i0;
    const int values = (rest < kThreads ? (int)rest : kThreads) * C;
    float* dst = out + i0 * C;
    const int vecs = values / 4;
    for (int v = threadIdx.x; v < vecs; v += kThreads)
      reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(stage)[v];
    for (int e = 4 * vecs + threadIdx.x; e < values; e += kThreads) dst[e] = stage[e];
  }
}

struct Args {
  const void* maps;
  const float *cx, *cy;
  int N, H, W, C;
  int aligned;  // maps 16-byte aligned
  long P, c_n_stride, c_p_stride;
  int xy;
  float* out;
  long o_n_stride, o_p_stride, o_c_stride;
  int staged;
};

template <typename MapT, int CC, bool SNAP, bool BF16>
int launch(const Args& a, cudaStream_t stream) {
  const long total = (long)a.N * a.P;
  const long blocks = (total + kThreads - 1) / kThreads;
  const size_t smem = a.staged ? sizeof(float) * kThreads * a.C : 0;
  warp_kernel<MapT, CC, SNAP, BF16><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const MapT*>(a.maps), a.cx, a.cy, a.N, a.H, a.W, a.C, a.P, a.c_n_stride,
      a.c_p_stride, a.xy, a.out, a.o_n_stride, a.o_p_stride, a.o_c_stride, a.staged);
  return (int)cudaGetLastError();
}

template <typename MapT, bool SNAP, bool BF16>
int by_channels(const Args& a, cudaStream_t stream) {
  switch (a.aligned ? a.C : 0) {
    case 1: return launch<MapT, 1, SNAP, BF16>(a, stream);
    case 2: return launch<MapT, 2, SNAP, BF16>(a, stream);
    case 4: return launch<MapT, 4, SNAP, BF16>(a, stream);
    case 6: return launch<MapT, 6, SNAP, BF16>(a, stream);
    default: return launch<MapT, 0, SNAP, BF16>(a, stream);
  }
}

template <typename MapT>
int by_mode(int snap, int bf16, const Args& a, cudaStream_t stream) {
  if (snap && bf16) return by_channels<MapT, true, true>(a, stream);
  if (snap) return by_channels<MapT, true, false>(a, stream);
  if (bf16) return by_channels<MapT, false, true>(a, stream);
  return by_channels<MapT, false, false>(a, stream);
}

}  // namespace

// maps (N, H, W, C) contiguous, float32 (map_bf16 0) or bfloat16 (1); maps
// that do not start 16-byte aligned take the generic instance. Coordinates:
// x of pixel p of image n at cx[n * c_n_stride + p * c_p_stride], y at the
// same offset from cy (float32; strides in elements, 0 broadcasts). Output float32: channel c of pixel p of image n at
// out[n * o_n_stride + p * o_p_stride + c * o_c_stride].
extern "C" int mft_warp(void* out, const void* maps, const void* cx, const void* cy,
                        int N, int H, int W, int C, long P, long c_n_stride,
                        long c_p_stride, long o_n_stride, long o_p_stride,
                        long o_c_stride, int map_bf16, int snap, int bf16,
                        void* stream) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || C > kMaxChannels || P < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.maps = maps;
  a.cx = static_cast<const float*>(cx);
  a.cy = static_cast<const float*>(cy);
  a.N = N, a.H = H, a.W = W, a.C = C;
  // the compiled channel counts read whole aligned units of a tap
  a.aligned = (reinterpret_cast<uintptr_t>(maps) & 15) == 0;
  a.P = P, a.c_n_stride = c_n_stride, a.c_p_stride = c_p_stride;
  // (x, y) pairs: y right after x, every pair 8-byte aligned
  a.xy = a.cy == a.cx + 1 && c_p_stride == 2 && c_n_stride % 2 == 0 &&
         (reinterpret_cast<uintptr_t>(cx) & 7) == 0;
  a.out = static_cast<float*>(out);
  a.o_n_stride = o_n_stride, a.o_p_stride = o_p_stride, a.o_c_stride = o_c_stride;
  // a contiguous channel-last (N, P, C) output from a 16-byte aligned base
  a.staged = o_c_stride == 1 && o_p_stride == C && o_n_stride == P * C &&
             (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map_bf16) return by_mode<__nv_bfloat16>(snap, bf16, a, s);
  return by_mode<float>(snap, bf16, a, s);
}
