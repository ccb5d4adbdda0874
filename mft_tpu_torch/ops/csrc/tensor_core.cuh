// PTX wrappers and layouts shared by the kernels that run wgmma on Hopper
// (sm_90a): product_tc.cu (#5, #13) and corr_lookup.cu (K1 in bfloat16).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator accesses across wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define MFT_D8(o)                                                                        \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),          \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define MFT_D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
                "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
                "%30, %31}"

// The dynamic shared memory rounded up to 1024 bytes (the 128-byte swizzle's
// period), as an offset from the array, so the compiler keeps it in the
// shared space (STS/LDS, not generic stores).
__device__ __forceinline__ uint8_t* align1024(uint8_t* base) {
  return base + ((1024 - (smem_u32(base) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// The accumulator of m64nN: thread t of the warpgroup holds d[i] at row
// 16 * warp + lane / 4 + 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
__device__ __forceinline__ int acc_row(int i) {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int acc_col(int i) {
  return (i >> 2) * 8 + (threadIdx.x & 3) * 2 + (i & 1);
}


}  // namespace
