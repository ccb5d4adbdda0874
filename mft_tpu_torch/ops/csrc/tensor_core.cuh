// PTX wrappers and layouts shared by the kernels that run wgmma on Hopper
// (sm_90a): product_tc.cu (#5, #13), corr_lookup.cu (K1 in bfloat16) and
// corr_alt.cu (K4, K5 in bfloat16).

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

// Byte offset of value (row, k) of a K-major operand of `rows` rows with the
// 32-byte swizzle: K in chunks of 16 values, each chunk rows x 32 bytes
// (8-row groups of 256 bytes), the two 16-byte halves of a row swapped in
// rows 4-7 of each group (16-byte unit ^= bit 7 of the address).
__device__ __forceinline__ uint32_t sw32_offset(int row, int k, int rows) {
  return (uint32_t)((k >> 4) * rows * 32 + row * 32) +
         ((((uint32_t)k << 1) & 16u) ^ (((uint32_t)row << 2) & 16u)) + (((uint32_t)k & 7u) << 1);
}

// wgmma shared-memory descriptor of a K-major operand with the 32-byte
// swizzle: 8-row groups 256 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t sw32_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(256 >> 4) << 32) |
         ((uint64_t)3 << 62);
}

// The dynamic shared memory rounded up to 256 bytes (the 32-byte swizzle's
// period), as an offset from the array.
__device__ __forceinline__ uint8_t* align256(uint8_t* base) {
  return base + ((256 - (smem_u32(base) & 255)) & 255);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
