// Asynchronous global -> shared copies (cp.async, sm_80 and later), shared
// by the rings of lsh_project.cu and range_rerank.cu.  A copy whose `ok`
// is false reads nothing and fills its destination with zeros, so a ring
// stage past a ragged edge holds zeros, never an earlier stage's data.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cp_async {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, through L2 only (.cg): src and dst 16-byte aligned.
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0));
}

// 16 bytes of which the first `bytes` (0..16) are read and the rest are
// zero-filled (a row's ragged end): src and dst 16-byte aligned.
__device__ __forceinline__ void copy16_part(void* dst, const void* src,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes));
}

// 4 bytes (.ca: .cg takes only 16): src and dst 4-byte aligned.
__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most n of this thread's committed groups are in flight.
template <int n>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n));
}

}  // namespace cp_async
