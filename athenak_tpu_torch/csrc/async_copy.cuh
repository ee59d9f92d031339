// Asynchronous copies from device memory into shared memory (cp.async)
// and the index clamp, shared by the kernels that stage their inputs
// ahead of use: A (mega_stage_v2.cu), E (mega_stage_v1.cu), J
// (flux_dir.cu), H (z4c_rhs.cuh) and C (fused_stage.cu).
#pragma once

#include <cuda_runtime.h>

namespace athenak {
namespace {

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N groups (the newest) are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int clampi(int p, int lo, int hi) {
  return p < lo ? lo : (p > hi ? hi : p);
}

}  // namespace
}  // namespace athenak
