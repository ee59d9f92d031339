// Helpers shared by the Newtonian MHD stage kernels (kernel A,
// mega_stage_v2.cu; kernel E, mega_stage_v1.cu) and the post-stage
// bcc + c2p kernel (fused_aux.cu, kernel F):
//
//   Coef:         the RK and CT coefficients;
//   max_bits:     a positive float as bits that order like it;
//   block_reduce: per-block floor counts and max(|v| + c_f) per direction,
//                one atomic per block and quantity.
//
// The stage kernels take hlld.cuh and stencil.cuh through this header.
// Everything sits in an unnamed namespace, so each translation unit that
// includes this header gets its own instance of every helper.
#pragma once

#include "common.cuh"
#include "hlld.cuh"
#include "stencil.cuh"

namespace athenak {
namespace {

// RK and CT coefficients, converted to the working type in the kernels
struct Coef {
  double gam0, gam1, beta_dt, dx1, dx2, dx3;
};

template <typename T>
__device__ __forceinline__ unsigned long long max_bits(T x);
template <>
__device__ __forceinline__ unsigned long long max_bits<float>(float x) {
  return static_cast<unsigned long long>(__float_as_uint(x));
}
template <>
__device__ __forceinline__ unsigned long long max_bits<double>(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}

// Called by every thread of a block of kThreads threads: adds the block's
// floor hits fl[0..2] to red[0..2] and raises red[3..5] to the bit
// pattern of the block's max of dv[0..2] (positive floats order like
// their bit patterns).  red is zeroed before the launch.
template <typename T>
__device__ __forceinline__ void block_reduce(const int fl[3], const T dv[3],
                                             unsigned long long* red) {
  __shared__ T smax[3][kThreads / 32];
  const int cnt0 = __syncthreads_count(fl[0]);
  const int cnt1 = __syncthreads_count(fl[1]);
  const int cnt2 = __syncthreads_count(fl[2]);
  for (int c = 0; c < 3; ++c) {
    T v = dv[c];
    for (int off = 16; off > 0; off >>= 1)
      v = tmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0) smax[c][threadIdx.x >> 5] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (cnt0) atomicAdd(&red[0], static_cast<unsigned long long>(cnt0));
    if (cnt1) atomicAdd(&red[1], static_cast<unsigned long long>(cnt1));
    if (cnt2) atomicAdd(&red[2], static_cast<unsigned long long>(cnt2));
    for (int c = 0; c < 3; ++c) {
      T v = smax[c][0];
      for (int wi = 1; wi < (blockDim.x >> 5); ++wi) v = tmax(v, smax[c][wi]);
      atomicMax(&red[3 + c], max_bits<T>(v));
    }
  }
}

}  // namespace
}  // namespace athenak
