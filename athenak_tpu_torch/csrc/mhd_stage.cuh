// Helpers shared by the Newtonian MHD stage kernels (kernel A,
// mega_stage_v2.cu; kernel E, mega_stage_v1.cu) and the post-stage
// bcc + c2p kernel (fused_aux.cu, kernel F, which takes max_bits alone):
//
//   Coef:     the RK and CT coefficients, the step read from device
//             memory;
//   max_bits: a positive float as bits that order like it.
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

// RK and CT coefficients, converted to the working type in the kernels.
// beta_dt points at the stage's step in the working type on the card (a
// 0-d tensor), so that a CUDA graph replays the launch on whatever step
// the tensor holds; each thread reads it once.
struct Coef {
  double gam0, gam1;
  const void* beta_dt;
  double dx1, dx2, dx3;
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

}  // namespace
}  // namespace athenak
