// Entry points of kernel H (the Z4c stage, z4c_rhs.cuh) and kernel I, the
// outflow ghost fill that the stage folds in on a single block.
//
// Kernel I replaces the outflow fill folded into
// athenak_tpu/ops/pallas_z4c.py::fused_z4c_stage (its epilogue at
// pallas_z4c.py:533-555 and the x3 slab copies at 598-602).  On a block
// whose six faces are outflow, the sequential x1 -> x2 -> x3 sweeps give
// the ghost cell (k, j, i) the value of the interior cell
// (clamp(k), clamp(j), clamp(i)), each index clamped into the active
// range, so one launch gathers every ghost directly.  In place, ghosts
// only: every source is interior on all axes and is never written, so no
// thread reads what another writes; the copy is bitwise the sweeps'.
// What bounds it: the memory traffic of the ghost shell, one read and
// one write a ghost element; one thread per element of the array, the
// interior threads exit at once.

#include "z4c_stage.cuh"

namespace athenak {
namespace {

template <typename T>
int stage(const void* u, const void* u1, const void* sbc, void* out, int nmb,
          int n3, int n2, int n1, int ng, const double* prm, void* stream) {
  const Z4cArgs a{u, u1, sbc, out, nmb, n3, n2, n1, prm,
                  static_cast<cudaStream_t>(stream)};
  switch (ng) {
    case 2: return z4c_stage_launch<T, 2>(a);
    case 3: return z4c_stage_launch<T, 3>(a);
    case 4: return z4c_stage_launch<T, 4>(a);
    case 5: return z4c_stage_launch<T, 5>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

__device__ __forceinline__ int clampi(int p, int lo, int hi) {
  return p < lo ? lo : (p > hi ? hi : p);
}

template <typename T>
__global__ void outflow_fill_kernel(T* __restrict__ a, long long nouter,
                                    int n3, int n2, int n1, int ng) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long plane = static_cast<long long>(n2) * n1;
  if (idx >= nouter * n3 * plane) return;
  const int i = idx % n1;
  const int j = (idx / n1) % n2;
  const long long r = idx / plane;
  const int k = r % n3;
  const long long m = r / n3;
  const int si = clampi(i, ng, n1 - ng - 1);
  const int sj = clampi(j, ng, n2 - ng - 1);
  const int sk = clampi(k, ng, n3 - ng - 1);
  if (si == i && sj == j && sk == k) return;
  a[idx] = a[(m * n3 + sk) * plane + static_cast<long long>(sj) * n1 + si];
}

template <typename T>
int outflow_fill(void* a, long long nouter, int n3, int n2, int n1, int ng,
                 void* stream) {
  const long long total = nouter * n3 * static_cast<long long>(n2) * n1;
  outflow_fill_kernel<T><<<grid_for(total), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(a), nouter, n3, n2, n1, ng);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

#define ATHENAK_Z4C_ENTRIES(SUFFIX, T)                                       \
  extern "C" int athenak_z4c_stage_##SUFFIX(                                 \
      const void* u, const void* u1, const void* sbc, void* out, int nmb,    \
      int n3, int n2, int n1, int ng, const double* prm, void* stream) {     \
    return athenak::stage<T>(u, u1, sbc, out, nmb, n3, n2, n1, ng, prm,      \
                             stream);                                        \
  }                                                                          \
  extern "C" int athenak_z4c_outflow_fill_##SUFFIX(                          \
      void* a, long long nouter, int n3, int n2, int n1, int ng,             \
      void* stream) {                                                        \
    return athenak::outflow_fill<T>(a, nouter, n3, n2, n1, ng, stream);      \
  }

ATHENAK_Z4C_ENTRIES(f32, float)
ATHENAK_Z4C_ENTRIES(f64, double)
