// Kernel B: ghost fill of a single fully periodic block, in place.
//
// Replaces athenak_tpu/ops/pallas_fill.py::periodic_fill_cc and
// periodic_fill_fc.  The array is [nouter, n3, n2, n1] (nouter = nmb * C
// for cell arrays, nmb for one face array).  Along each axis a ghost
// index p takes the source p + nint when p < ng and p - nint when
// p >= n - ng; nint is the interior extent for cell axes and nx for the
// normal axis of a face array, whose shared boundary face is owned once
// (ghost faces [0, ng) <- [nx, nx + ng), [ng + nx + 1, n) <- [ng + 1,
// 2 ng + 1)).  Applying the map on every axis gives exactly what the
// sequential x1 -> x2 -> x3 sweeps give at edges and corners.
//
// In place, for ghosts only: an element whose indices are all interior
// is never written, and every source has only interior indices, so no
// thread reads what another writes.
//
// What bounds it on the H100: memory traffic of the ghost volume (one
// read and one write per ghost element, some 9% of a 128^3 array).  One
// thread per element of the whole array keeps the index arithmetic
// trivial; the interior threads exit at once.  Launching over the ghost
// shell alone is later work.

#include "common.cuh"

namespace athenak {
namespace {

__device__ __forceinline__ int wrap(int p, int n, int nint, int ng) {
  return p < ng ? p + nint : (p >= n - ng ? p - nint : p);
}

template <typename T>
__global__ void periodic_fill_kernel(T* __restrict__ a, long long nouter,
                                     int n3, int n2, int n1, int nint3,
                                     int nint2, int nint1, int ng) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const long long plane = static_cast<long long>(n2) * n1;
  if (idx >= nouter * n3 * plane) return;
  const int i = idx % n1;
  const int j = (idx / n1) % n2;
  const long long r = idx / plane;
  const int k = r % n3;
  const long long m = r / n3;
  const int si = wrap(i, n1, nint1, ng);
  const int sj = wrap(j, n2, nint2, ng);
  const int sk = wrap(k, n3, nint3, ng);
  if (si == i && sj == j && sk == k) return;
  a[idx] = a[(m * n3 + sk) * plane + static_cast<long long>(sj) * n1 + si];
}

template <typename T>
int launch(void* a, long long nouter, int n3, int n2, int n1, int nint3,
           int nint2, int nint1, int ng, void* stream) {
  const long long total = nouter * n3 * static_cast<long long>(n2) * n1;
  periodic_fill_kernel<T><<<grid_for(total), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(a), nouter, n3, n2, n1, nint3, nint2, nint1, ng);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

extern "C" int athenak_periodic_fill_f32(void* a, long long nouter, int n3,
                                         int n2, int n1, int nint3, int nint2,
                                         int nint1, int ng, void* stream) {
  return athenak::launch<float>(a, nouter, n3, n2, n1, nint3, nint2, nint1,
                                ng, stream);
}

extern "C" int athenak_periodic_fill_f64(void* a, long long nouter, int n3,
                                         int n2, int n1, int nint3, int nint2,
                                         int nint1, int ng, void* stream) {
  return athenak::launch<double>(a, nouter, n3, n2, n1, nint3, nint2, nint1,
                                 ng, stream);
}
