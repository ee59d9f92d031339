// Kernel B: ghost fill of single fully periodic blocks, in place.
//
// Replaces athenak_tpu/ops/pallas_fill.py::periodic_fill_cc and
// periodic_fill_fc.  One call fills up to three arrays of nmb blocks:
// one cell array [nmb, C, n3, n2, n1], or the face arrays of a face
// field [nmb, n3, n2, n1] with nx + 2 ng + 1 on their normal axis.  Along
// each axis a ghost index p takes the source p + nint when p < ng and
// p - nint when p >= n - ng; nint is the interior extent for cell axes
// and nx for the normal axis of a face array, whose shared boundary face
// is owned once (ghost faces [0, ng) <- [nx, nx + ng), [ng + nx + 1, n)
// <- [ng + 1, 2 ng + 1)).  Applying the map on every axis gives exactly
// what the sequential x1 -> x2 -> x3 sweeps give at edges and corners.
//
// In place, for ghosts only: an element whose indices are all interior
// is never written, and every source has only interior indices, so no
// thread reads what another writes.
//
// What bounds it on the H100: one read and one write of every ghost
// element (9% of a 128^3 array, 2.3 us for 1 x 5 x 128^3 f32 at 3.35
// TB/s), and in practice the launch.  The first design ran one thread an
// element of the whole array (91% of them found themselves interior and
// left after four 64-bit divisions) and one launch a face array.  This
// design numbers the ghosts alone, with kernel G's enumeration
// (pool_fill.cuh, pool_self_item: every block its own neighbour, so no
// donor table), and launches once a call for all channels of all
// blocks, or for every face array of the call:
//   * one item a thread, the neighbouring threads on neighbouring items,
//     one wave of CUDA blocks striding over the items (2, 4 and 8 items
//     a thread with their loads issued together ran slower: the
//     numbering's registers cut the blocks an SM);
//   * pairs of elements (8 bytes in f32, 16 in f64) where the array's runs
//     of ghosts start at even offsets on both sides, else single ones.

#include <cuda_runtime.h>

#include "common.cuh"
#include "pool_fill.cuh"

namespace athenak {
namespace {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    periodic_fill_kernel(PoolCall call, PoolPtrs ptrs) {
  using P2 = typename Pair<T>::type;
  // the call's description in shared memory: the items index its arrays
  // at run time, which parameter space does not take without a copy to
  // local memory
  __shared__ PoolCall p;
  __shared__ PoolPtrs s_ptr;
  if (threadIdx.x == 0) {
    p = call;
    s_ptr = ptrs;
  }
  __syncthreads();
  const int stride = gridDim.x * kThreads;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < p.total;
       t += stride) {
    long long dst, src;
    const int q = pool_self_item(p, t, dst, src);
    T* base = static_cast<T*>(s_ptr.ptr[q]);
    if (p.arr[q].vec == 2)
      *reinterpret_cast<P2*>(base + dst) =
          *reinterpret_cast<const P2*>(base + src);
    else
      base[dst] = base[src];
  }
}

template <typename T>
int launch(const PoolCall& p, const PoolPtrs& ptrs, cudaStream_t s) {
  if (p.total == 0) return 0;
  if (p.total >= (1LL << 31) - (1LL << 24)) return cudaErrorInvalidValue;
  unsigned int grid = 0;
  const cudaError_t err =
      wave_grid(periodic_fill_kernel<T>, kThreads, 0,
                (p.total + kThreads - 1) / kThreads, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  periodic_fill_kernel<T><<<grid, kThreads, 0, s>>>(p, ptrs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

// Array q of narr (1 to 3): ptrs a0, a1, a2 and dims[8 q .. 8 q + 7] =
// nc, n3, n2, n1, nint3, nint2, nint1, unused (pool_call, pool_fill.cuh).
#define ATHENAK_PERIODIC_ENTRY(NAME, T)                                      \
  extern "C" int NAME(void* a0, void* a1, void* a2, int narr,              \
                      const int* dims, int nmb, int ng, void* stream) {     \
    using namespace athenak;                                                 \
    if (narr < 1 || narr > kPoolMaxArrays) return cudaErrorInvalidValue;    \
    const PoolPtrs ptrs{{a0, a1, a2}};                                       \
    return launch<T>(pool_call(narr, dims, nmb, ng, ng, ng, ptrs,           \
                               static_cast<int>(sizeof(T))),                 \
                     ptrs, static_cast<cudaStream_t>(stream));               \
  }

ATHENAK_PERIODIC_ENTRY(athenak_periodic_fill_f32, float)
ATHENAK_PERIODIC_ENTRY(athenak_periodic_fill_f64, double)
