// Kernel G: ghost fill of a same-level periodic pool of blocks, in place.
//
// Replaces athenak_tpu/ops/pallas_pool_fill.py::pool_fill (its x3 slab
// copy and its x2 and x1 merge sweeps).  The TPU ran three ordered sweeps
// because its DMA cannot slice lane extents that are not multiples of 128;
// here one launch gathers every ghost element directly from its donor.
// On a same-level periodic mesh the ordered sweeps leave in each ghost
// element a copy of one interior element: along every axis a on which the
// element is a ghost, its index p moves to p + nint_a (lower side, d_a =
// -1) or p - nint_a (upper side, d_a = +1), and the block moves to the
// neighbour in direction (d3, d2, d1), nbr27[m][9 (d3+1) + 3 (d2+1) +
// (d1+1)] (ops/pool_fill.py::neighbor27, composed from the face-neighbour
// maps in the sweeps' order).  nint_a is the block's interior extent, or
// nx on the normal axis of a face array, whose shared faces are owned by
// both blocks and not exchanged.  Sources are interior along every axis
// and never written, so the copy is race-free in place and bitwise equal
// to the sweeps.
//
// What bounds it on the H100: one read and one write of every ghost
// element (some 26% of a 68^3 block), 5 us for turb8's u at 3.35 TB/s.
// The first design (one CUDA block a plane, a dependent load of the donor
// id before every 4-byte copy, two copies a thread) was bound by latency
// and ran slower than torch.take of the donors.  This design:
//   * numbers the ghost items of the whole call flatly (pool_fill.cuh)
//     and cuts them into equal chunks, kSlots items a thread, the
//     neighbouring threads on neighbouring items, so a warp reads and
//     writes whole rows; one wave of CUDA blocks strides over the chunks;
//   * copies pairs of elements (8 bytes in f32, 16 in f64) where the
//     array's runs of ghosts start at even offsets on both sides (cell
//     arrays and the x2 and x3 face arrays of even rows), else single
//     elements (the x1 face array's rows of n1 + 1);
//   * stages the rows of the donor table its items need in shared memory
//     once, then issues all kSlots loads of a thread before its stores.
// Up to three arrays in one launch (the three face arrays, or one cell
// array).  An inactive axis has ng 0 on it.

#include <cuda_runtime.h>

#include "common.cuh"
#include "pool_fill.cuh"

namespace athenak {
namespace {

constexpr int kSlots = 8;                      // items a thread
constexpr int kItemsPerBlock = kThreads * kSlots;

// Rows of the donor table a block's items can touch: blocks
// m_lo .. m_lo + span - 1 of the pool.
inline int table_span(const PoolCall& p) {
  const int span = (kItemsPerBlock - 1) / p.per_block + 2;
  return span < p.nmb ? span : p.nmb;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    pool_fill_kernel(PoolCall call, PoolPtrs ptrs,
                     const int* __restrict__ nbr27, int span) {
  using P2 = typename Pair<T>::type;
  // the call's description in shared memory: the items index its arrays
  // at run time, which parameter space does not take without a copy to
  // local memory
  __shared__ PoolCall p;
  __shared__ PoolPtrs s_ptr;
  extern __shared__ int s_nbr[];
  if (threadIdx.x == 0) {
    p = call;
    s_ptr = ptrs;
  }
  __syncthreads();
  // a chunk of kItemsPerBlock items at a time, the grid striding over
  // the chunks (one wave of blocks: no tail of half-empty SMs)
  const int nchunks =
      static_cast<int>((p.total + kItemsPerBlock - 1) / kItemsPerBlock);
  for (int chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    const int first = chunk * kItemsPerBlock;
    const int m_lo = first / p.per_block;
    const int rows = min(span, p.nmb - m_lo);
    __syncthreads();  // the last chunk's readers of s_nbr are done
    for (int e = threadIdx.x; e < rows * 27; e += blockDim.x)
      s_nbr[e] = nbr27[m_lo * 27 + e];
    __syncthreads();

    long long dst[kSlots], src[kSlots];
    int q[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int t = first + s * kThreads + threadIdx.x;
      q[s] = -1;
      if (t < p.total) {
        const GhostItem g = pool_locate(p, t);
        pool_offsets(p, g, s_nbr[(g.m - m_lo) * 27 + pool_dir(g)], dst[s],
                     src[s]);
        q[s] = g.q;
      }
    }
    P2 v[kSlots];
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (q[s] < 0) continue;
      const T* base = static_cast<const T*>(s_ptr.ptr[q[s]]);
      if (p.arr[q[s]].vec == 2)
        v[s] = *reinterpret_cast<const P2*>(base + src[s]);
      else
        v[s].x = base[src[s]];
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      if (q[s] < 0) continue;
      T* base = static_cast<T*>(s_ptr.ptr[q[s]]);
      if (p.arr[q[s]].vec == 2)
        *reinterpret_cast<P2*>(base + dst[s]) = v[s];
      else
        base[dst[s]] = v[s].x;
    }
  }
}

template <typename T>
int launch(const PoolCall& p, const PoolPtrs& ptrs, const int* nbr27,
           cudaStream_t s) {
  if (p.total == 0) return 0;
  if (p.total >= (1LL << 31) - kItemsPerBlock) return cudaErrorInvalidValue;
  const int span = table_span(p);
  const size_t smem = static_cast<size_t>(span) * 27 * sizeof(int);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const long long nchunks = (p.total + kItemsPerBlock - 1) / kItemsPerBlock;
  unsigned int grid = 0;
  const cudaError_t err =
      wave_grid(pool_fill_kernel<T>, kThreads, smem, nchunks, grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  pool_fill_kernel<T><<<grid, kThreads, smem, s>>>(p, ptrs, nbr27, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

// Array q of narr: ptrs[q], and dims[8 q .. 8 q + 7] = nc, n3, n2, n1,
// nint3, nint2, nint1, unused.  nbr27 is a device [nmb, 27] int32 table.
#define ATHENAK_POOL_ENTRY(NAME, T)                                          \
  extern "C" int NAME(void* a0, void* a1, void* a2, int narr,              \
                      const int* dims, const void* nbr27, int nmb, int ng3, \
                      int ng2, int ng1, void* stream) {                     \
    using namespace athenak;                                                 \
    if (narr < 1 || narr > kPoolMaxArrays) return cudaErrorInvalidValue;    \
    const PoolPtrs ptrs{{a0, a1, a2}};                                       \
    return launch<T>(pool_call(narr, dims, nmb, ng3, ng2, ng1, ptrs,        \
                               static_cast<int>(sizeof(T))),                 \
                     ptrs, static_cast<const int*>(nbr27),                   \
                     static_cast<cudaStream_t>(stream));                     \
  }

ATHENAK_POOL_ENTRY(athenak_pool_fill_f32, float)
ATHENAK_POOL_ENTRY(athenak_pool_fill_f64, double)
