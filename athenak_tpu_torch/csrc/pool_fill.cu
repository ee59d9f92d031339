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
// Up to three arrays in one launch (the three face arrays, or one cell
// array): blockIdx.y picks the array, blockIdx.x one plane (block, channel,
// k) of it; the block's threads walk that plane's ghost elements only: the
// whole plane when k is a ghost plane, else the ghost rows and the ghost
// columns of the interior rows.  An inactive axis has ng 0 on it.
//
// What bounds it on the H100: memory, one read and one write of every
// ghost element (some 26% of a 68^3 block), gathered with short rows.

#include <cuda_runtime.h>

#include "common.cuh"

namespace athenak {
namespace {

constexpr int kMaxArrays = 3;

struct PoolArray {
  void* ptr;
  int nc;                    // channels per block (1 for a face array)
  int n3, n2, n1;
  int nint3, nint2, nint1;   // wrap distance per axis
};

struct PoolArgs {
  PoolArray arr[kMaxArrays];
  int ng3, ng2, ng1;         // ghost width per axis (0 when inactive)
};

__device__ __forceinline__ int side(int p, int n, int ng) {
  return p < ng ? -1 : (p >= n - ng ? 1 : 0);
}

template <typename T>
__global__ void pool_fill_kernel(PoolArgs args, const int* __restrict__ nbr27,
                                 int nmb) {
  const PoolArray a = args.arr[blockIdx.y];
  const long long nplane = static_cast<long long>(nmb) * a.nc * a.n3;
  const long long plane = blockIdx.x;
  if (plane >= nplane) return;
  const int ng3 = args.ng3, ng2 = args.ng2, ng1 = args.ng1;
  const int k = plane % a.n3;
  const int m = plane / (static_cast<long long>(a.n3) * a.nc);
  const int c = (plane / a.n3) % a.nc;
  const int d3 = side(k, a.n3, ng3);
  const long long plane_sz = static_cast<long long>(a.n2) * a.n1;
  const int rows = 2 * ng2 * a.n1;
  const int count = d3 != 0 ? a.n2 * a.n1 : rows + (a.n2 - 2 * ng2) * 2 * ng1;
  T* base = static_cast<T*>(a.ptr);
  const int sk = k - d3 * a.nint3;
  for (int t = threadIdx.x; t < count; t += blockDim.x) {
    int j, i;
    if (d3 != 0) {
      j = t / a.n1;
      i = t % a.n1;
    } else if (t < rows) {
      const int r = t / a.n1;
      j = r < ng2 ? r : a.n2 - 2 * ng2 + r;
      i = t % a.n1;
    } else {
      const int e = t - rows;
      const int col = e % (2 * ng1);
      j = ng2 + e / (2 * ng1);
      i = col < ng1 ? col : a.n1 - 2 * ng1 + col;
    }
    const int d2 = side(j, a.n2, ng2);
    const int d1 = side(i, a.n1, ng1);
    const int donor = nbr27[m * 27 + 9 * (d3 + 1) + 3 * (d2 + 1) + (d1 + 1)];
    const int sj = j - d2 * a.nint2;
    const int si = i - d1 * a.nint1;
    const long long src = ((static_cast<long long>(donor) * a.nc + c) * a.n3 +
                           sk) * plane_sz +
                          static_cast<long long>(sj) * a.n1 + si;
    base[plane * plane_sz + static_cast<long long>(j) * a.n1 + i] = base[src];
  }
}

template <typename T>
int launch(const PoolArgs& args, int narr, const int* nbr27, int nmb,
           cudaStream_t s) {
  long long most = 0;
  for (int q = 0; q < narr; ++q) {
    const long long p =
        static_cast<long long>(nmb) * args.arr[q].nc * args.arr[q].n3;
    most = p > most ? p : most;
  }
  const dim3 grid(static_cast<unsigned int>(most), narr);
  pool_fill_kernel<T><<<grid, kThreads, 0, s>>>(args, nbr27, nmb);
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
    if (narr < 1 || narr > kMaxArrays) return cudaErrorInvalidValue;        \
    PoolArgs args{};                                                         \
    void* ptrs[kMaxArrays] = {a0, a1, a2};                                   \
    for (int q = 0; q < narr; ++q) {                                         \
      const int* d = dims + 8 * q;                                           \
      args.arr[q] = PoolArray{ptrs[q], d[0], d[1], d[2], d[3], d[4], d[5],   \
                              d[6]};                                         \
    }                                                                        \
    args.ng3 = ng3;                                                          \
    args.ng2 = ng2;                                                          \
    args.ng1 = ng1;                                                          \
    return launch<T>(args, narr, static_cast<const int*>(nbr27), nmb,        \
                     static_cast<cudaStream_t>(stream));                     \
  }

ATHENAK_POOL_ENTRY(athenak_pool_fill_f32, float)
ATHENAK_POOL_ENTRY(athenak_pool_fill_f64, double)
