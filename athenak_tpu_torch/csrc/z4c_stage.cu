// Entry points of kernel H (the Z4c stage, z4c_rhs.cuh; in vacuum, or with
// the matter source where the stress-energy is given) and kernel I, the
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
// one write a ghost element (1.8 us at 60^3 nghost 2 for the 22 Z4c
// channels in float32 at 3.35 TB/s), and in practice the launch.  The
// first design ran one thread an element of the whole array (the
// interior threads, 76-82% of them, left after 64-bit divisions).  This
// design numbers the ghosts alone (outflow_fill.cuh) in 32-bit, one wave
// of CUDA blocks striding over the items: a ghost row in items of up to
// 16 bytes (one aligned vector access each, its clamped columns read
// one by one), an interior row's ng ghost columns at either end as one
// item of one donor value, written in pairs where aligned.

#include "outflow_fill.cuh"
#include "z4c_stage.cuh"

namespace athenak {
namespace {

template <typename T, bool MAT>
int stage_ng(const Z4cArgs& a, int ng) {
  switch (ng) {
    case 2: return z4c_stage_launch<T, 2, MAT>(a);
    case 3: return z4c_stage_launch<T, 3, MAT>(a);
    case 4: return z4c_stage_launch<T, 4, MAT>(a);
    case 5: return z4c_stage_launch<T, 5, MAT>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the instance with the matter source where mat is given, else vacuum
template <typename T>
int stage(const void* u, const void* u1, const void* sbc, const void* mat,
          void* out, int nmb, int n3, int n2, int n1, int ng,
          const double* prm, const void* bdt, void* stream) {
  const Z4cArgs a{u, u1, sbc, out, mat, nmb, n3, n2, n1, prm, bdt,
                  static_cast<cudaStream_t>(stream)};
  return mat != nullptr ? stage_ng<T, true>(a, ng) : stage_ng<T, false>(a, ng);
}

// vec elements of T as one aligned access
template <typename T, int V>
struct alignas(sizeof(T) * V) Run {
  T e[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
    outflow_fill_kernel(T* __restrict__ a, OutflowCall p) {
  const int stride = gridDim.x * kThreads;
  const int lo = p.ng, hi = p.n1 - p.ng - 1;
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < p.total;
       t += stride) {
    const OutflowItem it = outflow_item(p, t);
    if (it.side) {
      // ng copies of one donor; pairs from an even element on where the
      // array is aligned to pairs (V >= 2: rows of an even length)
      const T v = a[it.row + (it.side == 1 ? lo : hi)];
      int e = 0;
      if constexpr (V >= 2) {
        if (it.dst & 1) a[it.dst + e++] = v;
        for (; e + 1 < p.ng; e += 2)
          *reinterpret_cast<Run<T, 2>*>(a + it.dst + e) = Run<T, 2>{{v, v}};
      }
      for (; e < p.ng; ++e) a[it.dst + e] = v;
    } else if (it.i >= lo && it.i + V - 1 <= hi) {
      *reinterpret_cast<Run<T, V>*>(a + it.dst) =
          *reinterpret_cast<const Run<T, V>*>(a + it.row + it.i);
    } else {
      Run<T, V> v;
#pragma unroll
      for (int e = 0; e < V; ++e)
        v.e[e] = a[it.row + outflow_clamp(it.i + e, lo, hi)];
      *reinterpret_cast<Run<T, V>*>(a + it.dst) = v;
    }
  }
}

template <typename T, int V>
int outflow_launch(T* a, const OutflowCall& p, cudaStream_t s) {
  unsigned int grid = 0;
  const cudaError_t err = wave_grid(outflow_fill_kernel<T, V>, kThreads, 0,
                                    (p.total + kThreads - 1) / kThreads,
                                    grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  outflow_fill_kernel<T, V><<<grid, kThreads, 0, s>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int outflow_fill(void* a, long long nouter, int n3, int n2, int n1, int ng,
                 void* stream) {
  if (ng < 1 || n3 < 2 * ng + 1 || n2 < 2 * ng + 1 || n1 < 2 * ng + 1 ||
      nouter * n3 * n2 * n1 >= (1LL << 31) - (1LL << 24))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = outflow_vec(n1, reinterpret_cast<unsigned long long>(a),
                              static_cast<int>(sizeof(T)));
  const OutflowCall p = outflow_call(static_cast<int>(nouter), n3, n2, n1,
                                     ng, vec);
  T* const arr = static_cast<T*>(a);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    if (vec == 4) return outflow_launch<T, 4>(arr, p, s);
  }
  return vec == 2 ? outflow_launch<T, 2>(arr, p, s)
                  : outflow_launch<T, 1>(arr, p, s);
}

}  // namespace
}  // namespace athenak

#define ATHENAK_Z4C_ENTRIES(SUFFIX, T)                                       \
  extern "C" int athenak_z4c_stage_##SUFFIX(                                 \
      const void* u, const void* u1, const void* sbc, const void* mat,       \
      void* out, int nmb, int n3, int n2, int n1, int ng, const double* prm, \
      const void* bdt, void* stream) {                                       \
    return athenak::stage<T>(u, u1, sbc, mat, out, nmb, n3, n2, n1, ng, prm, \
                             bdt, stream);                                   \
  }                                                                          \
  extern "C" int athenak_z4c_outflow_fill_##SUFFIX(                          \
      void* a, long long nouter, int n3, int n2, int n1, int ng,             \
      void* stream) {                                                        \
    return athenak::outflow_fill<T>(a, nouter, n3, n2, n1, ng, stream);      \
  }

ATHENAK_Z4C_ENTRIES(f32, float)
ATHENAK_Z4C_ENTRIES(f64, double)
