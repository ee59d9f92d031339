// Kernel F: cell-centred field + cons->prim after a stage, with the
// floor counts and the new-dt maxima.
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_aux3d: from u and the
// ghost-filled face fields, bcc averages the faces (i, i+1) of each axis,
// c2p applies the floor chain (common.cuh, ops/eos.py), and the floor hits
// and max(|v_d| + c_f,d) per direction are reduced over the interior
// cells (per-block partials, one atomic per block and quantity, as in
// kernel A).  Plain version: ops/aux.py::fused_aux3d_plain.
//
// One thread per cell of the whole array, ghosts included.  With wrap
// (a single fully periodic block) a ghost cell reads the interior cell it
// wraps to along every axis (the cell itself when interior), so u, w and
// bcc come out with every ghost filled, the x3 ghost planes of u too.
// The Pallas kernel wraps the in-plane ghosts of u, w and bcc, heals the
// x3 ghost planes of w alone and leaves those of u stale; the two agree
// on everything the Pallas kernel fills.  Without wrap (a pool, whose u
// the pool fill has filled) every cell converts its own state.
//
// Outputs go to fresh buffers: with wrap a ghost thread reads the input
// of the interior cell another thread converts.
//
// What bounds it on the H100: memory, u (5) and the three face arrays in,
// u, w (5 each) and bcc (3) out: 21 values a cell; the c2p is some 40
// operations a cell.

#include "mhd_stage.cuh"

namespace athenak {
namespace {

__device__ __forceinline__ int wrap_src(int p, int n, int ng) {
  return p < ng ? p + (n - 2 * ng) : (p >= n - ng ? p - (n - 2 * ng) : p);
}

template <typename T>
__global__ void aux_kernel(Dims g, Eos<T> eos, bool wrap,
                           const T* __restrict__ u, const T* __restrict__ b1,
                           const T* __restrict__ b2, const T* __restrict__ b3,
                           T* __restrict__ uo, T* __restrict__ wo,
                           T* __restrict__ bcco,
                           unsigned long long* __restrict__ red) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  int fl[3] = {0, 0, 0};
  T dv[3] = {T(0), T(0), T(0)};
  if (idx < g.nmb * g.ncell) {
    const int ng = g.ng;
    const int i = idx % g.n1;
    const int j = (idx / g.n1) % g.n2;
    const int k = (idx / (static_cast<long long>(g.n1) * g.n2)) % g.n3;
    const int m = idx / g.ncell;
    const int si = wrap ? wrap_src(i, g.n1, ng) : i;
    const int sj = wrap ? wrap_src(j, g.n2, ng) : j;
    const int sk = wrap ? wrap_src(k, g.n3, ng) : k;
    const T bx = T(0.5) * (b1[f1idx(g, m, sk, sj, si)] +
                           b1[f1idx(g, m, sk, sj, si + 1)]);
    const T by = T(0.5) * (b2[f2idx(g, m, sk, sj, si)] +
                           b2[f2idx(g, m, sk, sj + 1, si)]);
    const T bz = T(0.5) * (b3[f3idx(g, m, sk, sj, si)] +
                           b3[f3idx(g, m, sk + 1, sj, si)]);
    T uu[5], ww[5], uf[5];
    for (int c = 0; c < 5; ++c) uu[c] = u[cidx(g, m, c, 5, sk, sj, si)];
    int fd, fe, ft;
    c2p(uu, bx, by, bz, eos, ww, uf, fd, fe, ft);
    for (int c = 0; c < 5; ++c) {
      uo[cidx(g, m, c, 5, k, j, i)] = uf[c];
      wo[cidx(g, m, c, 5, k, j, i)] = ww[c];
    }
    bcco[cidx(g, m, 0, 3, k, j, i)] = bx;
    bcco[cidx(g, m, 1, 3, k, j, i)] = by;
    bcco[cidx(g, m, 2, 3, k, j, i)] = bz;
    const bool inside = i >= ng && i < g.n1 - ng && j >= ng &&
                        j < g.n2 - ng && k >= ng && k < g.n3 - ng;
    if (inside) {
      fl[0] = fd;
      fl[1] = fe;
      fl[2] = ft;
      // new-dt signal speeds (physics/mhd.py new_dt)
      const T p = eos.gm1 * ww[4];
      dv[0] = fabs(ww[1]) + fast_speed(eos, ww[0], p, bx, by, bz);
      dv[1] = fabs(ww[2]) + fast_speed(eos, ww[0], p, by, bz, bx);
      dv[2] = fabs(ww[3]) + fast_speed(eos, ww[0], p, bz, bx, by);
    }
  }
  block_reduce(fl, dv, red);
}

template <typename T>
int launch(const T* u, const T* b1, const T* b2, const T* b3, T* uo, T* wo,
           T* bcco, unsigned long long* red, int nmb, int n3, int n2, int n1,
           int ng, int wrap, Eos<T> eos, cudaStream_t s) {
  Dims g{nmb, n3, n2, n1, ng, static_cast<long long>(n3) * n2 * n1};
  const cudaError_t zeroed =
      cudaMemsetAsync(red, 0, 6 * sizeof(unsigned long long), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  aux_kernel<T><<<grid_for(nmb * g.ncell), kThreads, 0, s>>>(
      g, eos, wrap != 0, u, b1, b2, b3, uo, wo, bcco, red);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

#define ATHENAK_AUX_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* u, const void* b1, const void* b2,         \
                      const void* b3, void* uo, void* wo, void* bcco,        \
                      void* red, int nmb, int n3, int n2, int n1, int ng,    \
                      int wrap, double gamma, double dfloor, double pfloor,  \
                      double tfloor, double sfloor, double sigma_max,        \
                      void* stream) {                                        \
    using namespace athenak;                                                 \
    return launch<T>(                                                        \
        static_cast<const T*>(u), static_cast<const T*>(b1),                 \
        static_cast<const T*>(b2), static_cast<const T*>(b3),                \
        static_cast<T*>(uo), static_cast<T*>(wo), static_cast<T*>(bcco),     \
        static_cast<unsigned long long*>(red), nmb, n3, n2, n1, ng, wrap,    \
        make_eos<T>(gamma, dfloor, pfloor, tfloor, sfloor, sigma_max),       \
        static_cast<cudaStream_t>(stream));                                  \
  }

ATHENAK_AUX_ENTRY(athenak_fused_aux_f32, float)
ATHENAK_AUX_ENTRY(athenak_fused_aux_f64, double)
