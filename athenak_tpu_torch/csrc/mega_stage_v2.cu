// Kernel A: one RK stage of 3-D Newtonian ideal MHD from (u, bfc).
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_mega_stage3d_v2: bcc
// from the face fields, c2p with the floors (the floored u is the RK
// base), PLM + face-state floors + HLLD in x1/x2/x3, the flux-divergence
// update gam0*u + gam1*u1 - beta_dt*div(F), Gardiner-Stone 2007 corner
// EMFs, constrained transport on the three face fields, output c2p with
// the floors, the floor counts and max(|v| + c_f) per direction over the
// interior cells.  Plain version: ops/stage.py::mega_stage_v2_plain.
//
// What bounds it on the H100: the HLLD body is long and select-heavy
// arithmetic (some 250 flops and a dozen divisions and square roots per
// face), and this first design moves its intermediates through device
// memory: w and bcc (8 values a cell), three flux arrays (5 a face), the
// face EMFs (2 a face) and the edge EMFs (3 an edge), roughly 40 values
// a cell written and read again each stage.  The design is a chain of
// simple launches, one thread per cell, face or edge, so that each
// result is computed exactly once and no thread depends on another's
// order:
//   1. prim:   bcc + c2p on every cell            -> w, bcc
//   2. flux:   one launch per direction, PLM + floors + HLLD per face
//   3. edge:   GS07 corner EMFs e1, e2, e3 per edge
//   4. update: per interior cell, RK update, CT of its six faces, bcc +
//              c2p of the new state, u' and the cell's lower faces (plus
//              the upper face on the last interior cell), and per-block
//              partial floor counts and dt maxima reduced with atomics
//              (integer add; max on the bit pattern of the positive
//              float).
// The TPU's clamped last window, the double b3 write and the VMEM tile
// budget have no counterpart here.  Fusing the chain into one pass with
// shared-memory tiles is later work.
//
// Ghost cells and faces of the outputs are left as they are; the fill
// kernel (periodic_fill.cu) or the general sweep fill writes them.

#include "mhd_stage.cuh"

namespace athenak {
namespace {

// ---------------------------------------------------------------- step 1
template <typename T>
__global__ void prim_kernel(Dims g, Eos<T> eos, const T* __restrict__ u,
                            const T* __restrict__ b1, const T* __restrict__ b2,
                            const T* __restrict__ b3, T* __restrict__ w,
                            T* __restrict__ bcc) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= g.nmb * g.ncell) return;
  const int i = idx % g.n1;
  const int j = (idx / g.n1) % g.n2;
  const int k = (idx / (static_cast<long long>(g.n1) * g.n2)) % g.n3;
  const int m = idx / g.ncell;
  const T bx = T(0.5) * (b1[f1idx(g, m, k, j, i)] + b1[f1idx(g, m, k, j, i + 1)]);
  const T by = T(0.5) * (b2[f2idx(g, m, k, j, i)] + b2[f2idx(g, m, k, j + 1, i)]);
  const T bz = T(0.5) * (b3[f3idx(g, m, k, j, i)] + b3[f3idx(g, m, k + 1, j, i)]);
  T uu[5], ww[5], uf[5];
  for (int c = 0; c < 5; ++c) uu[c] = u[cidx(g, m, c, 5, k, j, i)];
  int fd, fe, ft;
  c2p(uu, bx, by, bz, eos, ww, uf, fd, fe, ft);
  for (int c = 0; c < 5; ++c) w[cidx(g, m, c, 5, k, j, i)] = ww[c];
  bcc[cidx(g, m, 0, 3, k, j, i)] = bx;
  bcc[cidx(g, m, 1, 3, k, j, i)] = by;
  bcc[cidx(g, m, 2, 3, k, j, i)] = bz;
}

// Steps 2 and 3, flux_kernel and edge_kernel, live in mhd_stage.cuh.

// ---------------------------------------------------------------- step 4
// One thread per interior cell.  red[0..2] collect the floor counts,
// red[3..5] the bit patterns of max(|v| + c_f) per direction.
template <typename T>
__global__ void update_kernel(Dims g, Eos<T> eos, Coef cf,
                              const T* __restrict__ u,
                              const T* __restrict__ b1,
                              const T* __restrict__ b2,
                              const T* __restrict__ b3,
                              const T* __restrict__ u1,
                              const T* __restrict__ b1o,
                              const T* __restrict__ b2o,
                              const T* __restrict__ b3o,
                              const T* __restrict__ bcc,
                              const T* __restrict__ flx,
                              const T* __restrict__ edge, T* __restrict__ uo,
                              T* __restrict__ b1n, T* __restrict__ b2n,
                              T* __restrict__ b3n,
                              unsigned long long* __restrict__ red) {
  const int ng = g.ng;
  const int nx1 = g.n1 - 2 * ng, nx2 = g.n2 - 2 * ng, nx3 = g.n3 - 2 * ng;
  const long long nint = static_cast<long long>(nx1) * nx2 * nx3;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const bool active = idx < g.nmb * nint;
  int fl[3] = {0, 0, 0};
  T dv[3] = {T(0), T(0), T(0)};
  if (active) {
    const int i = idx % nx1 + ng;
    const int j = (idx / nx1) % nx2 + ng;
    const int k = (idx / (static_cast<long long>(nx1) * nx2)) % nx3 + ng;
    const int m = idx / nint;
    // RK base: the input state with the c2p floors applied
    T uu[5], ww[5], u0[5];
    for (int c = 0; c < 5; ++c) uu[c] = u[cidx(g, m, c, 5, k, j, i)];
    int d0, d1, d2;
    c2p(uu, bcc[cidx(g, m, 0, 3, k, j, i)], bcc[cidx(g, m, 1, 3, k, j, i)],
        bcc[cidx(g, m, 2, 3, k, j, i)], eos, ww, u0, d0, d1, d2);

    T un[5], b1l, b1r, b2l, b2r, b3l, b3r;
    rk_ct_cell(g, cf, true, u0, u1, b1, b2, b3, b1o, b2o, b3o, flx, edge, m,
               k, j, i, un, b1l, b1r, b2l, b2r, b3l, b3r);

    // output bcc + c2p with the floors
    const T bx = T(0.5) * (b1l + b1r);
    const T by = T(0.5) * (b2l + b2r);
    const T bz = T(0.5) * (b3l + b3r);
    T wn[5], uf[5];
    c2p(un, bx, by, bz, eos, wn, uf, fl[0], fl[1], fl[2]);
    for (int c = 0; c < 5; ++c) uo[cidx(g, m, c, 5, k, j, i)] = uf[c];
    b1n[f1idx(g, m, k, j, i)] = b1l;
    b2n[f2idx(g, m, k, j, i)] = b2l;
    b3n[f3idx(g, m, k, j, i)] = b3l;
    if (i == g.n1 - ng - 1) b1n[f1idx(g, m, k, j, i + 1)] = b1r;
    if (j == g.n2 - ng - 1) b2n[f2idx(g, m, k, j + 1, i)] = b2r;
    if (k == g.n3 - ng - 1) b3n[f3idx(g, m, k + 1, j, i)] = b3r;

    // new-dt signal speeds (physics/mhd.py new_dt)
    const T p = eos.gm1 * wn[4];
    dv[0] = fabs(wn[1]) + fast_speed(eos, wn[0], p, bx, by, bz);
    dv[1] = fabs(wn[2]) + fast_speed(eos, wn[0], p, by, bz, bx);
    dv[2] = fabs(wn[3]) + fast_speed(eos, wn[0], p, bz, bx, by);
  }

  // per-block partials, then one atomic per block and quantity
  block_reduce(fl, dv, red);
}

template <typename T>
int launch(const T* u, const T* b1, const T* b2, const T* b3, const T* u1,
           const T* b1o, const T* b2o, const T* b3o, T* uo, T* b1n, T* b2n,
           T* b3n, T* w, T* bcc, T* flx, T* femf, T* edge,
           unsigned long long* red, int nmb, int n3, int n2, int n1, int ng,
           Coef cf, Eos<T> eos, cudaStream_t s) {
  Dims g{nmb, n3, n2, n1, ng, static_cast<long long>(n3) * n2 * n1};
  const long long ncell = nmb * g.ncell;
  const long long fdir = ncell * 5, edir = ncell * 2;
  const unsigned int grid = grid_for(ncell);
  const cudaError_t zeroed =
      cudaMemsetAsync(red, 0, 6 * sizeof(unsigned long long), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  prim_kernel<T><<<grid, kThreads, 0, s>>>(g, eos, u, b1, b2, b3, w, bcc);
  flux_kernel<T, 0><<<grid, kThreads, 0, s>>>(g, eos, w, bcc, b1, flx, femf);
  flux_kernel<T, 1><<<grid, kThreads, 0, s>>>(g, eos, w, bcc, b2, flx + fdir,
                                              femf + edir);
  flux_kernel<T, 2><<<grid, kThreads, 0, s>>>(g, eos, w, bcc, b3,
                                              flx + 2 * fdir, femf + 2 * edir);
  edge_kernel<T><<<grid, kThreads, 0, s>>>(g, w, bcc, flx, femf, edge);
  const long long nint = static_cast<long long>(nmb) * (n3 - 2 * ng) *
                         (n2 - 2 * ng) * (n1 - 2 * ng);
  update_kernel<T><<<grid_for(nint), kThreads, 0, s>>>(
      g, eos, cf, u, b1, b2, b3, u1, b1o, b2o, b3o, bcc, flx, edge, uo, b1n,
      b2n, b3n, red);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

#define ATHENAK_MEGA_ENTRY(NAME, T)                                          \
  extern "C" int NAME(                                                       \
      const void* u, const void* b1, const void* b2, const void* b3,         \
      const void* u1, const void* b1o, const void* b2o, const void* b3o,     \
      void* uo, void* b1n, void* b2n, void* b3n, void* w, void* bcc,         \
      void* flx, void* femf, void* edge, void* red, int nmb, int n3, int n2, \
      int n1, int ng, double gam0, double gam1, double beta_dt, double dx1,  \
      double dx2, double dx3, double gamma, double dfloor, double pfloor,    \
      double tfloor, double sfloor, double sigma_max, void* stream) {        \
    using namespace athenak;                                                 \
    return launch<T>(                                                        \
        static_cast<const T*>(u), static_cast<const T*>(b1),                 \
        static_cast<const T*>(b2), static_cast<const T*>(b3),                \
        static_cast<const T*>(u1), static_cast<const T*>(b1o),               \
        static_cast<const T*>(b2o), static_cast<const T*>(b3o),              \
        static_cast<T*>(uo), static_cast<T*>(b1n), static_cast<T*>(b2n),     \
        static_cast<T*>(b3n), static_cast<T*>(w), static_cast<T*>(bcc),      \
        static_cast<T*>(flx), static_cast<T*>(femf), static_cast<T*>(edge),  \
        static_cast<unsigned long long*>(red), nmb, n3, n2, n1, ng,          \
        Coef{gam0, gam1, beta_dt, dx1, dx2, dx3},                            \
        make_eos<T>(gamma, dfloor, pfloor, tfloor, sfloor, sigma_max),       \
        static_cast<cudaStream_t>(stream));                                  \
  }

ATHENAK_MEGA_ENTRY(athenak_mega_stage_v2_f32, float)
ATHENAK_MEGA_ENTRY(athenak_mega_stage_v2_f64, double)
