// Kernel E: one RK stage of 3-D Newtonian ideal MHD from primitives.
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_mega_stage3d (the v1
// stage): from the ghost-filled primitives w and cell-centred field bcc,
// the face fields bfc, the RK base u0 and the register (u1, bfc_old), PLM
// + face-state floors + HLLD in x1/x2/x3, the flux-divergence update
// gam0*u0 + gam1*u1 - beta_dt*div(F), Gardiner-Stone 2007 corner EMFs and
// constrained transport on the three face fields.  No c2p, no counters,
// no dt: kernel F (fused_aux.cu) does those after the face fill.  Plain
// version: ops/stage_v1.py::fused_mega_stage3d_plain.
//
// It is kernel A (mega_stage_v2.cu) without the in-kernel c2p of either
// side, and shares its flux and edge launches (mhd_stage.cuh):
//   1. flux:   one launch per direction, PLM + floors + HLLD per face;
//   2. edge:   GS07 corner EMFs e1, e2, e3 per edge;
//   3. update: per interior cell, RK update and CT of its six faces;
//              writes u' and the cell's lower faces (plus the upper face
//              on the last interior cell).
// With gam1 == 0 (the first stage of rk2/rk3) u1 and bfc_old are not read,
// as the Pallas kernel's skip_old drops them from its inputs.  The TPU's
// x3 window sweep with clamped, overlapping windows has no counterpart:
// one thread per face, edge or cell computes each value once.
//
// What bounds it on the H100: as kernel A, the HLLD arithmetic and the
// scratch traffic of this first design (fluxes 15, face EMFs 6 and edge
// EMFs 3 values a cell, written and read again); the bound the caller
// reports counts only what a fused stage must move: w, bcc, bfc, u0,
// u1, bfc_old in and u', bfc' out, 32 values a cell (24 with gam1 = 0).
//
// Ghost cells and faces of the outputs are left as they are; the fills
// write them.

#include "mhd_stage.cuh"

namespace athenak {
namespace {

// One thread per interior cell.
template <typename T>
__global__ void update_v1_kernel(Dims g, Coef cf, bool old,
                                 const T* __restrict__ u0,
                                 const T* __restrict__ b1,
                                 const T* __restrict__ b2,
                                 const T* __restrict__ b3,
                                 const T* __restrict__ u1,
                                 const T* __restrict__ b1o,
                                 const T* __restrict__ b2o,
                                 const T* __restrict__ b3o,
                                 const T* __restrict__ flx,
                                 const T* __restrict__ edge,
                                 T* __restrict__ uo, T* __restrict__ b1n,
                                 T* __restrict__ b2n, T* __restrict__ b3n) {
  const int ng = g.ng;
  const int nx1 = g.n1 - 2 * ng, nx2 = g.n2 - 2 * ng, nx3 = g.n3 - 2 * ng;
  const long long nint = static_cast<long long>(nx1) * nx2 * nx3;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= g.nmb * nint) return;
  const int i = idx % nx1 + ng;
  const int j = (idx / nx1) % nx2 + ng;
  const int k = (idx / (static_cast<long long>(nx1) * nx2)) % nx3 + ng;
  const int m = idx / nint;
  T base[5];
  for (int c = 0; c < 5; ++c) base[c] = u0[cidx(g, m, c, 5, k, j, i)];
  T un[5], b1l, b1r, b2l, b2r, b3l, b3r;
  rk_ct_cell(g, cf, old, base, u1, b1, b2, b3, b1o, b2o, b3o, flx, edge, m,
             k, j, i, un, b1l, b1r, b2l, b2r, b3l, b3r);
  for (int c = 0; c < 5; ++c) uo[cidx(g, m, c, 5, k, j, i)] = un[c];
  b1n[f1idx(g, m, k, j, i)] = b1l;
  b2n[f2idx(g, m, k, j, i)] = b2l;
  b3n[f3idx(g, m, k, j, i)] = b3l;
  if (i == g.n1 - ng - 1) b1n[f1idx(g, m, k, j, i + 1)] = b1r;
  if (j == g.n2 - ng - 1) b2n[f2idx(g, m, k, j + 1, i)] = b2r;
  if (k == g.n3 - ng - 1) b3n[f3idx(g, m, k + 1, j, i)] = b3r;
}

template <typename T>
int launch(const T* w, const T* bcc, const T* b1, const T* b2, const T* b3,
           const T* u0, const T* u1, const T* b1o, const T* b2o,
           const T* b3o, T* uo, T* b1n, T* b2n, T* b3n, T* flx, T* femf,
           T* edge, int nmb, int n3, int n2, int n1, int ng, int skip_old,
           Coef cf, Eos<T> eos, cudaStream_t s) {
  Dims g{nmb, n3, n2, n1, ng, static_cast<long long>(n3) * n2 * n1};
  const long long ncell = nmb * g.ncell;
  const long long fdir = ncell * 5, edir = ncell * 2;
  const unsigned int grid = grid_for(ncell);
  flux_kernel<T, 0><<<grid, kThreads, 0, s>>>(g, eos, w, bcc, b1, flx, femf);
  flux_kernel<T, 1><<<grid, kThreads, 0, s>>>(g, eos, w, bcc, b2, flx + fdir,
                                              femf + edir);
  flux_kernel<T, 2><<<grid, kThreads, 0, s>>>(g, eos, w, bcc, b3,
                                              flx + 2 * fdir, femf + 2 * edir);
  edge_kernel<T><<<grid, kThreads, 0, s>>>(g, w, bcc, flx, femf, edge);
  const long long nint = static_cast<long long>(nmb) * (n3 - 2 * ng) *
                         (n2 - 2 * ng) * (n1 - 2 * ng);
  update_v1_kernel<T><<<grid_for(nint), kThreads, 0, s>>>(
      g, cf, skip_old == 0, u0, b1, b2, b3, u1, b1o, b2o, b3o, flx, edge, uo,
      b1n, b2n, b3n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

#define ATHENAK_MEGA_V1_ENTRY(NAME, T)                                        \
  extern "C" int NAME(                                                        \
      const void* w, const void* bcc, const void* b1, const void* b2,         \
      const void* b3, const void* u0, const void* u1, const void* b1o,        \
      const void* b2o, const void* b3o, void* uo, void* b1n, void* b2n,       \
      void* b3n, void* flx, void* femf, void* edge, int nmb, int n3, int n2,  \
      int n1, int ng, int skip_old, double gam0, double gam1, double beta_dt, \
      double dx1, double dx2, double dx3, double gamma, double dfloor,        \
      double pfloor, double tfloor, double sfloor, double sigma_max,          \
      void* stream) {                                                         \
    using namespace athenak;                                                  \
    return launch<T>(                                                         \
        static_cast<const T*>(w), static_cast<const T*>(bcc),                 \
        static_cast<const T*>(b1), static_cast<const T*>(b2),                 \
        static_cast<const T*>(b3), static_cast<const T*>(u0),                 \
        static_cast<const T*>(u1), static_cast<const T*>(b1o),                \
        static_cast<const T*>(b2o), static_cast<const T*>(b3o),               \
        static_cast<T*>(uo), static_cast<T*>(b1n), static_cast<T*>(b2n),      \
        static_cast<T*>(b3n), static_cast<T*>(flx), static_cast<T*>(femf),    \
        static_cast<T*>(edge), nmb, n3, n2, n1, ng, skip_old,                 \
        Coef{gam0, gam1, beta_dt, dx1, dx2, dx3},                             \
        make_eos<T>(gamma, dfloor, pfloor, tfloor, sfloor, sigma_max),        \
        static_cast<cudaStream_t>(stream));                                   \
  }

ATHENAK_MEGA_V1_ENTRY(athenak_mega_stage_v1_f32, float)
ATHENAK_MEGA_V1_ENTRY(athenak_mega_stage_v1_f64, double)
