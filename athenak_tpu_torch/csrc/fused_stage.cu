// Kernel C: the split MHD stage, PLM + face floors + Riemann solve in
// x1/x2/x3 and the RK flux-divergence update.
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_stage3d (its x1 kernel
// mk_k1, the x2 _mk_roll_kernel and the x3 _mk_x3_kernel).  From the
// primitives w, the cell-centred field bcc and the face fields it forms,
// per direction, the PLM face states of the 5 + 3 channels, the density
// and internal-energy floors on them, and the Riemann flux (SR HLLE, SR
// LLF or Newtonian HLLD; srmhd.cuh, hlld.cuh), and from the fluxes the
// register acc = gam0*u0 + gam1*u1 - beta_dt * div(F) (u0 is not read
// when gam0 == 0).  It returns acc, the mass flux of each direction (the
// upwind selector of the corner EMFs) and the two face EMFs of each
// direction.  Plain version: ops/stage_split.py::fused_stage3d_plain.
//
// What bounds it on the H100: the function must read w, bcc, the face
// fields, u0 and u1 (21 values a cell) and write acc, the mass fluxes
// and the face EMFs (14 a cell): 35 x 4 bytes a cell, 0.09 ms at 128^3
// in float32 against 3.35 TB/s; its arithmetic (some 1,200 operations a
// cell with the SR solver, divisions and square roots among them) needs
// about 0.04 ms at the float32 peak, so memory binds.  This first design
// is two steps of simple launches, one thread per face or per element,
// each result computed once:
//   1. flux: one launch per direction, one thread per face (k, j, i),
//      the lower face of cell (k, j, i); writes the 5-channel flux to a
//      scratch array of the wrapper, the mass flux and the face EMFs;
//   2. accumulate: one thread per element of acc.
// The scratch flux costs 15 values a cell written and read again, which
// the TPU kernel keeps out of memory by accumulating into the aliased
// register as it goes; fusing the steps is later work.  The stencils
// wrap circularly along each axis, as the plain version's torch.roll
// does, so kernel and plain version agree on every face, ghosts
// included; the TPU kernel's sequential grid, overlapping x3 plane
// windows and aliased register have no counterpart.

#include "common.cuh"
#include "face_flux.cuh"
#include "stencil.cuh"

namespace athenak {
namespace {

struct Coef {
  double gam0, gam1, beta_dt, dx1, dx2, dx3;
};

// One thread per element of acc [nmb, 5, n3, n2, n1]; flx holds the
// three directions back to back (physics/mhd.py rk_update).
template <typename T>
__global__ void accumulate_kernel(Dims g, Coef cf, bool read_u0,
                                  const T* __restrict__ u0,
                                  const T* __restrict__ u1,
                                  const T* __restrict__ flx,
                                  T* __restrict__ acc) {
  const long long o = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long dir = static_cast<long long>(g.nmb) * 5 * g.ncell;
  if (o >= dir) return;
  const int i = o % g.n1;
  const int j = (o / g.n1) % g.n2;
  const int k = (o / (static_cast<long long>(g.n1) * g.n2)) % g.n3;
  const long long plane = static_cast<long long>(g.n2) * g.n1;
  const long long d1 = i + 1 == g.n1 ? 1 - g.n1 : 1;
  const long long d2 =
      j + 1 == g.n2 ? -(g.n2 - 1) * static_cast<long long>(g.n1) : g.n1;
  const long long d3 = k + 1 == g.n3 ? -(g.n3 - 1) * plane : plane;
  const T gam0 = static_cast<T>(cf.gam0), gam1 = static_cast<T>(cf.gam1);
  const T bdt = static_cast<T>(cf.beta_dt);
  T divf = (flx[o + d1] - flx[o]) / static_cast<T>(cf.dx1);
  divf = divf + (flx[dir + o + d2] - flx[dir + o]) / static_cast<T>(cf.dx2);
  divf = divf +
         (flx[2 * dir + o + d3] - flx[2 * dir + o]) / static_cast<T>(cf.dx3);
  const T reg = read_u0 ? gam0 * u0[o] + gam1 * u1[o] : gam1 * u1[o];
  acc[o] = reg - bdt * divf;
}

template <typename T, int SOLVER>
void launch_fluxes(const Dims& g, const Eos<T>& eos, const T* w, const T* bcc,
                   const T* b1, const T* b2, const T* b3, T* flx, T* fden,
                   T* femf, cudaStream_t s) {
  const long long ncell = g.nmb * g.ncell;
  const unsigned int grid = grid_for(ncell);
  // femf is [3 directions][ey, ez][nmb, n3, n2, n1]
  flux_kernel<T, 0, SOLVER><<<grid, kThreads, 0, s>>>(
      g, eos, w, bcc, b1, flx, fden, femf, femf + ncell);
  flux_kernel<T, 1, SOLVER><<<grid, kThreads, 0, s>>>(
      g, eos, w, bcc, b2, flx + 5 * ncell, fden + ncell, femf + 2 * ncell,
      femf + 3 * ncell);
  flux_kernel<T, 2, SOLVER><<<grid, kThreads, 0, s>>>(
      g, eos, w, bcc, b3, flx + 10 * ncell, fden + 2 * ncell,
      femf + 4 * ncell, femf + 5 * ncell);
}

template <typename T>
int launch(const T* w, const T* bcc, const T* b1, const T* b2, const T* b3,
           const T* u0, const T* u1, T* acc, T* flx, T* fden, T* femf,
           int nmb, int n3, int n2, int n1, int solver, Coef cf, Eos<T> eos,
           cudaStream_t s) {
  Dims g{nmb, n3, n2, n1, 2, static_cast<long long>(n3) * n2 * n1};
  switch (solver) {
    case kHlld:
      launch_fluxes<T, kHlld>(g, eos, w, bcc, b1, b2, b3, flx, fden, femf, s);
      break;
    case kSrHlle:
      launch_fluxes<T, kSrHlle>(g, eos, w, bcc, b1, b2, b3, flx, fden, femf,
                                s);
      break;
    case kSrLlf:
      launch_fluxes<T, kSrLlf>(g, eos, w, bcc, b1, b2, b3, flx, fden, femf,
                               s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nel = static_cast<long long>(nmb) * 5 * g.ncell;
  accumulate_kernel<T><<<grid_for(nel), kThreads, 0, s>>>(
      g, cf, cf.gam0 != 0.0, u0, u1, flx, acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

#define ATHENAK_FUSED_STAGE_ENTRY(NAME, T)                                    \
  extern "C" int NAME(const void* w, const void* bcc, const void* b1,         \
                      const void* b2, const void* b3, const void* u0,         \
                      const void* u1, void* acc, void* flx, void* fden,       \
                      void* femf, int nmb, int n3, int n2, int n1,            \
                      int solver, double gam0, double gam1, double beta_dt,   \
                      double dx1, double dx2, double dx3, double gamma,       \
                      double dfloor, double pfloor, void* stream) {           \
    using namespace athenak;                                                  \
    return launch<T>(                                                         \
        static_cast<const T*>(w), static_cast<const T*>(bcc),                 \
        static_cast<const T*>(b1), static_cast<const T*>(b2),                 \
        static_cast<const T*>(b3), static_cast<const T*>(u0),                 \
        static_cast<const T*>(u1), static_cast<T*>(acc),                      \
        static_cast<T*>(flx), static_cast<T*>(fden), static_cast<T*>(femf),   \
        nmb, n3, n2, n1, solver, Coef{gam0, gam1, beta_dt, dx1, dx2, dx3},    \
        make_eos<T>(gamma, dfloor, pfloor, 0.0, 0.0, 1.0),                    \
        static_cast<cudaStream_t>(stream));                                   \
  }

ATHENAK_FUSED_STAGE_ENTRY(athenak_fused_stage_f32, float)
ATHENAK_FUSED_STAGE_ENTRY(athenak_fused_stage_f64, double)
