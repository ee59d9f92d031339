// Kernel D: Gardiner-Stone 2007 corner EMFs and the constrained-transport
// update of the three face fields.
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_ct3d.  From the cell
// velocities and field (w, bcc), the mass fluxes of the three directions
// (upwind selectors) and the six face EMFs it forms the corner EMFs e1,
// e2, e3 at the lower corner edges of every cell; under SR the cell
// velocities u^i are first divided by the Lorentz factor sqrt(1 + u^2)
// (reference: mhd_corner_e.cpp:136-143).  Then
// b' = gam0*b + gam1*b_old -/+ beta_dt * curl(e) on every face.  Plain
// version: ops/stage_split.py::fused_ct3d_plain (physics/mhd.py corner_e
// + ct_update).
//
// What bounds it on the H100: the function must read three velocity
// channels of w, bcc, the three mass fluxes, the six face EMFs and the
// two sets of face fields (21 values a cell) and write the new face
// fields (3): 24 x 4 bytes a cell, 0.06 ms at 128^3 in float32 against
// 3.35 TB/s; its arithmetic (about 100 operations a cell) is far below
// the float32 peak, so memory binds.  Two launches, one thread per edge
// and one per face:
//   1. corner: e1, e2, e3 of the edge (k, j, i) into an edge scratch of
//      the wrapper (3 values a cell written and read again); each thread
//      recomputes the cell EMFs of its four neighbouring cells from w and
//      bcc instead of storing them;
//   2. face: b1, b2, b3 of the face (k, j, i) into fresh output arrays.
// Fresh outputs remove the TPU kernel's overlap hazard on b3 (its plane
// windows overlap and it cannot alias b3, pallas_stage.py:520-525).
// Shifts wrap circularly as the plain version's torch.roll does, and the
// extra face of each normal axis takes the edge difference of index 0,
// as ct_update's _to_face does; those are ghosts, refilled by the fill.

#include "common.cuh"
#include "stencil.cuh"

namespace athenak {
namespace {

// the nine per-direction inputs, each [nmb, n3, n2, n1]
template <typename T>
struct FaceIn {
  const T* fd[3];  // mass flux of x1, x2, x3
  const T *e3x1, *e2x1, *e1x2, *e3x2, *e2x3, *e1x3;
};

template <typename T, bool kSr>
__global__ void corner_kernel(Dims g, const T* __restrict__ w,
                              const T* __restrict__ bcc, FaceIn<T> in,
                              T* __restrict__ edge) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= g.nmb * g.ncell) return;
  const int i = idx % g.n1;
  const int j = (idx / g.n1) % g.n2;
  const int k = (idx / (static_cast<long long>(g.n1) * g.n2)) % g.n3;
  const int m = idx / g.ncell;
  const int km = wrapi(k - 1, g.n3), jm = wrapi(j - 1, g.n2),
            im = wrapi(i - 1, g.n1);

  // cell-centred EMFs E = -v x B of cell (kk, jj, ii): c = 0, 1, 2 for
  // e1cc = vz by - vy bz, e2cc = vx bz - vz bx, e3cc = vy bx - vx by
  auto ecc = [&](int c, int kk, int jj, int ii) {
    T vx = w[cidx(g, m, 1, 5, kk, jj, ii)];
    T vy = w[cidx(g, m, 2, 5, kk, jj, ii)];
    T vz = w[cidx(g, m, 3, 5, kk, jj, ii)];
    if constexpr (kSr) {
      const T lor = sqrt(T(1) + vx * vx + vy * vy + vz * vz);
      vx = vx / lor;
      vy = vy / lor;
      vz = vz / lor;
    }
    const T bx = bcc[cidx(g, m, 0, 3, kk, jj, ii)];
    const T by = bcc[cidx(g, m, 1, 3, kk, jj, ii)];
    const T bz = bcc[cidx(g, m, 2, 3, kk, jj, ii)];
    return c == 0 ? vz * by - vy * bz
                  : (c == 1 ? vx * bz - vz * bx : vy * bx - vx * by);
  };
  auto at = [&](const T* a, int kk, int jj, int ii) {
    return a[cidx(g, m, 0, 1, kk, jj, ii)];
  };
  // E1 along x1: a = x2 (e1x2), b = x3 (e1x3)
  const T e1 = gs07(ecc(0, k, j, i), ecc(0, k, jm, i), ecc(0, km, j, i),
                    ecc(0, km, jm, i), at(in.e1x2, k, j, i),
                    at(in.e1x2, km, j, i), at(in.e1x3, k, j, i),
                    at(in.e1x3, k, jm, i), at(in.fd[1], k, j, i),
                    at(in.fd[1], km, j, i), at(in.fd[2], k, j, i),
                    at(in.fd[2], k, jm, i));
  // E2 along x2: a = x3 (e2x3), b = x1 (e2x1)
  const T e2 = gs07(ecc(1, k, j, i), ecc(1, km, j, i), ecc(1, k, j, im),
                    ecc(1, km, j, im), at(in.e2x3, k, j, i),
                    at(in.e2x3, k, j, im), at(in.e2x1, k, j, i),
                    at(in.e2x1, km, j, i), at(in.fd[2], k, j, i),
                    at(in.fd[2], k, j, im), at(in.fd[0], k, j, i),
                    at(in.fd[0], km, j, i));
  // E3 along x3: a = x1 (e3x1), b = x2 (e3x2)
  const T e3 = gs07(ecc(2, k, j, i), ecc(2, k, j, im), ecc(2, k, jm, i),
                    ecc(2, k, jm, im), at(in.e3x1, k, j, i),
                    at(in.e3x1, k, jm, i), at(in.e3x2, k, j, i),
                    at(in.e3x2, k, j, im), at(in.fd[0], k, j, i),
                    at(in.fd[0], k, jm, i), at(in.fd[1], k, j, i),
                    at(in.fd[1], k, j, im));
  edge[cidx(g, m, 0, 3, k, j, i)] = e1;
  edge[cidx(g, m, 1, 3, k, j, i)] = e2;
  edge[cidx(g, m, 2, 3, k, j, i)] = e3;
}

struct Coef {
  double gam0, gam1, beta_dt, dx1, dx2, dx3;
};

// One thread per (m, k, j, i) in nmb x (n3+1) x (n2+1) x (n1+1); it
// writes each face array that has the index (physics/mhd.py ct_update).
template <typename T>
__global__ void face_kernel(Dims g, Coef cf, const T* __restrict__ edge,
                            const T* __restrict__ b1,
                            const T* __restrict__ b2,
                            const T* __restrict__ b3,
                            const T* __restrict__ b1o,
                            const T* __restrict__ b2o,
                            const T* __restrict__ b3o, T* __restrict__ nb1,
                            T* __restrict__ nb2, T* __restrict__ nb3) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  const int p1 = g.n1 + 1, p2 = g.n2 + 1, p3 = g.n3 + 1;
  if (idx >= static_cast<long long>(g.nmb) * p3 * p2 * p1) return;
  const int i = idx % p1;
  const int j = (idx / p1) % p2;
  const int k = (idx / (static_cast<long long>(p1) * p2)) % p3;
  const int m = idx / (static_cast<long long>(p1) * p2 * p3);
  const T gam0 = static_cast<T>(cf.gam0), gam1 = static_cast<T>(cf.gam1);
  const T bdt = static_cast<T>(cf.beta_dt);
  const T dx1 = static_cast<T>(cf.dx1), dx2 = static_cast<T>(cf.dx2),
          dx3 = static_cast<T>(cf.dx3);
  // edge differences wrap like torch.roll; the extra face takes index 0
  const int ie = i == g.n1 ? 0 : i, je = j == g.n2 ? 0 : j,
            ke = k == g.n3 ? 0 : k;
  auto E = [&](int c, int kk, int jj, int ii) {
    return edge[cidx(g, m, c, 3, kk, jj, ii)];
  };
  if (k < g.n3 && j < g.n2) {
    const long long o = f1idx(g, m, k, j, i);
    T b = gam0 * b1[o] + gam1 * b1o[o];
    b = b - bdt * ((E(2, k, wrapi(j + 1, g.n2), ie) - E(2, k, j, ie)) / dx2);
    b = b + bdt * ((E(1, wrapi(k + 1, g.n3), j, ie) - E(1, k, j, ie)) / dx3);
    nb1[o] = b;
  }
  if (k < g.n3 && i < g.n1) {
    const long long o = f2idx(g, m, k, j, i);
    T b = gam0 * b2[o] + gam1 * b2o[o];
    b = b + bdt * ((E(2, k, je, wrapi(i + 1, g.n1)) - E(2, k, je, i)) / dx1);
    b = b - bdt * ((E(0, wrapi(k + 1, g.n3), je, i) - E(0, k, je, i)) / dx3);
    nb2[o] = b;
  }
  if (j < g.n2 && i < g.n1) {
    const long long o = f3idx(g, m, k, j, i);
    T b = gam0 * b3[o] + gam1 * b3o[o];
    b = b - bdt * ((E(1, ke, j, wrapi(i + 1, g.n1)) - E(1, ke, j, i)) / dx1);
    b = b + bdt * ((E(0, ke, wrapi(j + 1, g.n2), i) - E(0, ke, j, i)) / dx2);
    nb3[o] = b;
  }
}

template <typename T>
int launch(const T* w, const T* bcc, FaceIn<T> in, const T* b1, const T* b2,
           const T* b3, const T* b1o, const T* b2o, const T* b3o, T* nb1,
           T* nb2, T* nb3, T* edge, int nmb, int n3, int n2, int n1,
           bool is_sr, Coef cf, cudaStream_t s) {
  Dims g{nmb, n3, n2, n1, 2, static_cast<long long>(n3) * n2 * n1};
  const unsigned int grid = grid_for(nmb * g.ncell);
  if (is_sr)
    corner_kernel<T, true><<<grid, kThreads, 0, s>>>(g, w, bcc, in, edge);
  else
    corner_kernel<T, false><<<grid, kThreads, 0, s>>>(g, w, bcc, in, edge);
  const long long nface =
      static_cast<long long>(nmb) * (n3 + 1) * (n2 + 1) * (n1 + 1);
  face_kernel<T><<<grid_for(nface), kThreads, 0, s>>>(
      g, cf, edge, b1, b2, b3, b1o, b2o, b3o, nb1, nb2, nb3);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace athenak

#define ATHENAK_FUSED_CT_ENTRY(NAME, T)                                       \
  extern "C" int NAME(                                                        \
      const void* w, const void* bcc, const void* fd1, const void* fd2,       \
      const void* fd3, const void* e3x1, const void* e2x1, const void* e1x2,  \
      const void* e3x2, const void* e2x3, const void* e1x3, const void* b1,   \
      const void* b2, const void* b3, const void* b1o, const void* b2o,       \
      const void* b3o, void* nb1, void* nb2, void* nb3, void* edge, int nmb,  \
      int n3, int n2, int n1, int is_sr, double gam0, double gam1,            \
      double beta_dt, double dx1, double dx2, double dx3, void* stream) {     \
    using namespace athenak;                                                  \
    FaceIn<T> in{{static_cast<const T*>(fd1), static_cast<const T*>(fd2),     \
                  static_cast<const T*>(fd3)},                                \
                 static_cast<const T*>(e3x1), static_cast<const T*>(e2x1),    \
                 static_cast<const T*>(e1x2), static_cast<const T*>(e3x2),    \
                 static_cast<const T*>(e2x3), static_cast<const T*>(e1x3)};   \
    return launch<T>(                                                         \
        static_cast<const T*>(w), static_cast<const T*>(bcc), in,             \
        static_cast<const T*>(b1), static_cast<const T*>(b2),                 \
        static_cast<const T*>(b3), static_cast<const T*>(b1o),                \
        static_cast<const T*>(b2o), static_cast<const T*>(b3o),               \
        static_cast<T*>(nb1), static_cast<T*>(nb2), static_cast<T*>(nb3),     \
        static_cast<T*>(edge), nmb, n3, n2, n1, is_sr != 0,                   \
        Coef{gam0, gam1, beta_dt, dx1, dx2, dx3},                             \
        static_cast<cudaStream_t>(stream));                                   \
  }

ATHENAK_FUSED_CT_ENTRY(athenak_fused_ct_f32, float)
ATHENAK_FUSED_CT_ENTRY(athenak_fused_ct_f64, double)
