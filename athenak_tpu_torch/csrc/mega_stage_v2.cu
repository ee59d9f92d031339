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

#include "common.cuh"
#include "hlld.cuh"
#include "stencil.cuh"

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

// ---------------------------------------------------------------- step 2
// DIR 0/1/2 = x1/x2/x3.  One thread per face f along DIR with f in
// [2, n - 2] (the PLM stencil reaches cells f-2..f+1) and every
// transverse cell.  Writes the flux [5] and the face EMFs (ey, ez) at
// the cell index of the face.
template <typename T, int DIR>
__global__ void flux_kernel(Dims g, Eos<T> eos, const T* __restrict__ w,
                            const T* __restrict__ bcc,
                            const T* __restrict__ bnorm, T* __restrict__ flx,
                            T* __restrict__ femf) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= g.nmb * g.ncell) return;
  const int i = idx % g.n1;
  const int j = (idx / g.n1) % g.n2;
  const int k = (idx / (static_cast<long long>(g.n1) * g.n2)) % g.n3;
  const int m = idx / g.ncell;
  const int f = DIR == 0 ? i : (DIR == 1 ? j : k);
  const int n = DIR == 0 ? g.n1 : (DIR == 1 ? g.n2 : g.n3);
  if (f < 2 || f > n - 2) return;
  const long long stride = DIR == 0 ? 1LL
                           : (DIR == 1 ? static_cast<long long>(g.n1)
                                       : static_cast<long long>(g.n1) * g.n2);
  // rotated frame: ivx normal, (ivy, ivz) transverse; B likewise
  constexpr int ivx = DIR + 1;
  constexpr int ivy = (DIR + 1) % 3 + 1;
  constexpr int ivz = (DIR + 2) % 3 + 1;
  constexpr int iby = (DIR + 1) % 3;
  constexpr int ibz = (DIR + 2) % 3;

  auto recon = [&](const T* arr, int nc, int c, T& ql, T& qr) {
    const long long base = cidx(g, m, c, nc, k, j, i);
    plm_face(arr[base - 2 * stride], arr[base - stride], arr[base],
             arr[base + stride], ql, qr);
  };
  FaceState<T> L, R;
  recon(w, 5, 0, L.d, R.d);
  recon(w, 5, ivx, L.vx, R.vx);
  recon(w, 5, ivy, L.vy, R.vy);
  recon(w, 5, ivz, L.vz, R.vz);
  recon(w, 5, 4, L.e, R.e);
  recon(bcc, 3, iby, L.by, R.by);
  recon(bcc, 3, ibz, L.bz, R.bz);
  // face-state floors, as the Pallas stage kernel applies them
  L.d = tmax(L.d, eos.dfloor);
  R.d = tmax(R.d, eos.dfloor);
  L.e = tmax(L.e, eos.efloor);
  R.e = tmax(R.e, eos.efloor);

  const T bx = DIR == 0   ? bnorm[f1idx(g, m, k, j, i)]
               : DIR == 1 ? bnorm[f2idx(g, m, k, j, i)]
                          : bnorm[f3idx(g, m, k, j, i)];
  T fr[5], fby, fbz;
  hlld(L, R, bx, eos, fr, fby, fbz);
  // back to conserved order: d, m1, m2, m3, E
  T out[5];
  out[0] = fr[0];
  out[ivx] = fr[1];
  out[ivy] = fr[2];
  out[ivz] = fr[3];
  out[4] = fr[4];
  for (int c = 0; c < 5; ++c) flx[cidx(g, m, c, 5, k, j, i)] = out[c];
  femf[cidx(g, m, 0, 2, k, j, i)] = -fby;
  femf[cidx(g, m, 1, 2, k, j, i)] = fbz;
}

// ---------------------------------------------------------------- step 3
// One thread per edge (k, j, i) in [2, n-2]^3: the lower corner of cell
// (k, j, i).  flx/femf hold the three directions back to back.
template <typename T>
__global__ void edge_kernel(Dims g, const T* __restrict__ w,
                            const T* __restrict__ bcc,
                            const T* __restrict__ flx,
                            const T* __restrict__ femf, T* __restrict__ edge) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= g.nmb * g.ncell) return;
  const int i = idx % g.n1;
  const int j = (idx / g.n1) % g.n2;
  const int k = (idx / (static_cast<long long>(g.n1) * g.n2)) % g.n3;
  const int m = idx / g.ncell;
  if (i < 2 || i > g.n1 - 2 || j < 2 || j > g.n2 - 2 || k < 2 ||
      k > g.n3 - 2)
    return;
  const long long dir = static_cast<long long>(g.nmb) * 5 * g.ncell;
  const long long edir = static_cast<long long>(g.nmb) * 2 * g.ncell;
  auto W = [&](int c, int kk, int jj, int ii) {
    return w[cidx(g, m, c, 5, kk, jj, ii)];
  };
  auto B = [&](int c, int kk, int jj, int ii) {
    return bcc[cidx(g, m, c, 3, kk, jj, ii)];
  };
  // mass flux (upwind selector) of direction d
  auto F = [&](int d, int kk, int jj, int ii) {
    return flx[d * dir + cidx(g, m, 0, 5, kk, jj, ii)];
  };
  // face EMF c (0 = ey, 1 = ez) of direction d
  auto E = [&](int d, int c, int kk, int jj, int ii) {
    return femf[d * edir + cidx(g, m, c, 2, kk, jj, ii)];
  };
  // cell-centred EMFs E = -v x B
  auto e1cc = [&](int kk, int jj, int ii) {
    return W(3, kk, jj, ii) * B(1, kk, jj, ii) -
           W(2, kk, jj, ii) * B(2, kk, jj, ii);
  };
  auto e2cc = [&](int kk, int jj, int ii) {
    return W(1, kk, jj, ii) * B(2, kk, jj, ii) -
           W(3, kk, jj, ii) * B(0, kk, jj, ii);
  };
  auto e3cc = [&](int kk, int jj, int ii) {
    return W(2, kk, jj, ii) * B(0, kk, jj, ii) -
           W(1, kk, jj, ii) * B(1, kk, jj, ii);
  };
  // E1 along x1: a = x2 (e1x2 = x2 faces' ey), b = x3 (e1x3 = x3 ez)
  const T e1 = gs07(e1cc(k, j, i), e1cc(k, j - 1, i), e1cc(k - 1, j, i),
                    e1cc(k - 1, j - 1, i), E(1, 0, k, j, i),
                    E(1, 0, k - 1, j, i), E(2, 1, k, j, i),
                    E(2, 1, k, j - 1, i), F(1, k, j, i), F(1, k - 1, j, i),
                    F(2, k, j, i), F(2, k, j - 1, i));
  // E2 along x2: a = x3 (e2x3 = x3 faces' ey), b = x1 (e2x1 = x1 ez)
  const T e2 = gs07(e2cc(k, j, i), e2cc(k - 1, j, i), e2cc(k, j, i - 1),
                    e2cc(k - 1, j, i - 1), E(2, 0, k, j, i),
                    E(2, 0, k, j, i - 1), E(0, 1, k, j, i),
                    E(0, 1, k - 1, j, i), F(2, k, j, i), F(2, k, j, i - 1),
                    F(0, k, j, i), F(0, k - 1, j, i));
  // E3 along x3: a = x1 (e3x1 = x1 faces' ey), b = x2 (e3x2 = x2 ez)
  const T e3 = gs07(e3cc(k, j, i), e3cc(k, j, i - 1), e3cc(k, j - 1, i),
                    e3cc(k, j - 1, i - 1), E(0, 0, k, j, i),
                    E(0, 0, k, j - 1, i), E(1, 1, k, j, i),
                    E(1, 1, k, j, i - 1), F(0, k, j, i), F(0, k, j - 1, i),
                    F(1, k, j, i), F(1, k, j, i - 1));
  edge[cidx(g, m, 0, 3, k, j, i)] = e1;
  edge[cidx(g, m, 1, 3, k, j, i)] = e2;
  edge[cidx(g, m, 2, 3, k, j, i)] = e3;
}

// ---------------------------------------------------------------- step 4
struct Coef {
  double gam0, gam1, beta_dt, dx1, dx2, dx3;
};

template <typename T>
__device__ __forceinline__ unsigned long long max_bits(T x);
template <>
__device__ __forceinline__ unsigned long long max_bits<float>(float x) {
  return static_cast<unsigned long long>(__float_as_uint(x));
}
template <>
__device__ __forceinline__ unsigned long long max_bits<double>(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}

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
    const T gam0 = static_cast<T>(cf.gam0), gam1 = static_cast<T>(cf.gam1);
    const T bdt = static_cast<T>(cf.beta_dt);
    const T dx1 = static_cast<T>(cf.dx1), dx2 = static_cast<T>(cf.dx2),
            dx3 = static_cast<T>(cf.dx3);
    const long long dir = static_cast<long long>(g.nmb) * 5 * g.ncell;

    // RK base: the input state with the c2p floors applied
    T uu[5], ww[5], u0[5];
    for (int c = 0; c < 5; ++c) uu[c] = u[cidx(g, m, c, 5, k, j, i)];
    int d0, d1, d2;
    c2p(uu, bcc[cidx(g, m, 0, 3, k, j, i)], bcc[cidx(g, m, 1, 3, k, j, i)],
        bcc[cidx(g, m, 2, 3, k, j, i)], eos, ww, u0, d0, d1, d2);

    // flux-divergence update (physics/mhd.py rk_update)
    T un[5];
    for (int c = 0; c < 5; ++c) {
      const long long o = cidx(g, m, c, 5, k, j, i);
      T divf = (flx[o + 1] - flx[o]) / dx1;
      divf = divf + (flx[dir + o + g.n1] - flx[dir + o]) / dx2;
      divf = divf + (flx[2 * dir + o + static_cast<long long>(g.n1) * g.n2] -
                     flx[2 * dir + o]) /
                        dx3;
      un[c] = gam0 * u0[c] + gam1 * u1[o] - bdt * divf;
    }

    // CT on the six faces bounding the cell (physics/mhd.py ct_update)
    auto E = [&](int c, int kk, int jj, int ii) {
      return edge[cidx(g, m, c, 3, kk, jj, ii)];
    };
    auto face1 = [&](int ii) {
      const long long o = f1idx(g, m, k, j, ii);
      T b = gam0 * b1[o] + gam1 * b1o[o];
      b = b - bdt * ((E(2, k, j + 1, ii) - E(2, k, j, ii)) / dx2);
      b = b + bdt * ((E(1, k + 1, j, ii) - E(1, k, j, ii)) / dx3);
      return b;
    };
    auto face2 = [&](int jj) {
      const long long o = f2idx(g, m, k, jj, i);
      T b = gam0 * b2[o] + gam1 * b2o[o];
      b = b + bdt * ((E(2, k, jj, i + 1) - E(2, k, jj, i)) / dx1);
      b = b - bdt * ((E(0, k + 1, jj, i) - E(0, k, jj, i)) / dx3);
      return b;
    };
    auto face3 = [&](int kk) {
      const long long o = f3idx(g, m, kk, j, i);
      T b = gam0 * b3[o] + gam1 * b3o[o];
      b = b - bdt * ((E(1, kk, j, i + 1) - E(1, kk, j, i)) / dx1);
      b = b + bdt * ((E(0, kk, j + 1, i) - E(0, kk, j, i)) / dx2);
      return b;
    };
    const T b1l = face1(i), b1r = face1(i + 1);
    const T b2l = face2(j), b2r = face2(j + 1);
    const T b3l = face3(k), b3r = face3(k + 1);

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
  __shared__ T smax[3][kThreads / 32];
  const int cnt0 = __syncthreads_count(fl[0]);
  const int cnt1 = __syncthreads_count(fl[1]);
  const int cnt2 = __syncthreads_count(fl[2]);
  for (int c = 0; c < 3; ++c) {
    T v = dv[c];
    for (int off = 16; off > 0; off >>= 1)
      v = tmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    if ((threadIdx.x & 31) == 0) smax[c][threadIdx.x >> 5] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (cnt0) atomicAdd(&red[0], static_cast<unsigned long long>(cnt0));
    if (cnt1) atomicAdd(&red[1], static_cast<unsigned long long>(cnt1));
    if (cnt2) atomicAdd(&red[2], static_cast<unsigned long long>(cnt2));
    for (int c = 0; c < 3; ++c) {
      T v = smax[c][0];
      for (int wi = 1; wi < (blockDim.x >> 5); ++wi) v = tmax(v, smax[c][wi]);
      atomicMax(&red[3 + c], max_bits<T>(v));
    }
  }
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
