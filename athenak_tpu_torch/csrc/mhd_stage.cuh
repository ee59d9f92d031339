// Launches and helpers shared by the Newtonian MHD stage kernel from
// primitives (mega_stage_v1.cu, kernel E) and the post-stage bcc + c2p
// kernel (fused_aux.cu, kernel F); kernel A (mega_stage_v2.cu) takes
// Coef and max_bits from here.
//
//   flux_kernel: one thread per face along DIR, PLM + face-state floors +
//                HLLD, writes the flux [5] and the face EMFs (ey, ez);
//   edge_kernel: one thread per edge, GS07 corner EMFs e1, e2, e3;
//   rk_ct_cell:  the RK update of one interior cell and the CT update of
//                its six faces;
//   block_reduce: per-block floor counts and max(|v| + c_f) per direction,
//                one atomic per block and quantity.
//
// Everything sits in an unnamed namespace, so each translation unit that
// includes this header gets its own instance of every kernel.
#pragma once

#include "common.cuh"
#include "hlld.cuh"
#include "stencil.cuh"

namespace athenak {
namespace {

// RK and CT coefficients, converted to the working type in the kernels
struct Coef {
  double gam0, gam1, beta_dt, dx1, dx2, dx3;
};

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
  // face-state floors, as the Pallas stage kernels apply them
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

// Interior cell (m, k, j, i): the flux-divergence update
// un = gam0*u0 + gam1*u1 - beta_dt*div(F) (physics/mhd.py rk_update) and
// the CT update of the six faces bounding the cell (ct_update), lower
// (l) and upper (r) face per axis.  With old == false the gam1 terms are
// dropped and u1/b1o/b2o/b3o are not read (the RK stages with gam1 = 0).
template <typename T>
__device__ __forceinline__ void rk_ct_cell(
    const Dims& g, const Coef& cf, bool old, const T u0[5],
    const T* __restrict__ u1, const T* __restrict__ b1,
    const T* __restrict__ b2, const T* __restrict__ b3,
    const T* __restrict__ b1o, const T* __restrict__ b2o,
    const T* __restrict__ b3o, const T* __restrict__ flx,
    const T* __restrict__ edge, int m, int k, int j, int i, T un[5], T& b1l,
    T& b1r, T& b2l, T& b2r, T& b3l, T& b3r) {
  const T gam0 = static_cast<T>(cf.gam0), gam1 = static_cast<T>(cf.gam1);
  const T bdt = static_cast<T>(cf.beta_dt);
  const T dx1 = static_cast<T>(cf.dx1), dx2 = static_cast<T>(cf.dx2),
          dx3 = static_cast<T>(cf.dx3);
  const long long dir = static_cast<long long>(g.nmb) * 5 * g.ncell;
  for (int c = 0; c < 5; ++c) {
    const long long o = cidx(g, m, c, 5, k, j, i);
    T divf = (flx[o + 1] - flx[o]) / dx1;
    divf = divf + (flx[dir + o + g.n1] - flx[dir + o]) / dx2;
    divf = divf + (flx[2 * dir + o + static_cast<long long>(g.n1) * g.n2] -
                   flx[2 * dir + o]) /
                      dx3;
    un[c] = old ? gam0 * u0[c] + gam1 * u1[o] - bdt * divf
                : gam0 * u0[c] - bdt * divf;
  }
  auto E = [&](int c, int kk, int jj, int ii) {
    return edge[cidx(g, m, c, 3, kk, jj, ii)];
  };
  auto face1 = [&](int ii) {
    const long long o = f1idx(g, m, k, j, ii);
    T b = old ? gam0 * b1[o] + gam1 * b1o[o] : gam0 * b1[o];
    b = b - bdt * ((E(2, k, j + 1, ii) - E(2, k, j, ii)) / dx2);
    b = b + bdt * ((E(1, k + 1, j, ii) - E(1, k, j, ii)) / dx3);
    return b;
  };
  auto face2 = [&](int jj) {
    const long long o = f2idx(g, m, k, jj, i);
    T b = old ? gam0 * b2[o] + gam1 * b2o[o] : gam0 * b2[o];
    b = b + bdt * ((E(2, k, jj, i + 1) - E(2, k, jj, i)) / dx1);
    b = b - bdt * ((E(0, k + 1, jj, i) - E(0, k, jj, i)) / dx3);
    return b;
  };
  auto face3 = [&](int kk) {
    const long long o = f3idx(g, m, kk, j, i);
    T b = old ? gam0 * b3[o] + gam1 * b3o[o] : gam0 * b3[o];
    b = b - bdt * ((E(1, kk, j, i + 1) - E(1, kk, j, i)) / dx1);
    b = b + bdt * ((E(0, kk, j + 1, i) - E(0, kk, j, i)) / dx2);
    return b;
  };
  b1l = face1(i);
  b1r = face1(i + 1);
  b2l = face2(j);
  b2r = face2(j + 1);
  b3l = face3(k);
  b3r = face3(k + 1);
}

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

// Called by every thread of a block of kThreads threads: adds the block's
// floor hits fl[0..2] to red[0..2] and raises red[3..5] to the bit
// pattern of the block's max of dv[0..2] (positive floats order like
// their bit patterns).  red is zeroed before the launch.
template <typename T>
__device__ __forceinline__ void block_reduce(const int fl[3], const T dv[3],
                                             unsigned long long* red) {
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

}  // namespace
}  // namespace athenak
