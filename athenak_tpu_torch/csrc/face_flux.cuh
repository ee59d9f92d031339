// The flux through one face from PLM face states, the face-state floors
// and a Riemann solver, and the per-direction flux kernel built on it,
// which kernel C (fused_stage.cu) launches.  Kernel J (flux_dir.cu) runs
// the same arithmetic on staged tiles of its own.
#pragma once

#include "common.cuh"
#include "hlld.cuh"
#include "srmhd.cuh"
#include "stencil.cuh"

namespace athenak {

enum Solver { kHlld = 0, kSrHlle = 1, kSrLlf = 2 };

// The lower face of cell (m, k, j, i) along DIR (0/1/2 = x1/x2/x3); bnorm
// is the face array of DIR.  The stencil wraps circularly along DIR, as
// the plain versions' torch.roll does.  Writes the flux in conserved
// order (d, m1, m2, m3, E; tau under SR) and the face EMFs ey = -F(B_y)
// and ez = F(B_z) of the face's rotated frame.
template <typename T, int DIR, int SOLVER>
__device__ __forceinline__ void face_flux(const Dims& g, const Eos<T>& eos,
                                          const T* __restrict__ w,
                                          const T* __restrict__ bcc,
                                          const T* __restrict__ bnorm, int m,
                                          int k, int j, int i, T out[5],
                                          T& ey, T& ez) {
  const int f = DIR == 0 ? i : (DIR == 1 ? j : k);
  const int n = DIR == 0 ? g.n1 : (DIR == 1 ? g.n2 : g.n3);
  const long long stride = DIR == 0 ? 1LL
                           : (DIR == 1 ? static_cast<long long>(g.n1)
                                       : static_cast<long long>(g.n1) * g.n2);
  const long long om2 = (wrapi(f - 2, n) - f) * stride;
  const long long om1 = (wrapi(f - 1, n) - f) * stride;
  const long long op1 = (wrapi(f + 1, n) - f) * stride;
  // frame of the face: ivx normal, (ivy, ivz) transverse; B likewise
  constexpr int ivx = DIR + 1;
  constexpr int ivy = (DIR + 1) % 3 + 1;
  constexpr int ivz = (DIR + 2) % 3 + 1;
  constexpr int iby = (DIR + 1) % 3;
  constexpr int ibz = (DIR + 2) % 3;

  auto recon = [&](const T* arr, int nc, int c, T& ql, T& qr) {
    const long long b = cidx(g, m, c, nc, k, j, i);
    plm_face(arr[b + om2], arr[b + om1], arr[b], arr[b + op1], ql, qr);
  };
  FaceState<T> L, R;
  recon(w, 5, 0, L.d, R.d);
  recon(w, 5, ivx, L.vx, R.vx);
  recon(w, 5, ivy, L.vy, R.vy);
  recon(w, 5, ivz, L.vz, R.vz);
  recon(w, 5, 4, L.e, R.e);
  recon(bcc, 3, iby, L.by, R.by);
  recon(bcc, 3, ibz, L.bz, R.bz);
  // face-state floors (pallas_stage.py::_floors)
  L.d = tmax(L.d, eos.dfloor);
  R.d = tmax(R.d, eos.dfloor);
  L.e = tmax(L.e, eos.efloor);
  R.e = tmax(R.e, eos.efloor);

  const T bx = DIR == 0   ? bnorm[f1idx(g, m, k, j, i)]
               : DIR == 1 ? bnorm[f2idx(g, m, k, j, i)]
                          : bnorm[f3idx(g, m, k, j, i)];
  T fr[5], fby, fbz;
  if constexpr (SOLVER == kHlld)
    hlld(L, R, bx, eos, fr, fby, fbz);
  else
    sr_solve<T, SOLVER == kSrHlle>(L, R, bx, eos, fr, fby, fbz);
  // back to conserved order: d, m1, m2, m3, E (tau under SR)
  out[0] = fr[0];
  out[ivx] = fr[1];
  out[ivy] = fr[2];
  out[ivz] = fr[3];
  out[4] = fr[4];
  ey = -fby;
  ez = fbz;
}

// One thread per cell index (m, k, j, i) of the direction DIR; the face is
// the lower face of that cell.  Writes the flux [nmb, 5, n3, n2, n1], the
// face EMFs ey and ez [nmb, n3, n2, n1] and, unless fden is null, the mass
// flux [nmb, n3, n2, n1].
template <typename T, int DIR, int SOLVER>
__global__ void flux_kernel(Dims g, Eos<T> eos, const T* __restrict__ w,
                            const T* __restrict__ bcc,
                            const T* __restrict__ bnorm, T* __restrict__ flx,
                            T* __restrict__ fden, T* __restrict__ ey,
                            T* __restrict__ ez) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= g.nmb * g.ncell) return;
  const int i = idx % g.n1;
  const int j = (idx / g.n1) % g.n2;
  const int k = (idx / (static_cast<long long>(g.n1) * g.n2)) % g.n3;
  const int m = idx / g.ncell;
  T out[5], fey, fez;
  face_flux<T, DIR, SOLVER>(g, eos, w, bcc, bnorm, m, k, j, i, out, fey,
                            fez);
  for (int c = 0; c < 5; ++c) flx[cidx(g, m, c, 5, k, j, i)] = out[c];
  const long long o = cidx(g, m, 0, 1, k, j, i);
  if (fden != nullptr) fden[o] = out[0];
  ey[o] = fey;
  ez[o] = fez;
}

}  // namespace athenak
