// The flux through one face from PLM face states, the face-state floors
// and a Riemann solver: the arithmetic that kernel C (fused_stage.cu)
// runs on every face of its work list.  Kernel J (flux_dir.cu) runs the
// same arithmetic, HLLD only, on staged tiles of its own.
#pragma once

#include "common.cuh"
#include "hlld.cuh"
#include "srmhd.cuh"
#include "stencil.cuh"

namespace athenak {

enum Solver { kHlld = 0, kSrHlle = 1, kSrLlf = 2 };

// q(ch, s) is channel ch of the face's rotated frame (0 d, 1 vx normal,
// 2 vy, 3 vz, 4 e, 5 by, 6 bz) at stencil cell s, the cells f-2 .. f+1
// along the face's normal.  Writes the flux in the face's frame (d, the
// normal and transverse momenta, E; tau under SR) and the face EMFs
// ey = -F(B_y) and ez = F(B_z).
template <typename T, int SOLVER, class Q>
__device__ __forceinline__ void face_flux(const Q& q, T bx, const Eos<T>& eos,
                                          T fr[5], T& ey, T& ez) {
  FaceState<T> L, R;
  plm_face(q(0, 0), q(0, 1), q(0, 2), q(0, 3), L.d, R.d);
  plm_face(q(1, 0), q(1, 1), q(1, 2), q(1, 3), L.vx, R.vx);
  plm_face(q(2, 0), q(2, 1), q(2, 2), q(2, 3), L.vy, R.vy);
  plm_face(q(3, 0), q(3, 1), q(3, 2), q(3, 3), L.vz, R.vz);
  plm_face(q(4, 0), q(4, 1), q(4, 2), q(4, 3), L.e, R.e);
  plm_face(q(5, 0), q(5, 1), q(5, 2), q(5, 3), L.by, R.by);
  plm_face(q(6, 0), q(6, 1), q(6, 2), q(6, 3), L.bz, R.bz);
  // face-state floors (pallas_stage.py::_floors)
  L.d = tmax(L.d, eos.dfloor);
  R.d = tmax(R.d, eos.dfloor);
  L.e = tmax(L.e, eos.efloor);
  R.e = tmax(R.e, eos.efloor);
  T fby, fbz;
  if constexpr (SOLVER == kHlld)
    hlld(L, R, bx, eos, fr, fby, fbz);
  else
    sr_solve<T, SOLVER == kSrHlle>(L, R, bx, eos, fr, fby, fbz);
  ey = -fby;
  ez = fbz;
}

}  // namespace athenak
