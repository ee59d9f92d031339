// Special-relativistic MHD Riemann solvers for one face: HLLE and LLF.
//
// Matched line for line to ops/rsolvers_srmhd.py and
// ops/eos_sr.py::sr_mhd_fast_speeds (reference:
// src/mhd/rsolvers/llf_mhd_singlestate.hpp:92-190, hlle_srmhd.hpp,
// eos.hpp:97-111): the same operations in the same order, so that with
// --fmad=false the kernel rounds as the plain version does.  Primitives
// hold u^i = gamma v^i and the internal energy density e.
#pragma once

#include "common.cuh"
#include "hlld.cuh"

namespace athenak {

// maximal fast magnetosonic speeds lambda_+ (lp) and lambda_- (lm)
template <typename T>
__device__ __forceinline__ void sr_mhd_fast_speeds(const Eos<T>& eos, T d,
                                                   T p, T ux, T lor, T b_sq,
                                                   T& lp, T& lm) {
  const T w = d + eos.gamma * p / eos.gm1;
  const T cs_sq = eos.gamma * p / w;
  const T va_sq = b_sq / (b_sq + w);
  const T cms = cs_sq + va_sq - cs_sq * va_sq;
  const T v2 = T(1) - T(1) / (lor * lor);
  const T p1 = (ux / lor) * (T(1) - cms);
  const T tmp =
      sqrt(tmax(cms * ((T(1) - v2 * cms) - p1 * (ux / lor)), T(0))) / lor;
  const T invden = T(1) / (T(1) - v2 * cms);
  lp = (p1 + tmp) * invden;
  lm = (p1 - tmp) * invden;
}

// One side of the face (rsolvers_srmhd.py::_state): conserved state and
// flux, ordered (D, Mx, My, Mz, E, By, Bz) in the frame of the face, and
// the side's fast speeds.
template <typename T>
__device__ __forceinline__ void sr_side(const FaceState<T>& s, T bx,
                                        const Eos<T>& eos, T cons[7],
                                        T flux[7], T& lp, T& lm) {
  const T d = s.d, vx = s.vx, vy = s.vy, vz = s.vz, e = s.e, by = s.by,
          bz = s.bz;
  const T gam = sqrt(T(1) + vx * vx + vy * vy + vz * vz);
  const T b0 = bx * vx + by * vy + bz * vz;
  const T b1 = (bx + b0 * vx) / gam;
  const T b2 = (by + b0 * vy) / gam;
  const T b3 = (bz + b0 * vz) / gam;
  const T b_sq = -b0 * b0 + b1 * b1 + b2 * b2 + b3 * b3;

  const T p = eos.gm1 * e;
  const T wgas = d + eos.gamma * e;
  const T wtot = wgas + b_sq;
  const T ptot = p + T(0.5) * b_sq;

  cons[0] = d * gam;
  cons[1] = wtot * vx * gam - b1 * b0;
  cons[2] = wtot * vy * gam - b2 * b0;
  cons[3] = wtot * vz * gam - b3 * b0;
  cons[4] = wtot * gam * gam - b0 * b0 - ptot;
  cons[5] = b2 * gam - b0 * vy;
  cons[6] = b3 * gam - b0 * vz;
  flux[0] = d * vx;
  flux[1] = wtot * vx * vx - b1 * b1 + ptot;
  flux[2] = wtot * vy * vx - b2 * b1;
  flux[3] = wtot * vz * vx - b3 * b1;
  flux[4] = wtot * gam * vx - b0 * b1;
  flux[5] = b2 * vx - b1 * vy;
  flux[6] = b3 * vx - b1 * vz;
  sr_mhd_fast_speeds(eos, d, p, vx, gam, b_sq, lp, lm);
}

// f[5]: D, normal/transverse momenta in the frame of the face (x, y, z)
// and tau = E - D; fby/fbz the transverse induction fluxes.  HLLE when
// kHlle, else LLF.
template <typename T, bool kHlle>
__device__ __forceinline__ void sr_solve(const FaceState<T>& L,
                                         const FaceState<T>& R, T bx,
                                         const Eos<T>& eos, T f[5], T& fby,
                                         T& fbz) {
  T cl[7], fl[7], cr[7], fr[7], lpl, lml, lpr, lmr;
  sr_side(L, bx, eos, cl, fl, lpl, lml);
  sr_side(R, bx, eos, cr, fr, lpr, lmr);
  const T lam_l = tmin(lml, lmr);
  const T lam_r = tmax(lpl, lpr);
  T out[7];
  if (kHlle) {
    const T qa = lam_r * lam_l;
    // the 1e-300 guard rounds to 0 in float, as in the plain version
    const T qb = T(1) / (lam_r - lam_l + static_cast<T>(1.0e-300));
    for (int n = 0; n < 7; ++n) {
      const T hll =
          (lam_r * fl[n] - lam_l * fr[n] + qa * (cr[n] - cl[n])) * qb;
      out[n] = lam_l >= T(0) ? fl[n] : (lam_r <= T(0) ? fr[n] : hll);
    }
  } else {
    const T lam = tmax(lam_r, -lam_l);
    for (int n = 0; n < 7; ++n)
      out[n] = T(0.5) * (fl[n] + fr[n] - lam * (cr[n] - cl[n]));
  }
  f[0] = out[0];
  f[1] = out[1];
  f[2] = out[2];
  f[3] = out[3];
  f[4] = out[4] - out[0];
  fby = out[5];
  fbz = out[6];
}

}  // namespace athenak
