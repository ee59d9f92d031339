// HLLD Riemann solver for one face, Newtonian ideal MHD
// (Miyoshi & Kusano 2005; reference: src/mhd/rsolvers/hlld_mhd.hpp:60-348).
// The arithmetic follows ops/rsolvers_mhd.py::hlld term by term: every
// intermediate state is computed and the region is chosen by selects,
// so the kernel and its plain version take the same branches.
#pragma once

#include "common.cuh"

namespace athenak {

constexpr double kHlldSmall = 1.0e-4;

// One side of the face in the solver's rotated frame: d, vx (normal),
// vy, vz, e (internal energy), by, bz.
template <typename T>
struct FaceState {
  T d, vx, vy, vz, e, by, bz;
};

// f[5]: mass, normal/transverse momenta in the rotated frame (x, y, z),
// energy; fby/fbz the transverse induction fluxes.
template <typename T>
__device__ __forceinline__ void hlld(const FaceState<T>& L,
                                     const FaceState<T>& R, T bx,
                                     const Eos<T>& eos, T f[5], T& fby,
                                     T& fbz) {
  const T small = T(kHlldSmall);
  const T dl = L.d, vxl = L.vx, vyl = L.vy, vzl = L.vz, byl = L.by,
          bzl = L.bz;
  const T dr = R.d, vxr = R.vx, vyr = R.vy, vzr = R.vz, byr = R.by,
          bzr = R.bz;
  const T pl = eos.gm1 * L.e;
  const T pr = eos.gm1 * R.e;
  const T igm1 = eos.igm1;

  const T bxsq = bx * bx;
  const T pbl = T(0.5) * (bxsq + byl * byl + bzl * bzl);
  const T pbr = T(0.5) * (bxsq + byr * byr + bzr * bzr);
  const T kel = T(0.5) * dl * (vxl * vxl + (vyl * vyl + vzl * vzl));
  const T ker = T(0.5) * dr * (vxr * vxr + (vyr * vyr + vzr * vzr));

  const T ul_d = dl, ul_mx = vxl * dl, ul_my = vyl * dl, ul_mz = vzl * dl;
  const T ul_e = pl * igm1 + kel + pbl;
  const T ur_d = dr, ur_mx = vxr * dr, ur_my = vyr * dr, ur_mz = vzr * dr;
  const T ur_e = pr * igm1 + ker + pbr;

  const T cfl = fast_speed(eos, dl, pl, bx, byl, bzl);
  const T cfr = fast_speed(eos, dr, pr, bx, byr, bzr);
  const T spd0 = tmin(vxl - cfl, vxr - cfr);
  const T spd4 = tmax(vxl + cfl, vxr + cfr);

  const T ptl = pl + pbl;
  const T ptr = pr + pbr;

  const T fl_d = ul_mx;
  const T fl_mx = ul_mx * vxl + ptl - bxsq;
  const T fl_my = ul_my * vxl - bx * byl;
  const T fl_mz = ul_mz * vxl - bx * bzl;
  const T fl_e = vxl * (ul_e + ptl - bxsq) - bx * (vyl * byl + vzl * bzl);
  const T fl_by = byl * vxl - bx * vyl;
  const T fl_bz = bzl * vxl - bx * vzl;

  const T fr_d = ur_mx;
  const T fr_mx = ur_mx * vxr + ptr - bxsq;
  const T fr_my = ur_my * vxr - bx * byr;
  const T fr_mz = ur_mz * vxr - bx * bzr;
  const T fr_e = vxr * (ur_e + ptr - bxsq) - bx * (vyr * byr + vzr * bzr);
  const T fr_by = byr * vxr - bx * vyr;
  const T fr_bz = bzr * vxr - bx * vzr;

  const T sdl = spd0 - vxl;
  const T sdr = spd4 - vxr;
  const T spd2 = (sdr * ur_mx - sdl * ul_mx + (ptl - ptr)) /
                 (sdr * ur_d - sdl * ul_d);
  const T sdml = spd0 - spd2;
  const T sdmr = spd4 - spd2;
  const T sdml_i = T(1) / sdml;
  const T sdmr_i = T(1) / sdmr;

  const T ulst_d = ul_d * sdl * sdml_i;
  const T urst_d = ur_d * sdr * sdmr_i;
  const T ulst_di = T(1) / ulst_d;
  const T urst_di = T(1) / urst_d;
  const T sqrtdl = sqrt(ulst_d);
  const T sqrtdr = sqrt(urst_d);
  const T spd1 = spd2 - fabs(bx) / sqrtdl;
  const T spd3 = spd2 + fabs(bx) / sqrtdr;

  const T ptstl = ptl + ul_d * sdl * (spd2 - vxl);
  const T ptstr = ptr + ur_d * sdr * (spd2 - vxr);
  const T ptst = T(0.5) * (ptstr + ptstl);

  // ul* with the degenerate guard
  const T ulst_mx = ulst_d * spd2;
  const T denl = ul_d * sdl * sdml - bxsq;
  const bool degl = fabs(denl) < small * ptst;
  const T denl_safe = degl ? T(1) : denl;
  T tmp = bx * (sdl - sdml) / denl_safe;
  const T ulst_my = degl ? ulst_d * vyl : ulst_d * (vyl - byl * tmp);
  const T ulst_mz = degl ? ulst_d * vzl : ulst_d * (vzl - bzl * tmp);
  tmp = (ul_d * (sdl * sdl) - bxsq) / denl_safe;
  const T ulst_by = degl ? byl : byl * tmp;
  const T ulst_bz = degl ? bzl : bzl * tmp;
  const T vbstl =
      (ulst_mx * bx + (ulst_my * ulst_by + ulst_mz * ulst_bz)) * ulst_di;
  const T ulst_e = (sdl * ul_e - ptl * vxl + ptst * spd2 +
                    bx * (vxl * bx + (vyl * byl + vzl * bzl) - vbstl)) *
                   sdml_i;

  // ur*
  const T urst_mx = urst_d * spd2;
  const T denr = ur_d * sdr * sdmr - bxsq;
  const bool degr = fabs(denr) < small * ptst;
  const T denr_safe = degr ? T(1) : denr;
  tmp = bx * (sdr - sdmr) / denr_safe;
  const T urst_my = degr ? urst_d * vyr : urst_d * (vyr - byr * tmp);
  const T urst_mz = degr ? urst_d * vzr : urst_d * (vzr - bzr * tmp);
  tmp = (ur_d * (sdr * sdr) - bxsq) / denr_safe;
  const T urst_by = degr ? byr : byr * tmp;
  const T urst_bz = degr ? bzr : bzr * tmp;
  const T vbstr =
      (urst_mx * bx + (urst_my * urst_by + urst_mz * urst_bz)) * urst_di;
  const T urst_e = (sdr * ur_e - ptr * vxr + ptst * spd2 +
                    bx * (vxr * bx + (vyr * byr + vzr * bzr) - vbstr)) *
                   sdmr_i;

  // ** states; if Bx ~ 0 they equal the * states
  const bool deg_bx = T(0.5) * bxsq < small * ptst;
  const T invsumd = T(1) / (sqrtdl + sqrtdr);
  const T bxsig = bx > T(0) ? T(1) : T(-1);

  tmp = invsumd * (sqrtdl * (ulst_my * ulst_di) +
                   sqrtdr * (urst_my * urst_di) +
                   bxsig * (urst_by - ulst_by));
  const T uldst_my = deg_bx ? ulst_my : ulst_d * tmp;
  const T urdst_my = deg_bx ? urst_my : urst_d * tmp;
  tmp = invsumd * (sqrtdl * (ulst_mz * ulst_di) +
                   sqrtdr * (urst_mz * urst_di) +
                   bxsig * (urst_bz - ulst_bz));
  const T uldst_mz = deg_bx ? ulst_mz : ulst_d * tmp;
  const T urdst_mz = deg_bx ? urst_mz : urst_d * tmp;
  tmp = invsumd * (sqrtdl * urst_by + sqrtdr * ulst_by +
                   bxsig * sqrtdl * sqrtdr *
                       ((urst_my * urst_di) - (ulst_my * ulst_di)));
  const T uldst_by = deg_bx ? ulst_by : tmp;
  const T urdst_by = deg_bx ? urst_by : tmp;
  tmp = invsumd * (sqrtdl * urst_bz + sqrtdr * ulst_bz +
                   bxsig * sqrtdl * sqrtdr *
                       ((urst_mz * urst_di) - (ulst_mz * ulst_di)));
  const T uldst_bz = deg_bx ? ulst_bz : tmp;
  const T urdst_bz = deg_bx ? urst_bz : tmp;

  tmp = spd2 * bx + (uldst_my * uldst_by + uldst_mz * uldst_bz) / ulst_d;
  const T uldst_e = deg_bx ? ulst_e : ulst_e - sqrtdl * bxsig * (vbstl - tmp);
  const T urdst_e = deg_bx ? urst_e : urst_e + sqrtdr * bxsig * (vbstr - tmp);

  // flux by region (M&K eqn 66)
  auto region = [&](T fl, T fr, T u_l, T u_lst, T u_ldst, T u_rdst, T u_rst,
                    T u_r) -> T {
    if (spd0 >= T(0)) return fl;
    if (spd4 <= T(0)) return fr;
    const T l1 = spd0 * (u_lst - u_l);
    if (spd1 >= T(0)) return fl + l1;
    if (spd2 >= T(0)) return fl + l1 + spd1 * (u_ldst - u_lst);
    const T r1 = spd4 * (u_rst - u_r);
    if (spd3 > T(0)) return fr + r1 + spd3 * (u_rdst - u_rst);
    return fr + r1;
  };

  f[0] = region(fl_d, fr_d, ul_d, ulst_d, ulst_d, urst_d, urst_d, ur_d);
  f[1] = region(fl_mx, fr_mx, ul_mx, ulst_mx, ulst_mx, urst_mx, urst_mx,
                ur_mx);
  f[2] = region(fl_my, fr_my, ul_my, ulst_my, uldst_my, urdst_my, urst_my,
                ur_my);
  f[3] = region(fl_mz, fr_mz, ul_mz, ulst_mz, uldst_mz, urdst_mz, urst_mz,
                ur_mz);
  f[4] = region(fl_e, fr_e, ul_e, ulst_e, uldst_e, urdst_e, urst_e, ur_e);
  fby = region(fl_by, fr_by, byl, ulst_by, uldst_by, urdst_by, urst_by, byr);
  fbz = region(fl_bz, fr_bz, bzl, ulst_bz, uldst_bz, urdst_bz, urst_bz, bzr);
}

}  // namespace athenak
