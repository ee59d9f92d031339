"""Riemann solvers for Newtonian MHD: LLF, HLLE, HLLD and advection.

Counterpart of ``athenak_tpu/ops/rsolvers_mhd.py`` (reference:
src/mhd/rsolvers/{llf,hlle,hlld}_mhd.hpp, llf_mhd_singlestate.hpp), on
whole face tensors with the JAX package's order of terms.

Inputs per direction ivx (1, 2, 3):
  wl/wr : [..., nvar, n3, n2, n1] left/right primitives (IEN = internal
          e; no energy channel for the isothermal gas)
  bl/br : [..., 3, n3, n2, n1] left/right reconstructed cell-centred B
  bx    : [..., n3, n2, n1]    face-normal B (staggered, not reconstructed)

Returns (flx, ey, ez) with the reference EMF signs: ey is -F(B_trans1)
(x1 faces +E3, x2 faces +E1, x3 faces +E2) and ez is +F(B_trans2)
(x1 faces +E2, x2 faces +E3, x3 faces +E1).  The flux's scalar channels
are left zero for the caller's upwind scalar flux.  HLLD has only its
adiabatic branch; the isothermal gas takes HLLE, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..indices import IDN, IEN, IVX
from .eos import EOSData

_TINY = 1.0e-20
_HLLD_SMALL = 1.0e-4


def _vel_idx(ivx: int) -> Tuple[int, int, int, int]:
    ivy = IVX + ((ivx - IVX) + 1) % 3
    ivz = IVX + ((ivx - IVX) + 2) % 3
    iby = ((ivx - IVX) + 1) % 3
    ibz = ((ivx - IVX) + 2) % 3
    return ivy, ivz, iby, ibz


def _unpack(w, b, eos: EOSData, ivx: int):
    ivy, ivz, iby, ibz = _vel_idx(ivx)
    p = eos.pressure(w[..., IEN, :, :, :]) if eos.is_ideal else None
    return (w[..., IDN, :, :, :], w[..., ivx, :, :, :],
            w[..., ivy, :, :, :], w[..., ivz, :, :, :],
            b[..., iby, :, :, :], b[..., ibz, :, :, :], p)


def _pack(template, eos: EOSData, ivx: int, fd, fmx, fmy, fmz, fe, fby,
          fbz):
    """Stack the fluxes in conserved order (no energy isothermal, zeros
    in the scalar slots of ``template``'s layout); returns
    (flx, ey, ez)."""
    ivy, ivz, _, _ = _vel_idx(ivx)
    mom = {ivx: fmx, ivy: fmy, ivz: fmz}
    chans = [fd, mom[1], mom[2], mom[3]]
    if eos.is_ideal:
        chans.append(fe)
    while len(chans) < template.shape[-4]:
        chans.append(torch.zeros_like(fd))
    return torch.stack(chans, dim=-4), -fby, fbz


# --------------------------------------------------------------------- LLF
def llf(wl, wr, bl, br, bx, eos: EOSData, ivx: int):
    """Local Lax-Friedrichs (reference: llf_mhd_singlestate.hpp)."""
    dl, vxl, vyl, vzl, byl, bzl, pl = _unpack(wl, bl, eos, ivx)
    dr, vxr, vyr, vzr, byr, bzr, pr = _unpack(wr, br, eos, ivx)

    qa = dl * vxl
    qb = dr * vxr
    pbl_t = 0.5 * (byl ** 2 + bzl ** 2 - bx ** 2)
    pbr_t = 0.5 * (byr ** 2 + bzr ** 2 - bx ** 2)

    fs_d = qa + qb
    fs_mx = qa * vxl + qb * vxr + pbl_t + pbr_t
    fs_my = qa * vyl + qb * vyr - bx * (byl + byr)
    fs_mz = qa * vzl + qb * vzr - bx * (bzl + bzr)
    fs_by = byl * vxl + byr * vxr - bx * (vyl + vyr)
    fs_bz = bzl * vxl + bzr * vxr - bx * (vzl + vzr)

    if eos.is_ideal:
        el = (wl[..., IEN, :, :, :]
              + 0.5 * dl * (vxl ** 2 + vyl ** 2 + vzl ** 2)
              + pbl_t + bx ** 2)
        er = (wr[..., IEN, :, :, :]
              + 0.5 * dr * (vxr ** 2 + vyr ** 2 + vzr ** 2)
              + pbr_t + bx ** 2)
        fs_mx = fs_mx + pl + pr
        fs_e = ((el + pl + pbl_t) * vxl + (er + pr + pbr_t) * vxr
                - bx * (byl * vyl + bzl * vzl)
                - bx * (byr * vyr + bzr * vzr))
    else:
        fs_mx = fs_mx + eos.iso_cs ** 2 * (dl + dr)
    cl = eos.mhd_fast_speed(dl, pl, bx, byl, bzl)
    cr = eos.mhd_fast_speed(dr, pr, bx, byr, bzr)

    a = torch.maximum(torch.abs(vxl) + cl, torch.abs(vxr) + cr)

    fd = 0.5 * (fs_d - a * (dr - dl))
    fmx = 0.5 * (fs_mx - a * (dr * vxr - dl * vxl))
    fmy = 0.5 * (fs_my - a * (dr * vyr - dl * vyl))
    fmz = 0.5 * (fs_mz - a * (dr * vzr - dl * vzl))
    fe = 0.5 * (fs_e - a * (er - el)) if eos.is_ideal else None
    fby = 0.5 * (fs_by - a * (byr - byl))
    fbz = 0.5 * (fs_bz - a * (bzr - bzl))
    return _pack(wl, eos, ivx, fd, fmx, fmy, fmz, fe, fby, fbz)


# -------------------------------------------------------------------- HLLE
def hlle(wl, wr, bl, br, bx, eos: EOSData, ivx: int):
    """HLLE with Roe-averaged fast speeds (reference: hlle_mhd.hpp;
    Athena 2008 eqs B18, B39)."""
    dl, vxl, vyl, vzl, byl, bzl, pl = _unpack(wl, bl, eos, ivx)
    dr, vxr, vyr, vzr, byr, bzr, pr = _unpack(wr, br, eos, ivx)

    sqrtdl = torch.sqrt(dl)
    sqrtdr = torch.sqrt(dr)
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    droe = sqrtdl * sqrtdr
    vx_r = (sqrtdl * vxl + sqrtdr * vxr) * isdlpdr
    vy_r = (sqrtdl * vyl + sqrtdr * vyr) * isdlpdr
    vz_r = (sqrtdl * vzl + sqrtdr * vzr) * isdlpdr
    by_r = (sqrtdr * byl + sqrtdl * byr) * isdlpdr
    bz_r = (sqrtdr * bzl + sqrtdl * bzr) * isdlpdr
    x = 0.5 * ((byl - byr) ** 2 + (bzl - bzr) ** 2) / (sqrtdl + sqrtdr) ** 2
    y = 0.5 * (dl + dr) / droe

    pbl = 0.5 * (bx ** 2 + byl ** 2 + bzl ** 2)
    pbr = 0.5 * (bx ** 2 + byr ** 2 + bzr ** 2)
    if eos.is_ideal:
        gm1 = eos.gamma - 1.0
        el = pl / gm1 + 0.5 * dl * (vxl ** 2 + vyl ** 2 + vzl ** 2) + pbl
        er = pr / gm1 + 0.5 * dr * (vxr ** 2 + vyr ** 2 + vzr ** 2) + pbr
        hroe = ((el + pl + pbl) / sqrtdl + (er + pr + pbr) / sqrtdr) \
            * isdlpdr
    cl = eos.mhd_fast_speed(dl, pl, bx, byl, bzl)
    cr = eos.mhd_fast_speed(dr, pr, bx, byr, bzr)

    # Roe-averaged fast speed
    btsq = by_r ** 2 + bz_r ** 2
    vaxsq = bx ** 2 / droe
    if eos.is_ideal:
        bt_starsq = (gm1 - (gm1 - 1.0) * y) * btsq
        hp = hroe - (vaxsq + btsq / droe)
        vsq = vx_r ** 2 + vy_r ** 2 + vz_r ** 2
        twid_asq = torch.clamp(gm1 * (hp - 0.5 * vsq) - (gm1 - 1.0) * x,
                               min=0.0)
    else:
        bt_starsq = btsq * y
        twid_asq = eos.iso_cs ** 2 + x
    ct2 = bt_starsq / droe
    tsum = vaxsq + ct2 + twid_asq
    tdif = vaxsq + ct2 - twid_asq
    cfsq = 0.5 * (tsum + torch.sqrt(tdif * tdif + 4.0 * twid_asq * ct2))
    a = torch.sqrt(cfsq)

    al = torch.minimum(vx_r - a, vxl - cl)
    ar = torch.maximum(vx_r + a, vxr + cr)
    bp = torch.where(ar > 0.0, ar, _TINY)
    bm = torch.where(al < 0.0, al, -_TINY)

    qvl = vxl - bm
    qvr = vxr - bp
    fl_d = dl * qvl
    fr_d = dr * qvr
    fl_mx = dl * vxl * qvl + pbl - bx ** 2
    fr_mx = dr * vxr * qvr + pbr - bx ** 2
    fl_my = dl * vyl * qvl - bx * byl
    fr_my = dr * vyr * qvr - bx * byr
    fl_mz = dl * vzl * qvl - bx * bzl
    fr_mz = dr * vzr * qvr - bx * bzr
    if eos.is_ideal:
        fl_mx = fl_mx + pl
        fr_mx = fr_mx + pr
        fl_e = (el * qvl + vxl * (pl + pbl - bx ** 2)
                - bx * (byl * vyl + bzl * vzl))
        fr_e = (er * qvr + vxr * (pr + pbr - bx ** 2)
                - bx * (byr * vyr + bzr * vzr))
    else:
        fl_mx = fl_mx + eos.iso_cs ** 2 * dl
        fr_mx = fr_mx + eos.iso_cs ** 2 * dr
    fl_by = byl * qvl - bx * vyl
    fr_by = byr * qvr - bx * vyr
    fl_bz = bzl * qvl - bx * vzl
    fr_bz = bzr * qvr - bx * vzr

    tmp = torch.where(bp != bm, 0.5 * (bp + bm) / (bp - bm), 0.0)
    fd = 0.5 * (fl_d + fr_d) + (fl_d - fr_d) * tmp
    fmx = 0.5 * (fl_mx + fr_mx) + (fl_mx - fr_mx) * tmp
    fmy = 0.5 * (fl_my + fr_my) + (fl_my - fr_my) * tmp
    fmz = 0.5 * (fl_mz + fr_mz) + (fl_mz - fr_mz) * tmp
    fe = 0.5 * (fl_e + fr_e) + (fl_e - fr_e) * tmp if eos.is_ideal else None
    fby = 0.5 * (fl_by + fr_by) + (fl_by - fr_by) * tmp
    fbz = 0.5 * (fl_bz + fr_bz) + (fl_bz - fr_bz) * tmp
    return _pack(wl, eos, ivx, fd, fmx, fmy, fmz, fe, fby, fbz)


def hlld(wl, wr, bl, br, bx, eos: EOSData, ivx: int):
    """Miyoshi & Kusano (2005) five-wave solver, adiabatic branch.  The
    branches become selects: every intermediate state is computed
    everywhere, and degenerate denominators are guarded before the
    division."""
    if not eos.is_ideal:
        # the isothermal branch is not in the reference package either:
        # it falls back to HLLE there
        return hlle(wl, wr, bl, br, bx, eos, ivx)
    where = torch.where
    dl, vxl, vyl, vzl, byl, bzl, pl = _unpack(wl, bl, eos, ivx)
    dr, vxr, vyr, vzr, byr, bzr, pr = _unpack(wr, br, eos, ivx)
    gm1 = eos.gamma - 1.0
    igm1 = 1.0 / gm1

    bxsq = bx * bx
    pbl = 0.5 * (bxsq + byl ** 2 + bzl ** 2)
    pbr = 0.5 * (bxsq + byr ** 2 + bzr ** 2)
    kel = 0.5 * dl * (vxl ** 2 + (vyl ** 2 + vzl ** 2))
    ker = 0.5 * dr * (vxr ** 2 + (vyr ** 2 + vzr ** 2))

    ul_d, ul_mx, ul_my, ul_mz = dl, vxl * dl, vyl * dl, vzl * dl
    ul_e = pl * igm1 + kel + pbl
    ur_d, ur_mx, ur_my, ur_mz = dr, vxr * dr, vyr * dr, vzr * dr
    ur_e = pr * igm1 + ker + pbr

    cfl = eos.mhd_fast_speed(dl, pl, bx, byl, bzl)
    cfr = eos.mhd_fast_speed(dr, pr, bx, byr, bzr)
    spd0 = torch.minimum(vxl - cfl, vxr - cfr)
    spd4 = torch.maximum(vxl + cfl, vxr + cfr)

    ptl = pl + pbl
    ptr = pr + pbr

    fl_d = ul_mx
    fl_mx = ul_mx * vxl + ptl - bxsq
    fl_my = ul_my * vxl - bx * byl
    fl_mz = ul_mz * vxl - bx * bzl
    fl_e = vxl * (ul_e + ptl - bxsq) - bx * (vyl * byl + vzl * bzl)
    fl_by = byl * vxl - bx * vyl
    fl_bz = bzl * vxl - bx * vzl

    fr_d = ur_mx
    fr_mx = ur_mx * vxr + ptr - bxsq
    fr_my = ur_my * vxr - bx * byr
    fr_mz = ur_mz * vxr - bx * bzr
    fr_e = vxr * (ur_e + ptr - bxsq) - bx * (vyr * byr + vzr * bzr)
    fr_by = byr * vxr - bx * vyr
    fr_bz = bzr * vxr - bx * vzr

    sdl = spd0 - vxl
    sdr = spd4 - vxr
    spd2 = (sdr * ur_mx - sdl * ul_mx + (ptl - ptr)) \
        / (sdr * ur_d - sdl * ul_d)
    sdml = spd0 - spd2
    sdmr = spd4 - spd2
    sdml_i = 1.0 / sdml
    sdmr_i = 1.0 / sdmr

    ulst_d = ul_d * sdl * sdml_i
    urst_d = ur_d * sdr * sdmr_i
    ulst_di = 1.0 / ulst_d
    urst_di = 1.0 / urst_d
    sqrtdl = torch.sqrt(ulst_d)
    sqrtdr = torch.sqrt(urst_d)
    spd1 = spd2 - torch.abs(bx) / sqrtdl
    spd3 = spd2 + torch.abs(bx) / sqrtdr

    ptstl = ptl + ul_d * sdl * (spd2 - vxl)
    ptstr = ptr + ur_d * sdr * (spd2 - vxr)
    ptst = 0.5 * (ptstr + ptstl)

    # ul* (M&K eqns 39, 44-48) with the degenerate guard
    ulst_mx = ulst_d * spd2
    denl = ul_d * sdl * sdml - bxsq
    degl = torch.abs(denl) < _HLLD_SMALL * ptst
    denl_safe = where(degl, torch.ones_like(denl), denl)
    tmp = bx * (sdl - sdml) / denl_safe
    ulst_my = where(degl, ulst_d * vyl, ulst_d * (vyl - byl * tmp))
    ulst_mz = where(degl, ulst_d * vzl, ulst_d * (vzl - bzl * tmp))
    tmp = (ul_d * sdl ** 2 - bxsq) / denl_safe
    ulst_by = where(degl, byl, byl * tmp)
    ulst_bz = where(degl, bzl, bzl * tmp)
    vbstl = (ulst_mx * bx + (ulst_my * ulst_by + ulst_mz * ulst_bz)) \
        * ulst_di
    ulst_e = (sdl * ul_e - ptl * vxl + ptst * spd2
              + bx * (vxl * bx + (vyl * byl + vzl * bzl) - vbstl)) * sdml_i

    # ur*
    urst_mx = urst_d * spd2
    denr = ur_d * sdr * sdmr - bxsq
    degr = torch.abs(denr) < _HLLD_SMALL * ptst
    denr_safe = where(degr, torch.ones_like(denr), denr)
    tmp = bx * (sdr - sdmr) / denr_safe
    urst_my = where(degr, urst_d * vyr, urst_d * (vyr - byr * tmp))
    urst_mz = where(degr, urst_d * vzr, urst_d * (vzr - bzr * tmp))
    tmp = (ur_d * sdr ** 2 - bxsq) / denr_safe
    urst_by = where(degr, byr, byr * tmp)
    urst_bz = where(degr, bzr, bzr * tmp)
    vbstr = (urst_mx * bx + (urst_my * urst_by + urst_mz * urst_bz)) \
        * urst_di
    urst_e = (sdr * ur_e - ptr * vxr + ptst * spd2
              + bx * (vxr * bx + (vyr * byr + vzr * bzr) - vbstr)) * sdmr_i

    # ** states (M&K eqns 59-63); if Bx ~ 0 they equal the * states
    deg_bx = 0.5 * bxsq < _HLLD_SMALL * ptst
    invsumd = 1.0 / (sqrtdl + sqrtdr)
    bxsig = where(bx > 0.0, torch.ones_like(bx), -torch.ones_like(bx))

    tmp = invsumd * (sqrtdl * (ulst_my * ulst_di)
                     + sqrtdr * (urst_my * urst_di)
                     + bxsig * (urst_by - ulst_by))
    uldst_my = where(deg_bx, ulst_my, ulst_d * tmp)
    urdst_my = where(deg_bx, urst_my, urst_d * tmp)
    tmp = invsumd * (sqrtdl * (ulst_mz * ulst_di)
                     + sqrtdr * (urst_mz * urst_di)
                     + bxsig * (urst_bz - ulst_bz))
    uldst_mz = where(deg_bx, ulst_mz, ulst_d * tmp)
    urdst_mz = where(deg_bx, urst_mz, urst_d * tmp)
    tmp = invsumd * (sqrtdl * urst_by + sqrtdr * ulst_by
                     + bxsig * sqrtdl * sqrtdr * ((urst_my * urst_di)
                                                  - (ulst_my * ulst_di)))
    uldst_by = where(deg_bx, ulst_by, tmp)
    urdst_by = where(deg_bx, urst_by, tmp)
    tmp = invsumd * (sqrtdl * urst_bz + sqrtdr * ulst_bz
                     + bxsig * sqrtdl * sqrtdr * ((urst_mz * urst_di)
                                                  - (ulst_mz * ulst_di)))
    uldst_bz = where(deg_bx, ulst_bz, tmp)
    urdst_bz = where(deg_bx, urst_bz, tmp)

    uldst_d = ulst_d
    urdst_d = urst_d
    uldst_mx = ulst_mx
    urdst_mx = urst_mx
    tmp = spd2 * bx + (uldst_my * uldst_by + uldst_mz * uldst_bz) / uldst_d
    uldst_e = where(deg_bx, ulst_e, ulst_e - sqrtdl * bxsig * (vbstl - tmp))
    urdst_e = where(deg_bx, urst_e, urst_e + sqrtdr * bxsig * (vbstr - tmp))

    # assemble the flux by region (M&K eqn 66)
    def hlld_flux(fl, fr, u_l, u_lst, u_ldst, u_rdst, u_rst, u_r):
        dl1 = spd1 * (u_ldst - u_lst)
        l1 = spd0 * (u_lst - u_l)
        dr1 = spd3 * (u_rdst - u_rst)
        r1 = spd4 * (u_rst - u_r)
        return where(spd0 >= 0.0, fl,
               where(spd4 <= 0.0, fr,
               where(spd1 >= 0.0, fl + l1,
               where(spd2 >= 0.0, fl + l1 + dl1,
               where(spd3 > 0.0, fr + r1 + dr1, fr + r1)))))

    fd = hlld_flux(fl_d, fr_d, ul_d, ulst_d, uldst_d, urdst_d, urst_d, ur_d)
    fmx = hlld_flux(fl_mx, fr_mx, ul_mx, ulst_mx, uldst_mx, urdst_mx,
                    urst_mx, ur_mx)
    fmy = hlld_flux(fl_my, fr_my, ul_my, ulst_my, uldst_my, urdst_my,
                    urst_my, ur_my)
    fmz = hlld_flux(fl_mz, fr_mz, ul_mz, ulst_mz, uldst_mz, urdst_mz,
                    urst_mz, ur_mz)
    fe = hlld_flux(fl_e, fr_e, ul_e, ulst_e, uldst_e, urdst_e, urst_e, ur_e)
    fby = hlld_flux(fl_by, fr_by, byl, ulst_by, uldst_by, urdst_by,
                    urst_by, byr)
    fbz = hlld_flux(fl_bz, fr_bz, bzl, ulst_bz, uldst_bz, urdst_bz,
                    urst_bz, bzr)
    return _pack(wl, eos, ivx, fd, fmx, fmy, fmz, fe, fby, fbz)


# ------------------------------------------------------------------ advect
def advect(wl, wr, bl, br, bx, eos: EOSData, ivx: int):
    """Upwind advection of the density and the field (kinematic MHD
    tests); the scalars take the caller's upwind flux."""
    dl = wl[..., IDN, :, :, :]
    dr = wr[..., IDN, :, :, :]
    vxl = wl[..., ivx, :, :, :]
    vxr = wr[..., ivx, :, :, :]
    ivy, ivz, iby, ibz = _vel_idx(ivx)
    byl = bl[..., iby, :, :, :]
    byr = br[..., iby, :, :, :]
    bzl = bl[..., ibz, :, :, :]
    bzr = br[..., ibz, :, :, :]

    up = vxl >= 0.0
    fd = torch.where(up, dl * vxl, dr * vxr)
    fby = torch.where(up, byl * vxl - bx * wl[..., ivy, :, :, :],
                      byr * vxr - bx * wr[..., ivy, :, :, :])
    fbz = torch.where(up, bzl * vxl - bx * wl[..., ivz, :, :, :],
                      bzr * vxr - bx * wr[..., ivz, :, :, :])
    flx = torch.zeros_like(wl)
    flx[..., IDN, :, :, :] = fd
    return flx, -fby, fbz


MHD_RSOLVER_FNS = {"llf": llf, "hlle": hlle, "hlld": hlld, "advect": advect}
