"""Riemann solvers for Newtonian hydrodynamics: LLF, HLLE, HLLC, Roe and
the advection solver.

Counterpart of ``athenak_tpu/ops/rsolvers.py`` (reference:
src/hydro/rsolvers/{llf,hlle,hllc,roe,advect}_hyd.hpp), on whole face
tensors with the JAX package's order of terms.  The left/right states
are primitives ``[..., nvar, n3, n2, n1]`` with IEN the internal energy
density; ``ivx`` in {1, 2, 3} names the face-normal direction, and the
transverse velocities are its cyclic successors.  Each solver returns
the conserved fluxes in the layout of ``wl``; the isothermal gas has no
energy channel, and the scalar channels beyond the fluid ones are left
zero for the caller's upwind scalar flux (the advection solver fills
them itself).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..indices import IDN, IEN, IVX
from .eos import EOSData

_TINY = 1.0e-20
_TINY32 = float(np.finfo(np.float32).tiny)


def _vel_idx(ivx: int) -> Tuple[int, int]:
    ivy = IVX + ((ivx - IVX) + 1) % 3
    ivz = IVX + ((ivx - IVX) + 2) % 3
    return ivy, ivz


def _unpack(w, eos: EOSData, ivx: int):
    """(d, vx, vy, vz, p) of the direction; p is None isothermal."""
    ivy, ivz = _vel_idx(ivx)
    p = eos.pressure(w[..., IEN, :, :, :]) if eos.is_ideal else None
    return (w[..., IDN, :, :, :], w[..., ivx, :, :, :],
            w[..., ivy, :, :, :], w[..., ivz, :, :, :], p)


def _pack_flux(template, eos: EOSData, ivx: int, fd, fmx, fmy, fmz, fe):
    """Stack the fluxes in conserved order, zeros in the scalar slots."""
    ivy, ivz = _vel_idx(ivx)
    mom = {ivx: fmx, ivy: fmy, ivz: fmz}
    chans = [fd, mom[1], mom[2], mom[3]]
    if eos.is_ideal:
        chans.append(fe)
    while len(chans) < template.shape[-4]:
        chans.append(torch.zeros_like(fd))
    return torch.stack(chans, dim=-4)


# --------------------------------------------------------------------- LLF
def llf(wl, wr, eos: EOSData, ivx: int):
    """Local Lax-Friedrichs (reference SingleStateLLF_Hyd,
    src/hydro/rsolvers/llf_hyd_singlestate.hpp:28-78)."""
    dl, vxl, vyl, vzl, pl = _unpack(wl, eos, ivx)
    dr, vxr, vyr, vzr, pr = _unpack(wr, eos, ivx)

    qa = dl * vxl
    qb = dr * vxr
    fsum_d = qa + qb
    fsum_mx = qa * vxl + qb * vxr
    fsum_my = qa * vyl + qb * vyr
    fsum_mz = qa * vzl + qb * vzr

    if eos.is_ideal:
        el = wl[..., IEN, :, :, :] + 0.5 * dl * (vxl ** 2 + vyl ** 2
                                                 + vzl ** 2)
        er = wr[..., IEN, :, :, :] + 0.5 * dr * (vxr ** 2 + vyr ** 2
                                                 + vzr ** 2)
        fsum_mx = fsum_mx + (pl + pr)
        fsum_e = (el + pl) * vxl + (er + pr) * vxr
        cl = eos.hydro_sound_speed(dl, pl)
        cr = eos.hydro_sound_speed(dr, pr)
    else:
        fsum_mx = fsum_mx + eos.iso_cs ** 2 * (dl + dr)
        cl = cr = eos.iso_cs

    a = torch.maximum(torch.abs(vxl) + cl, torch.abs(vxr) + cr)

    fd = 0.5 * (fsum_d - a * (dr - dl))
    fmx = 0.5 * (fsum_mx - a * (dr * vxr - dl * vxl))
    fmy = 0.5 * (fsum_my - a * (dr * vyr - dl * vyl))
    fmz = 0.5 * (fsum_mz - a * (dr * vzr - dl * vzl))
    fe = 0.5 * (fsum_e - a * (er - el)) if eos.is_ideal else None
    return _pack_flux(wl, eos, ivx, fd, fmx, fmy, fmz, fe)


# -------------------------------------------------------------------- HLLE
def hlle(wl, wr, eos: EOSData, ivx: int):
    """HLLE with Roe-averaged wave-speed estimates (reference:
    src/hydro/rsolvers/hlle_hyd.hpp)."""
    dl, vxl, vyl, vzl, pl = _unpack(wl, eos, ivx)
    dr, vxr, vyr, vzr, pr = _unpack(wr, eos, ivx)

    sqrtdl = torch.sqrt(dl)
    sqrtdr = torch.sqrt(dr)
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    vx_roe = (sqrtdl * vxl + sqrtdr * vxr) * isdlpdr
    vy_roe = (sqrtdl * vyl + sqrtdr * vyr) * isdlpdr
    vz_roe = (sqrtdl * vzl + sqrtdr * vzr) * isdlpdr

    if eos.is_ideal:
        gm1 = eos.gamma - 1.0
        el = pl / gm1 + 0.5 * dl * (vxl ** 2 + vyl ** 2 + vzl ** 2)
        er = pr / gm1 + 0.5 * dr * (vxr ** 2 + vyr ** 2 + vzr ** 2)
        hroe = ((el + pl) / sqrtdl + (er + pr) / sqrtdr) * isdlpdr
        cl = eos.hydro_sound_speed(dl, pl)
        cr = eos.hydro_sound_speed(dr, pr)
        a2 = hroe - 0.5 * (vx_roe ** 2 + vy_roe ** 2 + vz_roe ** 2)
        a = torch.sqrt(gm1 * torch.clamp(a2, min=0.0))
    else:
        cl = cr = a = eos.iso_cs

    al = torch.minimum(vx_roe - a, vxl - cl)
    ar = torch.maximum(vx_roe + a, vxr + cr)
    bp = torch.where(ar > 0.0, ar, _TINY)
    bm = torch.where(al < 0.0, al, -_TINY)

    qa = vxl - bm
    qb = vxr - bp
    fl_d = dl * qa
    fr_d = dr * qb
    fl_mx = dl * vxl * qa
    fr_mx = dr * vxr * qb
    fl_my = dl * vyl * qa
    fr_my = dr * vyr * qb
    fl_mz = dl * vzl * qa
    fr_mz = dr * vzr * qb
    if eos.is_ideal:
        fl_mx = fl_mx + pl
        fr_mx = fr_mx + pr
        fl_e = el * qa + pl * vxl
        fr_e = er * qb + pr * vxr
    else:
        fl_mx = fl_mx + eos.iso_cs ** 2 * dl
        fr_mx = fr_mx + eos.iso_cs ** 2 * dr

    qa = torch.where(bp != bm, 0.5 * (bp + bm) / (bp - bm), 0.0)

    fd = 0.5 * (fl_d + fr_d) + qa * (fl_d - fr_d)
    fmx = 0.5 * (fl_mx + fr_mx) + qa * (fl_mx - fr_mx)
    fmy = 0.5 * (fl_my + fr_my) + qa * (fl_my - fr_my)
    fmz = 0.5 * (fl_mz + fr_mz) + qa * (fl_mz - fr_mz)
    fe = 0.5 * (fl_e + fr_e) + qa * (fl_e - fr_e) if eos.is_ideal else None
    return _pack_flux(wl, eos, ivx, fd, fmx, fmy, fmz, fe)


# -------------------------------------------------------------------- HLLC
def hllc(wl, wr, eos: EOSData, ivx: int):
    """HLLC with PVRS wave-speed estimates (Toro 10.5.2; reference:
    src/hydro/rsolvers/hllc_hyd.hpp).  Ideal gas only."""
    if not eos.is_ideal:
        raise ValueError("HLLC requires an ideal-gas EOS")
    dl, vxl, vyl, vzl, pl = _unpack(wl, eos, ivx)
    dr, vxr, vyr, vzr, pr = _unpack(wr, eos, ivx)

    gm1 = eos.gamma - 1.0
    igm1 = 1.0 / gm1
    alpha = (eos.gamma + 1.0) / (2.0 * eos.gamma)

    cl = eos.hydro_sound_speed(dl, pl)
    cr = eos.hydro_sound_speed(dr, pr)
    el = pl * igm1 + 0.5 * dl * (vxl ** 2 + vyl ** 2 + vzl ** 2)
    er = pr * igm1 + 0.5 * dr * (vxr ** 2 + vyr ** 2 + vzr ** 2)

    # PVRS middle-state pressure estimate
    cbar = 0.25 * (dl + dr) * (cl + cr)
    pmid = 0.5 * (pl + pr + (vxl - vxr) * cbar)
    ql = torch.where(pmid <= pl, 1.0,
                     torch.sqrt(1.0 + alpha * (pmid / pl - 1.0)))
    qr = torch.where(pmid <= pr, 1.0,
                     torch.sqrt(1.0 + alpha * (pmid / pr - 1.0)))

    # extremal wave speeds
    al = vxl - cl * ql
    ar = vxr + cr * qr
    bp = torch.where(ar > 0.0, ar, _TINY)
    bm = torch.where(al < 0.0, al, -_TINY)

    # contact speed and pressure
    vxl_m = vxl - al
    vxr_m = vxr - ar
    tl = pl + vxl_m * dl * vxl
    tr = pr + vxr_m * dr * vxr
    ml = dl * vxl_m
    mr = -(dr * vxr_m)
    am = (tl - tr) / (ml + mr)
    cp = torch.clamp((ml * tr + mr * tl) / (ml + mr), min=0.0)

    # left/right fluxes along bm/bp
    qa = dl * (vxl - bm)
    qb = dr * (vxr - bp)
    fl_d, fr_d = qa, qb
    fl_mx = qa * vxl + pl
    fr_mx = qb * vxr + pr
    fl_my = qa * vyl
    fr_my = qb * vyr
    fl_mz = qa * vzl
    fr_mz = qb * vzr
    fl_e = el * (vxl - bm) + pl * vxl
    fr_e = er * (vxr - bp) + pr * vxr

    # flux weights by the contact's position
    pos = am >= 0.0
    wl_c = torch.where(pos, am / (am - bm), 0.0)
    wr_c = torch.where(pos, 0.0, -am / (bp - am))
    wc = torch.where(pos, -bm / (am - bm), bp / (bp - am))

    fd = wl_c * fl_d + wr_c * fr_d
    fmx = wl_c * fl_mx + wr_c * fr_mx + wc * cp
    fmy = wl_c * fl_my + wr_c * fr_my
    fmz = wl_c * fl_mz + wr_c * fr_mz
    fe = wl_c * fl_e + wr_c * fr_e + wc * cp * am
    return _pack_flux(wl, eos, ivx, fd, fmx, fmy, fmz, fe)


# --------------------------------------------------------------------- Roe
def roe(wl, wr, eos: EOSData, ivx: int):
    """Roe's linearised solver with the LLF fallback on a negative
    intermediate density (reference: src/hydro/rsolvers/roe_hyd.hpp)."""
    dl, vxl, vyl, vzl, pl = _unpack(wl, eos, ivx)
    dr, vxr, vyr, vzr, pr = _unpack(wr, eos, ivx)

    sqrtdl = torch.sqrt(dl)
    sqrtdr = torch.sqrt(dr)
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    v1 = (sqrtdl * vxl + sqrtdr * vxr) * isdlpdr
    v2 = (sqrtdl * vyl + sqrtdr * vyr) * isdlpdr
    v3 = (sqrtdl * vzl + sqrtdr * vzr) * isdlpdr

    mxl = dl * vxl
    mxr = dr * vxr
    fl_d, fr_d = mxl, mxr
    fl_mx = mxl * vxl
    fr_mx = mxr * vxr
    fl_my = mxl * vyl
    fr_my = mxr * vyr
    fl_mz = mxl * vzl
    fr_mz = mxr * vzr

    du0 = dr - dl
    du1 = dr * vxr - dl * vxl
    du2 = dr * vyr - dl * vyl
    du3 = dr * vzr - dl * vzl

    where = torch.where
    if eos.is_ideal:
        gm1 = eos.gamma - 1.0
        el = pl / gm1 + 0.5 * dl * (vxl ** 2 + vyl ** 2 + vzl ** 2)
        er = pr / gm1 + 0.5 * dr * (vxr ** 2 + vyr ** 2 + vzr ** 2)
        h = ((el + pl) / sqrtdl + (er + pr) / sqrtdr) * isdlpdr
        fl_mx = fl_mx + pl
        fr_mx = fr_mx + pr
        fl_e = (el + pl) * vxl
        fr_e = (er + pr) * vxr
        du4 = er - el

        vsq = v1 * v1 + v2 * v2 + v3 * v3
        q = h - 0.5 * vsq
        cs_sq = torch.where(q < 0.0, _TINY32, gm1 * q)
        cs = torch.sqrt(cs_sq)

        ev0 = v1 - cs
        ev4 = v1 + cs

        na = 0.5 / cs_sq
        a0 = na * (du0 * (0.5 * gm1 * vsq + v1 * cs)
                   - du1 * (gm1 * v1 + cs) - du2 * gm1 * v2
                   - du3 * gm1 * v3 + du4 * gm1)
        a1 = du0 * (-v2) + du2
        a2 = du0 * (-v3) + du3
        qa = gm1 / cs_sq
        a3 = (du0 * (1.0 - na * gm1 * vsq) + du1 * qa * v1 + du2 * qa * v2
              + du3 * qa * v3 - du4 * qa)
        a4 = na * (du0 * (0.5 * gm1 * vsq - v1 * cs)
                   - du1 * (gm1 * v1 - cs) - du2 * gm1 * v2
                   - du3 * gm1 * v3 + du4 * gm1)

        c0 = -0.5 * torch.abs(ev0) * a0
        c1 = -0.5 * torch.abs(v1) * a1
        c2 = -0.5 * torch.abs(v1) * a2
        c3 = -0.5 * torch.abs(v1) * a3
        c4 = -0.5 * torch.abs(ev4) * a4

        llf_flag = (dl + a0 < 0.0) | (dl + a0 + a3 < 0.0)

        fd = 0.5 * (fl_d + fr_d) + c0 + c3 + c4
        fmx = (0.5 * (fl_mx + fr_mx) + c0 * (v1 - cs) + c3 * v1
               + c4 * (v1 + cs))
        fmy = 0.5 * (fl_my + fr_my) + c0 * v2 + c1 + c3 * v2 + c4 * v2
        fmz = 0.5 * (fl_mz + fr_mz) + c0 * v3 + c2 + c3 * v3 + c4 * v3
        fe = (0.5 * (fl_e + fr_e) + c0 * (h - v1 * cs) + c1 * v2 + c2 * v3
              + c3 * 0.5 * vsq + c4 * (h + v1 * cs))

        # upwind flux when fully supersonic
        fd = where(ev0 >= 0.0, fl_d, where(ev4 <= 0.0, fr_d, fd))
        fmx = where(ev0 >= 0.0, fl_mx, where(ev4 <= 0.0, fr_mx, fmx))
        fmy = where(ev0 >= 0.0, fl_my, where(ev4 <= 0.0, fr_my, fmy))
        fmz = where(ev0 >= 0.0, fl_mz, where(ev4 <= 0.0, fr_mz, fmz))
        fe = where(ev0 >= 0.0, fl_e, where(ev4 <= 0.0, fr_e, fe))

        # LLF fallback
        cl_s = eos.hydro_sound_speed(dl, pl)
        cr_s = eos.hydro_sound_speed(dr, pr)
        a = 0.5 * torch.maximum(torch.abs(vxl) + cl_s,
                                torch.abs(vxr) + cr_s)
        fd = where(llf_flag, 0.5 * (fl_d + fr_d) - a * du0, fd)
        fmx = where(llf_flag, 0.5 * (fl_mx + fr_mx) - a * du1, fmx)
        fmy = where(llf_flag, 0.5 * (fl_my + fr_my) - a * du2, fmy)
        fmz = where(llf_flag, 0.5 * (fl_mz + fr_mz) - a * du3, fmz)
        fe = where(llf_flag, 0.5 * (fl_e + fr_e) - a * du4, fe)
    else:
        iso_cs = eos.iso_cs
        fl_mx = fl_mx + iso_cs ** 2 * dl
        fr_mx = fr_mx + iso_cs ** 2 * dr
        ev0 = v1 - iso_cs
        ev3 = v1 + iso_cs
        a0 = du0 * (0.5 + 0.5 * v1 / iso_cs) - du1 * 0.5 / iso_cs
        a1 = du0 * (-v2) + du2
        a2 = du0 * (-v3) + du3
        a3 = du0 * (0.5 - 0.5 * v1 / iso_cs) + du1 * 0.5 / iso_cs

        c0 = -0.5 * torch.abs(ev0) * a0
        c1 = -0.5 * torch.abs(v1) * a1
        c2 = -0.5 * torch.abs(v1) * a2
        c3 = -0.5 * torch.abs(ev3) * a3

        llf_flag = (dl + a0 < 0.0) | (dl + a0 + a3 < 0.0)

        fd = 0.5 * (fl_d + fr_d) + c0 + c3
        fmx = (0.5 * (fl_mx + fr_mx) + c0 * (v1 - iso_cs)
               + c3 * (v1 + iso_cs))
        fmy = 0.5 * (fl_my + fr_my) + c0 * v2 + c1 + c3 * v2
        fmz = 0.5 * (fl_mz + fr_mz) + c0 * v3 + c2 + c3 * v3
        fe = None

        fd = where(ev0 >= 0.0, fl_d, where(ev3 <= 0.0, fr_d, fd))
        fmx = where(ev0 >= 0.0, fl_mx, where(ev3 <= 0.0, fr_mx, fmx))
        fmy = where(ev0 >= 0.0, fl_my, where(ev3 <= 0.0, fr_my, fmy))
        fmz = where(ev0 >= 0.0, fl_mz, where(ev3 <= 0.0, fr_mz, fmz))

        a = 0.5 * torch.maximum(torch.abs(vxl) + iso_cs,
                                torch.abs(vxr) + iso_cs)
        fd = where(llf_flag, 0.5 * (fl_d + fr_d) - a * du0, fd)
        fmx = where(llf_flag, 0.5 * (fl_mx + fr_mx) - a * du1, fmx)
        fmy = where(llf_flag, 0.5 * (fl_my + fr_my) - a * du2, fmy)
        fmz = where(llf_flag, 0.5 * (fl_mz + fr_mz) - a * du3, fmz)

    return _pack_flux(wl, eos, ivx, fd, fmx, fmy, fmz, fe)


# ------------------------------------------------------------------ advect
def advect(wl, wr, eos: EOSData, ivx: int):
    """Pure advection (kinematic problems): the upwind density and scalar
    fluxes, zero momentum and energy fluxes (reference:
    src/hydro/rsolvers/advect_hyd.hpp)."""
    dl = wl[..., IDN, :, :, :]
    dr = wr[..., IDN, :, :, :]
    vxl = wl[..., ivx, :, :, :]
    vxr = wr[..., ivx, :, :, :]
    fd = torch.where(vxl >= 0.0, dl * vxl, dr * vxr)
    flx = torch.zeros_like(wl)
    flx[..., IDN, :, :, :] = fd
    nfluid = eos.nfluid
    if wl.shape[-4] > nfluid:
        f = fd.unsqueeze(-4)
        flx[..., nfluid:, :, :, :] = torch.where(
            f >= 0.0, f * wl[..., nfluid:, :, :, :],
            f * wr[..., nfluid:, :, :, :])
    return flx


HYDRO_RSOLVER_FNS = {"llf": llf, "hlle": hlle, "hllc": hllc, "roe": roe,
                     "advect": advect}
