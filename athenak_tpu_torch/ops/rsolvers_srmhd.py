"""Riemann solvers for special-relativistic MHD: LLF and HLLE.

Counterpart of ``athenak_tpu/ops/rsolvers_srmhd.py`` (reference:
src/mhd/rsolvers/llf_mhd_singlestate.hpp:92-190, hlle_srmhd.hpp), on
whole face tensors.  The interface is that of ``rsolvers_mhd.hlld``:
``solve(wl, wr, bl, br, bx, eos, ivx) -> (flux, ey, ez)`` with the flux
of (D, M_i, tau) and the face EMFs for CT.  ``csrc/srmhd.cuh`` carries
the same arithmetic, line for line, for the stage kernel.
"""

from __future__ import annotations

import torch

from ..indices import IDN, IEN, IVX
from .eos import EOSData
from .eos_sr import sr_mhd_fast_speeds


def _vel_idx(ivx: int):
    ivy = IVX + ((ivx - IVX) + 1) % 3
    ivz = IVX + ((ivx - IVX) + 2) % 3
    return ivy, ivz


def _state(w, bt, bx, eos: EOSData, ivx: int):
    """One side of the face: (d, vx, gamma, p, b^2, cons, flux) with the
    7-tuples cons and flux ordered (D, Mx, My, Mz, E, By, Bz) in the
    frame of the face."""
    ivy, ivz = _vel_idx(ivx)
    iby = ((ivx - IVX) + 1) % 3
    ibz = ((ivx - IVX) + 2) % 3
    d = w[..., IDN, :, :, :]
    vx = w[..., ivx, :, :, :]
    vy = w[..., ivy, :, :, :]
    vz = w[..., ivz, :, :, :]
    e = w[..., IEN, :, :, :]
    by = bt[..., iby, :, :, :]
    bz = bt[..., ibz, :, :, :]

    gam = torch.sqrt(1.0 + vx * vx + vy * vy + vz * vz)
    b0 = bx * vx + by * vy + bz * vz
    b1 = (bx + b0 * vx) / gam
    b2 = (by + b0 * vy) / gam
    b3 = (bz + b0 * vz) / gam
    b_sq = -b0 * b0 + b1 * b1 + b2 * b2 + b3 * b3

    p = eos.pressure(e)
    wgas = d + eos.gamma * e
    wtot = wgas + b_sq
    ptot = p + 0.5 * b_sq

    cons = (d * gam,
            wtot * vx * gam - b1 * b0,
            wtot * vy * gam - b2 * b0,
            wtot * vz * gam - b3 * b0,
            wtot * gam * gam - b0 * b0 - ptot,
            b2 * gam - b0 * vy,
            b3 * gam - b0 * vz)
    flux = (d * vx,
            wtot * vx * vx - b1 * b1 + ptot,
            wtot * vy * vx - b2 * b1,
            wtot * vz * vx - b3 * b1,
            wtot * gam * vx - b0 * b1,
            b2 * vx - b1 * vy,
            b3 * vx - b1 * vz)
    return d, vx, gam, p, b_sq, cons, flux


def _pack(ivx: int, f):
    """f = (fD, fMx, fMy, fMz, fE, fBy, fBz) -> (flux5, ey, ez) with the
    EMF signs of the Newtonian solvers: ey = -F(By), ez = +F(Bz)
    (reference: llf_mhd_singlestate.hpp:183-184)."""
    ivy, ivz = _vel_idx(ivx)
    parts = [None] * 5
    parts[IDN] = f[0]
    parts[ivx] = f[1]
    parts[ivy] = f[2]
    parts[ivz] = f[3]
    parts[IEN] = f[4] - f[0]  # tau = E - D
    return torch.stack(parts, dim=-4), -f[5], f[6]


def _speeds(wl, wr, bl, br, bx, eos: EOSData, ivx: int):
    dl, vxl, gaml, pl, bsql, consl, fluxl = _state(wl, bl, bx, eos, ivx)
    dr, vxr, gamr, pr, bsqr, consr, fluxr = _state(wr, br, bx, eos, ivx)
    lp_l, lm_l = sr_mhd_fast_speeds(eos, dl, pl, vxl, gaml, bsql)
    lp_r, lm_r = sr_mhd_fast_speeds(eos, dr, pr, vxr, gamr, bsqr)
    lam_l = torch.minimum(lm_l, lm_r)
    lam_r = torch.maximum(lp_l, lp_r)
    return lam_l, lam_r, consl, consr, fluxl, fluxr


def llf_srmhd(wl, wr, bl, br, bx, eos: EOSData, ivx: int):
    """(reference: SingleStateLLF_SRMHD,
    llf_mhd_singlestate.hpp:92-190)."""
    lam_l, lam_r, consl, consr, fluxl, fluxr = _speeds(
        wl, wr, bl, br, bx, eos, ivx)
    lam = torch.maximum(lam_r, -lam_l)
    out = tuple(0.5 * (fl + fr - lam * (cr - cl))
                for fl, fr, cl, cr in zip(fluxl, fluxr, consl, consr))
    return _pack(ivx, out)


def hlle_srmhd(wl, wr, bl, br, bx, eos: EOSData, ivx: int):
    """(reference: src/mhd/rsolvers/hlle_srmhd.hpp).  The 1e-300 guard of
    the JAX package rounds to 0 in float32, as it does there."""
    lam_l, lam_r, consl, consr, fluxl, fluxr = _speeds(
        wl, wr, bl, br, bx, eos, ivx)
    qa = lam_r * lam_l
    qb = 1.0 / (lam_r - lam_l + 1.0e-300)
    out = []
    for fl, fr, cl, cr in zip(fluxl, fluxr, consl, consr):
        hll = (lam_r * fl - lam_l * fr + qa * (cr - cl)) * qb
        out.append(torch.where(lam_l >= 0.0, fl,
                               torch.where(lam_r <= 0.0, fr, hll)))
    return _pack(ivx, tuple(out))


SR_MHD_RSOLVER_FNS = {"llf": llf_srmhd, "hlle": hlle_srmhd}
