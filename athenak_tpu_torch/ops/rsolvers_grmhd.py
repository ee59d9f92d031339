"""Riemann solvers for GR MHD on a stationary spacetime: LLF and HLLE.

Counterpart of ``athenak_tpu/ops/rsolvers_grmhd.py`` (reference:
src/mhd/rsolvers/llf_mhd_singlestate.hpp:196-396, hlle_grmhd.hpp), on
torch tensors with the face metric as nested 4x4 lists of tensors.
Signature as the other MHD solvers with the metric added:
``solve(wl, wr, bl, br, bx, eos, ivx, glower, gupper) -> (flux, ey,
ez)``.
"""

from __future__ import annotations

import torch

from ..indices import IDN, IEN, IVX
from .eos import EOSData
from .rsolvers_gr import _pack_gr, _vel_idx


def gr_mhd_fast_speeds(eos: EOSData, d, p, u0, u1, b_sq, g00, g01, g11):
    """(reference: IdealGRMHDFastSpeeds, eos.hpp:172-191)."""
    w = d + eos.gamma * p / (eos.gamma - 1.0)
    cs_sq = eos.gamma * p / w
    va_sq = b_sq / (b_sq + w)
    cms = cs_sq + va_sq - cs_sq * va_sq
    a = u0 * u0 - (g00 + u0 * u0) * cms
    b = -2.0 * (u0 * u1 - (g01 + u0 * u1) * cms)
    c = u1 * u1 - (g11 + u1 * u1) * cms
    a1 = b / a
    a0 = c / a
    s = torch.sqrt(torch.clamp(a1 * a1 - 4.0 * a0, min=0.0))
    pos = a1 >= 0.0
    lp = torch.where(pos, -2.0 * a0 / (a1 + s), 0.5 * (-a1 + s))
    lm = torch.where(pos, 0.5 * (-a1 - s), -2.0 * a0 / (a1 - s))
    return lp, lm


def _state_gr(w, bt, bx, eos: EOSData, ivx, glower, gupper):
    """One side: 4-velocity, 4-field, conserved and flux (reference:
    llf_mhd_singlestate.hpp:233-381)."""
    ivy, ivz = _vel_idx(ivx)
    iby = ((ivx - IVX) + 1) % 3
    ibz = ((ivx - IVX) + 2) % 3
    rho = w[..., IDN, :, :, :]
    p = eos.pressure(w[..., IEN, :, :, :])
    wv = {ivx: w[..., ivx, :, :, :], ivy: w[..., ivy, :, :, :],
          ivz: w[..., ivz, :, :, :]}
    by = bt[..., iby, :, :, :]
    bz = bt[..., ibz, :, :, :]
    ax, ay, az = ivx - IVX + 1, ivy - IVX + 1, ivz - IVX + 1

    q = (glower[ax][ax] * wv[ivx] ** 2 + glower[ay][ay] * wv[ivy] ** 2
         + glower[az][az] * wv[ivz] ** 2
         + 2.0 * (glower[ax][ay] * wv[ivx] * wv[ivy]
                  + glower[ax][az] * wv[ivx] * wv[ivz]
                  + glower[ay][az] * wv[ivy] * wv[ivz]))
    alpha = torch.sqrt(-1.0 / gupper[0][0])
    gam = torch.sqrt(1.0 + q)
    uu = {0: gam / alpha,
          ax: wv[ivx] - alpha * gam * gupper[0][ax],
          ay: wv[ivy] - alpha * gam * gupper[0][ay],
          az: wv[ivz] - alpha * gam * gupper[0][az]}

    def lower(vec):
        out = {}
        for mu in (0, ax, ay, az):
            s = None
            for nu in (0, ax, ay, az):
                t = glower[mu][nu] * vec[nu]
                s = t if s is None else s + t
            out[mu] = s
        return out

    ul = lower(uu)
    bu = {0: ul[ax] * bx + ul[ay] * by + ul[az] * bz}
    bu[ax] = (bx + bu[0] * uu[ax]) / uu[0]
    bu[ay] = (by + bu[0] * uu[ay]) / uu[0]
    bu[az] = (bz + bu[0] * uu[az]) / uu[0]
    bl = lower(bu)
    bsq = (bl[0] * bu[0] + bl[ax] * bu[ax] + bl[ay] * bu[ay]
           + bl[az] * bu[az])

    wtot = rho + eos.gamma / (eos.gamma - 1.0) * p + bsq
    ptot = p + 0.5 * bsq
    qa = wtot * uu[0]
    cons = (rho * uu[0],
            qa * ul[ax] - bu[0] * bl[ax],
            qa * ul[ay] - bu[0] * bl[ay],
            qa * ul[az] - bu[0] * bl[az],
            qa * ul[0] - bu[0] * bl[0] + ptot,
            bu[ay] * uu[0] - bu[0] * uu[ay],
            bu[az] * uu[0] - bu[0] * uu[az])
    qf = wtot * uu[ax]
    flux = (rho * uu[ax],
            qf * ul[ax] - bu[ax] * bl[ax] + ptot,
            qf * ul[ay] - bu[ax] * bl[ay],
            qf * ul[az] - bu[ax] * bl[az],
            qf * ul[0] - bu[ax] * bl[0],
            bu[ay] * uu[ax] - bu[ax] * uu[ay],
            bu[az] * uu[ax] - bu[ax] * uu[az])
    return rho, p, uu, bsq, cons, flux, ax


def _speeds(sl, sr, eos, gupper):
    dl, pl, uul, bsql, _, _, ax = sl
    dr, pr, uur, bsqr, _, _, _ = sr
    g00, g01, g11 = gupper[0][0], gupper[0][ax], gupper[ax][ax]
    lp_l, lm_l = gr_mhd_fast_speeds(eos, dl, pl, uul[0], uul[ax], bsql,
                                    g00, g01, g11)
    lp_r, lm_r = gr_mhd_fast_speeds(eos, dr, pr, uur[0], uur[ax], bsqr,
                                    g00, g01, g11)
    return lp_l, lm_l, lp_r, lm_r


def _pack(template, ivx, f):
    """(flux, ey, ez): ey = -F(B_trans1), ez = +F(B_trans2)."""
    return _pack_gr(template, ivx, f[:5]), -f[5], f[6]


def llf_grmhd(wl, wr, bl, br, bx, eos: EOSData, ivx: int, glower, gupper):
    """(reference: SingleStateLLF_GRMHD,
    llf_mhd_singlestate.hpp:196-396)."""
    sl = _state_gr(wl, bl, bx, eos, ivx, glower, gupper)
    sr = _state_gr(wr, br, bx, eos, ivx, glower, gupper)
    lp_l, lm_l, lp_r, lm_r = _speeds(sl, sr, eos, gupper)
    lam = torch.maximum(torch.maximum(lp_l, lp_r),
                        -torch.minimum(lm_l, lm_r))
    out = tuple(0.5 * (fl + fr - lam * (cr - cl))
                for fl, fr, cl, cr in zip(sl[5], sr[5], sl[4], sr[4]))
    return _pack(wl, ivx, out)


def hlle_grmhd(wl, wr, bl, br, bx, eos: EOSData, ivx: int, glower,
               gupper):
    """(reference: src/mhd/rsolvers/hlle_grmhd.hpp)."""
    sl = _state_gr(wl, bl, bx, eos, ivx, glower, gupper)
    sr = _state_gr(wr, br, bx, eos, ivx, glower, gupper)
    lp_l, lm_l, lp_r, lm_r = _speeds(sl, sr, eos, gupper)
    lam_l = torch.minimum(lm_l, lm_r)
    lam_r = torch.maximum(lp_l, lp_r)
    qa = lam_r * lam_l
    qb = 1.0 / (lam_r - lam_l + 1.0e-300)
    out = []
    for fl, fr, cl, cr in zip(sl[5], sr[5], sl[4], sr[4]):
        hll = (lam_r * fl - lam_l * fr + qa * (cr - cl)) * qb
        out.append(torch.where(lam_l >= 0.0, fl,
                               torch.where(lam_r <= 0.0, fr, hll)))
    return _pack(wl, ivx, tuple(out))


GR_MHD_RSOLVER_FNS = {"llf": llf_grmhd, "hlle": hlle_grmhd}
