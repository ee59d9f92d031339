"""Riemann solvers for GR hydrodynamics on a stationary spacetime: LLF
and HLLE.

Counterpart of ``athenak_tpu/ops/rsolvers_gr.py`` (reference:
src/hydro/rsolvers/{llf,hlle}_grhyd.hpp), on torch tensors with the face
metric as nested 4x4 lists of tensors (``coordinates.GRGeometry``;
sqrt(-g) = 1 in CKS).  Primitives are (rho, utilde^i, e); the fluxes are
those of the conserved (D, T^0_i, T^0_0 + D).  Signature:
``solve(wl, wr, eos, ivx, glower, gupper) -> flux``.
"""

from __future__ import annotations

import torch

from ..indices import IDN, IEN, IVX
from .eos import EOSData


def _vel_idx(ivx: int):
    ivy = IVX + ((ivx - IVX) + 1) % 3
    ivz = IVX + ((ivx - IVX) + 2) % 3
    return ivy, ivz


def gr_sound_speeds(eos: EOSData, d, p, u0, u1, g00, g01, g11):
    """Characteristic speeds along one axis (reference:
    IdealGRHydroSoundSpeeds, eos.hpp:127-158)."""
    cs_sq = eos.gamma * p / (d + eos.gamma * p / (eos.gamma - 1.0))
    a = u0 * u0 - (g00 + u0 * u0) * cs_sq
    b = -2.0 * (u0 * u1 - (g01 + u0 * u1) * cs_sq)
    c = u1 * u1 - (g11 + u1 * u1) * cs_sq
    ds = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))
    r1 = (-b + ds) / (2.0 * a)
    r2 = (-b - ds) / (2.0 * a)
    return torch.maximum(r1, r2), torch.minimum(r1, r2)


def _four_velocity(w, glower, gupper):
    """u^mu and u_mu from utilde primitives (reference:
    hlle_grhyd.hpp:80-130)."""
    wv = {1: w[..., IVX, :, :, :], 2: w[..., IVX + 1, :, :, :],
          3: w[..., IVX + 2, :, :, :]}
    q = None
    for i in (1, 2, 3):
        for j in (1, 2, 3):
            t = glower[i][j] * wv[i] * wv[j]
            q = t if q is None else q + t
    alpha = torch.sqrt(-1.0 / gupper[0][0])
    gam = torch.sqrt(1.0 + q)
    uu = {0: gam / alpha}
    for i in (1, 2, 3):
        uu[i] = wv[i] - alpha * gam * gupper[0][i]
    ul = {}
    for mu in range(4):
        s = None
        for nu in range(4):
            t = glower[mu][nu] * uu[nu]
            s = t if s is None else s + t
        ul[mu] = s
    return uu, ul


def _cons_flux_gr(w, eos: EOSData, uu, ul, ivx):
    ivy, ivz = _vel_idx(ivx)
    ax, ay, az = ivx - IVX + 1, ivy - IVX + 1, ivz - IVX + 1
    rho = w[..., IDN, :, :, :]
    p = eos.pressure(w[..., IEN, :, :, :])
    wgas = rho + eos.gamma / (eos.gamma - 1.0) * p
    qa = wgas * uu[0]
    cons = (rho * uu[0], qa * ul[ax], qa * ul[ay], qa * ul[az],
            qa * ul[0] + p)
    qf = wgas * uu[ax]
    flux = (rho * uu[ax], qf * ul[ax] + p, qf * ul[ay], qf * ul[az],
            qf * ul[0])
    return cons, flux, p


def _pack_gr(template, ivx, f):
    """The flux channels in the state's order; tau = T^0_0 + D
    (reference: hlle_grhyd.hpp:204).  Scalar channels are zero."""
    ivy, ivz = _vel_idx(ivx)
    chans = [None] * 5
    chans[IDN], chans[ivx], chans[ivy], chans[ivz] = f[0], f[1], f[2], f[3]
    chans[IEN] = f[4] + f[0]
    flx = torch.stack(chans, dim=-4)
    nextra = template.shape[-4] - 5
    if nextra > 0:
        shp = list(flx.shape)
        shp[-4] = nextra
        flx = torch.cat([flx, flx.new_zeros(shp)], dim=-4)
    return flx


def _speeds(wl, wr, eos, uul, uur, pl, pr, ivx, gupper):
    ax = ivx - IVX + 1
    g00, g01, g11 = gupper[0][0], gupper[0][ax], gupper[ax][ax]
    lp_l, lm_l = gr_sound_speeds(eos, wl[..., IDN, :, :, :], pl, uul[0],
                                 uul[ax], g00, g01, g11)
    lp_r, lm_r = gr_sound_speeds(eos, wr[..., IDN, :, :, :], pr, uur[0],
                                 uur[ax], g00, g01, g11)
    return lp_l, lm_l, lp_r, lm_r


def llf_gr(wl, wr, eos: EOSData, ivx: int, glower, gupper):
    """(reference: src/hydro/rsolvers/llf_grhyd.hpp)."""
    uul, ull = _four_velocity(wl, glower, gupper)
    uur, ulr = _four_velocity(wr, glower, gupper)
    consl, fluxl, pl = _cons_flux_gr(wl, eos, uul, ull, ivx)
    consr, fluxr, pr = _cons_flux_gr(wr, eos, uur, ulr, ivx)
    lp_l, lm_l, lp_r, lm_r = _speeds(wl, wr, eos, uul, uur, pl, pr, ivx,
                                     gupper)
    lam = torch.maximum(torch.maximum(lp_l, lp_r),
                        -torch.minimum(lm_l, lm_r))
    out = tuple(0.5 * (fl + fr - lam * (cr - cl))
                for fl, fr, cl, cr in zip(fluxl, fluxr, consl, consr))
    return _pack_gr(wl, ivx, out)


def hlle_gr(wl, wr, eos: EOSData, ivx: int, glower, gupper):
    """(reference: src/hydro/rsolvers/hlle_grhyd.hpp:25-205)."""
    uul, ull = _four_velocity(wl, glower, gupper)
    uur, ulr = _four_velocity(wr, glower, gupper)
    consl, fluxl, pl = _cons_flux_gr(wl, eos, uul, ull, ivx)
    consr, fluxr, pr = _cons_flux_gr(wr, eos, uur, ulr, ivx)
    lp_l, lm_l, lp_r, lm_r = _speeds(wl, wr, eos, uul, uur, pl, pr, ivx,
                                     gupper)
    lam_l = torch.minimum(lm_l, lm_r)
    lam_r = torch.maximum(lp_l, lp_r)
    qa = lam_r * lam_l
    qb = 1.0 / (lam_r - lam_l + 1.0e-300)
    out = []
    for fl, fr, cl, cr in zip(fluxl, fluxr, consl, consr):
        hll = (lam_r * fl - lam_l * fr + qa * (cr - cl)) * qb
        out.append(torch.where(lam_l >= 0.0, fl,
                               torch.where(lam_r <= 0.0, fr, hll)))
    return _pack_gr(wl, ivx, tuple(out))


GR_HYDRO_RSOLVER_FNS = {"llf": llf_gr, "hlle": hlle_gr}
