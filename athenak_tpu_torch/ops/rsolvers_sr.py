"""Riemann solvers for special-relativistic hydrodynamics: LLF, HLLE, HLLC.

Counterpart of ``athenak_tpu/ops/rsolvers_sr.py`` (reference:
src/hydro/rsolvers/{llf,hlle,hllc}_srhyd.hpp), on whole face tensors with
the JAX package's order of terms.  The left/right states are SR
primitives (rho, u^i, e) ``[..., nvar, n3, n2, n1]``; each solver returns
the fluxes of (D, M_i, tau = E - D) in the layout of ``wl``, zeros in the
scalar slots for the caller's upwind scalar flux.
"""

from __future__ import annotations

import torch

from ..indices import IDN, IEN, IVX
from .eos import EOSData
from .eos_sr import sr_hydro_sound_speeds


def _vel_idx(ivx: int):
    ivy = IVX + ((ivx - IVX) + 1) % 3
    ivz = IVX + ((ivx - IVX) + 2) % 3
    return ivy, ivz


def _states(w, eos: EOSData, ivx: int):
    """(rho, u^x, u^y, u^z, u^0, p, enthalpy density) in the frame of
    the face."""
    ivy, ivz = _vel_idx(ivx)
    rho = w[..., IDN, :, :, :]
    ux = w[..., ivx, :, :, :]
    uy = w[..., ivy, :, :, :]
    uz = w[..., ivz, :, :, :]
    u0 = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    p = eos.pressure(w[..., IEN, :, :, :])
    wgas = rho + eos.gamma / (eos.gamma - 1.0) * p
    return rho, ux, uy, uz, u0, p, wgas


def _cons_flux(rho, ux, uy, uz, u0, p, wgas):
    """(cons, flux) tuples with E (not tau) in the energy slot
    (MB2005 eqs. 2-3)."""
    cons = (rho * u0, wgas * ux * u0, wgas * uy * u0, wgas * uz * u0,
            wgas * u0 * u0 - p)
    flux = (rho * ux, wgas * ux * ux + p, wgas * uy * ux, wgas * uz * ux,
            wgas * u0 * ux)
    return cons, flux


def _pack(template, ivx, fd, fmx, fmy, fmz, fe):
    """Stack the fluxes in conserved order with the tau flux E - D and
    zeros in the scalar slots."""
    ivy, ivz = _vel_idx(ivx)
    mom = {ivx: fmx, ivy: fmy, ivz: fmz}
    chans = [fd, mom[1], mom[2], mom[3], fe - fd]
    while len(chans) < template.shape[-4]:
        chans.append(torch.zeros_like(fd))
    return torch.stack(chans, dim=-4)


def _speeds(eos, s):
    return sr_hydro_sound_speeds(eos, s[0], s[5], s[1], s[4])


def llf_sr(wl, wr, eos: EOSData, ivx: int):
    """(reference: src/hydro/rsolvers/llf_srhyd.hpp)"""
    sl, sr_ = _states(wl, eos, ivx), _states(wr, eos, ivx)
    consl, fluxl = _cons_flux(*sl)
    consr, fluxr = _cons_flux(*sr_)
    lp_l, lm_l = _speeds(eos, sl)
    lp_r, lm_r = _speeds(eos, sr_)
    a = torch.maximum(torch.maximum(torch.abs(lm_l), torch.abs(lp_l)),
                      torch.maximum(torch.abs(lm_r), torch.abs(lp_r)))
    out = [0.5 * (fl + fr) - 0.5 * a * (cr - cl)
           for fl, fr, cl, cr in zip(fluxl, fluxr, consl, consr)]
    return _pack(wl, ivx, *out)


def hlle_sr(wl, wr, eos: EOSData, ivx: int):
    """(reference: src/hydro/rsolvers/hlle_srhyd.hpp:25-165)"""
    sl, sr_ = _states(wl, eos, ivx), _states(wr, eos, ivx)
    consl, fluxl = _cons_flux(*sl)
    consr, fluxr = _cons_flux(*sr_)
    lp_l, lm_l = _speeds(eos, sl)
    lp_r, lm_r = _speeds(eos, sr_)
    lam_l = torch.minimum(lm_l, lm_r)
    lam_r = torch.maximum(lp_l, lp_r)
    qa = lam_r * lam_l
    qb = 1.0 / (lam_r - lam_l + 1.0e-300)
    out = []
    for fl, fr, cl, cr in zip(fluxl, fluxr, consl, consr):
        hll = (lam_r * fl - lam_l * fr + qa * (cr - cl)) * qb
        out.append(torch.where(lam_l >= 0.0, fl,
                               torch.where(lam_r <= 0.0, fr, hll)))
    return _pack(wl, ivx, *out)


def hllc_sr(wl, wr, eos: EOSData, ivx: int):
    """(reference: src/hydro/rsolvers/hllc_srhyd.hpp:25-200, Mignone &
    Bodo 2005/2006)."""
    where = torch.where
    sl, sr_ = _states(wl, eos, ivx), _states(wr, eos, ivx)
    _, ux_l, _, _, u0_l, p_l, _ = sl
    _, ux_r, _, _, u0_r, p_r, _ = sr_
    consl, fluxl = _cons_flux(*sl)
    consr, fluxr = _cons_flux(*sr_)
    lp_l, lm_l = _speeds(eos, sl)
    lp_r, lm_r = _speeds(eos, sr_)
    lam_l = torch.minimum(lm_l, lm_r)
    lam_r = torch.maximum(lp_l, lp_r)

    ldi = 1.0 / (lam_r - lam_l + 1.0e-300)
    # HLL state (MB2005 9) and flux (MB2005 11); order (D, Mx, My, Mz, E)
    cons_hll = [(lam_r * cr - lam_l * cl + fl - fr) * ldi
                for fl, fr, cl, cr in zip(fluxl, fluxr, consl, consr)]
    flux_hll = [(lam_r * fl - lam_l * fr + lam_l * lam_r * (cr - cl)) * ldi
                for fl, fr, cl, cr in zip(fluxl, fluxr, consl, consr)]

    # contact speed (MB2005 18) by the cancellation-safe quadratic root
    e_hll, mx_hll = cons_hll[4], cons_hll[1]
    fe_hll, fmx_hll = flux_hll[4], flux_hll[1]
    b = -(e_hll + fmx_hll)
    disc = torch.sqrt(torch.clamp(b * b - 4.0 * fe_hll * mx_hll, min=0.0))
    lam_star_quad = -2.0 * mx_hll / (b - disc - 1.0e-300)
    lam_star_lin = -mx_hll / (b + 1.0e-300)
    use_quad = torch.abs(fe_hll - flux_hll[0]) > 1.0e-12
    lam_star = where(use_quad, lam_star_quad, lam_star_lin)

    # contact pressure (MB2006 48)
    p_star = -fe_hll * lam_star + fmx_hll

    def star(cons, flux, lam, vx_ratio, p_side):
        ldinv = 1.0 / (lam - lam_star + 1.0e-300)
        cs = [c * (lam - vx_ratio) for c in cons]
        cs[4] = cs[4] + p_star * lam_star - p_side * vx_ratio
        cs[1] = cs[1] + p_star - p_side
        cs = [c * ldinv for c in cs]
        return [f + lam * (s - c) for f, s, c in zip(flux, cs, cons)]

    flux_lstar = star(consl, fluxl, lam_l, ux_l / u0_l, p_l)
    flux_rstar = star(consr, fluxr, lam_r, ux_r / u0_r, p_r)

    out = [where(lam_l >= 0.0, fl,
                 where(lam_r <= 0.0, fr, where(lam_star >= 0.0, fls, frs)))
           for fl, fr, fls, frs in zip(fluxl, fluxr, flux_lstar,
                                       flux_rstar)]
    return _pack(wl, ivx, *out)


SR_HYDRO_RSOLVER_FNS = {"llf": llf_sr, "hlle": hlle_sr, "hllc": hllc_sr}
