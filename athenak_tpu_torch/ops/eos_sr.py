"""Special-relativistic ideal-gas EOS, hydro and MHD: c2p, p2c and wave
speeds.

Counterpart of ``athenak_tpu/ops/eos_sr.py`` (reference:
src/eos/ideal_c2p_hyd.hpp:91-243, src/eos/ideal_c2p_mhd.hpp SR parts,
eos.hpp:81-111), on torch tensors laid out ``[..., nvar, n3, n2, n1]``.
Conventions:

  primitives  w = (rho, u^i, e)   u^i = gamma v^i spatial 4-velocity,
                                  e = internal energy density (fluid frame)
  conserved   u = (D, M_i, tau)   D = rho gamma, tau = E - D

The hydro c2p is the Galeazzi et al. (2013) bracketed root find on
z = gamma v (their eqs. C2-C26), the MHD c2p the Kastaun, Kalinani &
Ciolfi (2021) two-stage bracketed root find on mu = 1/(h W); each runs
as a fixed 25-trip Illinois loop with masked updates and frozen
converged lanes, as in the JAX package.  Neither has a kernel: the JAX
package has none for them either.
"""

from __future__ import annotations

import torch

from ..indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ
from .eos import EOSData

_MAX_ITER = 25
_TOL = 1.0e-12
_VMAX = 0.9999999999995


def _tol_for(dtype) -> float:
    """Convergence tolerance matched to the working precision: the
    reference's 1e-12 (ideal_c2p_mhd.hpp) in float64, about 8 ulp in
    float32, where 1e-12 is below machine epsilon."""
    return max(_TOL, float(torch.finfo(dtype).eps) * 8.0)


def sr_hydro_sound_speeds(eos: EOSData, d, p, ux, lor):
    """lambda_+/- for SR hydro (reference: eos.hpp:81-91, DZB eq. 73)."""
    cs2 = eos.gamma * p / (d + eos.gamma * p / (eos.gamma - 1.0))
    v2 = 1.0 - 1.0 / (lor * lor)
    p1 = (ux / lor) * (1.0 - cs2)
    tmp = torch.sqrt(torch.clamp(
        cs2 * ((1.0 - v2 * cs2) - p1 * (ux / lor)), min=0.0)) / lor
    invden = 1.0 / (1.0 - v2 * cs2)
    return (p1 + tmp) * invden, (p1 - tmp) * invden


def sr_mhd_fast_speeds(eos: EOSData, d, p, ux, lor, b_sq):
    """Maximal fast magnetosonic speeds lambda_+/- (reference:
    eos.hpp:97-111, DZB eq. 72/76)."""
    w = d + eos.gamma * p / (eos.gamma - 1.0)
    cs_sq = eos.gamma * p / w
    va_sq = b_sq / (b_sq + w)
    cms = cs_sq + va_sq - cs_sq * va_sq
    v2 = 1.0 - 1.0 / (lor * lor)
    p1 = (ux / lor) * (1.0 - cms)
    tmp = torch.sqrt(torch.clamp(
        cms * ((1.0 - v2 * cms) - p1 * (ux / lor)), min=0.0)) / lor
    invden = 1.0 / (1.0 - v2 * cms)
    return (p1 + tmp) * invden, (p1 - tmp) * invden


def _eq_c22(z, ud, q, r, eos: EOSData):
    """Master function f(z) of the hydro c2p (reference: EquationC22,
    ideal_c2p_hyd.hpp:91-101)."""
    gm1 = eos.gamma - 1.0
    w = torch.sqrt(1.0 + z * z)
    wd = ud / w
    eps = w * q - z * r + (z * z) / (1.0 + w)
    epsmin = torch.maximum(eos.pfloor / (wd * gm1),
                           eos.sfloor * wd ** gm1 / gm1)
    eps = torch.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    return z - r / h


def _eq49(mu, b2, rp, r):
    """Bracket function fa(mu) (reference: ideal_c2p_mhd.hpp:92-97,
    Kastaun et al. 2021 eq. 49)."""
    x = 1.0 / (1.0 + mu * b2)
    rbar = x * x * r * r + mu * x * (1.0 + x) * rp * rp
    return mu * torch.sqrt(1.0 + rbar) - 1.0


def _eq44(mu, b2, rpar, r, q, ud, eos: EOSData):
    """Master function f(mu) (reference: ideal_c2p_mhd.hpp:104-119,
    Kastaun et al. 2021 eq. 44)."""
    gm1 = eos.gamma - 1.0
    x = 1.0 / (1.0 + mu * b2)
    rbar = x * x * r * r + mu * x * (1.0 + x) * rpar * rpar
    qbar = q - 0.5 * b2 - 0.5 * (mu * mu * (b2 * rbar - rpar * rpar))
    z2 = mu * mu * rbar / torch.abs(1.0 - mu * mu * rbar)
    w = torch.sqrt(1.0 + z2)
    wd = ud / w
    eps = w * (qbar - mu * rbar) + z2 / (w + 1.0)
    epsmin = torch.maximum(eos.pfloor / (wd * gm1),
                           eos.sfloor * wd ** gm1 / gm1)
    eps = torch.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    return mu - 1.0 / (h / w + rbar * mu)


def _illinois(f, zm, zp, fm, fp):
    """Illinois false-position solve of f(z) = 0 in [zm, zp], at most
    _MAX_ITER trips as in the JAX package's fixed-trip loop; returns (z,
    done).  A trip changes no cell that is done, so the loop stops as
    soon as every cell is (one read of ``done`` a trip): the same values
    as the fixed trips, without the trips that change nothing (near-static
    flows converge in one or two)."""
    where = torch.where
    tol = _tol_for(zm.dtype)
    # the secant denominator guard must survive the working precision
    tiny = float(torch.finfo(zm.dtype).tiny)
    done = (torch.abs(zm - zp) < tol) | ((torch.abs(fm) + torch.abs(fp))
                                         < 2.0 * tol)
    z = 0.5 * (zm + zp)
    for _ in range(_MAX_ITER):
        if bool(done.all()):
            break
        znew = (zm * fp - zp * fm) / (fp - fm + tiny)
        fv = f(znew)
        newly = (torch.abs(zm - zp) < tol) | (torch.abs(fv) < tol)
        cond = fv * fp < 0.0
        zm_n = where(cond, zp, zm)
        fm_n = where(cond, fp, 0.5 * fm)
        zm = where(done, zm, zm_n)
        fm = where(done, fm, fm_n)
        zp = where(done, zp, znew)
        fp = where(done, fp, fv)
        z = where(done, z, znew)
        done = done | newly
    return z, done


def cons_to_prim_sr_hydro(u, eos: EOSData):
    """SR hydro c2p (reference: SingleC2P_IdealSRHyd,
    ideal_c2p_hyd.hpp:108-223).  Returns ``(w, u_fixed, counters)``:
    ``u_fixed`` is ``u`` but where a floor fired or the root find failed,
    there the conserved state of the floored primitives; the counts cover
    the whole array, as in the JAX package."""
    gm1 = eos.gamma - 1.0
    where = torch.where
    kmax = 2.0 * _VMAX / (1.0 + _VMAX * _VMAX)

    d = u[..., IDN, :, :, :]
    mx = u[..., IM1, :, :, :]
    my = u[..., IM2, :, :, :]
    mz = u[..., IM3, :, :, :]
    tau = u[..., IEN, :, :, :]

    dfloor_used = d < eos.dfloor
    d = torch.clamp(d, min=eos.dfloor)
    efloor_used0 = tau < eos.pfloor / gm1
    tau = torch.clamp(tau, min=eos.pfloor / gm1)

    s2 = mx * mx + my * my + mz * mz
    q = tau / d
    r = torch.sqrt(s2) / d
    kk = torch.clamp(r / (1.0 + q), max=kmax)

    zm = 0.5 * kk / torch.sqrt(1.0 - 0.25 * kk * kk)
    zp = kk / torch.sqrt(torch.clamp(1.0 - kk * kk, min=1.0e-30))

    def f22(z):
        return _eq_c22(z, d, q, r, eos)

    z, done = _illinois(f22, zm, zp, f22(zm), f22(zp))
    c2p_failure = ~done

    lor = torch.sqrt(1.0 + z * z)
    dens = torch.clamp(d / lor, min=eos.dfloor)
    eps = lor * q - z * r + (z * z) / (1.0 + lor)
    epsmin = torch.maximum(eos.pfloor / (dens * gm1),
                           eos.sfloor * dens ** gm1 / gm1)
    efloor_used = eps <= epsmin
    eps = torch.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    conv = 1.0 / h

    zero = torch.zeros_like(d)
    wd = where(c2p_failure, torch.full_like(d, eos.dfloor), dens)
    we = where(c2p_failure, torch.full_like(d, eos.pfloor / gm1),
               dens * eps)
    chans = [wd, where(c2p_failure, zero, conv * (mx / d)),
             where(c2p_failure, zero, conv * (my / d)),
             where(c2p_failure, zero, conv * (mz / d)), we]
    w = torch.stack(chans, dim=-4)
    if u.shape[-4] > 5:
        # scalars: concentration = (rho s gamma) / (rho gamma) = u_s / D
        w = torch.cat([w, u[..., 5:, :, :, :] / d.unsqueeze(-4)], dim=-4)

    # the conserved state of the floored primitives where a floor fired
    # or the root find failed
    u_fail = prim_to_cons_sr_hydro(w, eos)
    fail_b = (c2p_failure | dfloor_used | efloor_used0).unsqueeze(-4)
    u_fixed = where(fail_b, u_fail, u)

    counters = {
        "neos_dfloor": dfloor_used.sum(),
        "neos_efloor": (efloor_used | efloor_used0).sum(),
        "nc2p_fail": c2p_failure.sum(),
    }
    return w, u_fixed, counters


def prim_to_cons_sr_hydro(w, eos: EOSData):
    """SR hydro p2c (reference: SingleP2C_IdealSRHyd,
    ideal_c2p_hyd.hpp:230-243)."""
    gam = eos.gamma
    d = w[..., IDN, :, :, :]
    ux = w[..., IVX, :, :, :]
    uy = w[..., IVY, :, :, :]
    uz = w[..., IVZ, :, :, :]
    e = w[..., IEN, :, :, :]
    u0 = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    wgas_u0 = (d + gam * e) * u0
    u = torch.stack([d * u0, wgas_u0 * ux, wgas_u0 * uy, wgas_u0 * uz,
                     wgas_u0 * u0 - (gam - 1.0) * e - d * u0], dim=-4)
    if w.shape[-4] > 5:
        u = torch.cat([u, w[..., 5:, :, :, :] * (d * u0).unsqueeze(-4)],
                      dim=-4)
    return u


def cons_to_prim_sr_mhd(u, bcc, eos: EOSData):
    """SR MHD c2p (reference: SingleC2P_IdealSRMHD,
    ideal_c2p_mhd.hpp:127-286).  Returns ``(w, u_fixed, counters)`` with
    the density/energy floor hits and ``nc2p_fail``, the cells whose root
    find did not converge in the fixed trip count (they take the floor
    state); counts cover the whole array, as in the JAX package."""
    gm1 = eos.gamma - 1.0
    where = torch.where

    d = u[..., IDN, :, :, :]
    mx = u[..., IM1, :, :, :]
    my = u[..., IM2, :, :, :]
    mz = u[..., IM3, :, :, :]
    tau = u[..., IEN, :, :, :]
    bx = bcc[..., 0, :, :, :]
    by = bcc[..., 1, :, :, :]
    bz = bcc[..., 2, :, :, :]

    s2 = mx * mx + my * my + mz * mz
    b2_raw = bx * bx + by * by + bz * bz

    dfloor_eff = torch.clamp(b2_raw / eos.sigma_max, min=eos.dfloor)
    dfloor_used = d < dfloor_eff
    d = torch.maximum(d, dfloor_eff)
    tau_min = eos.pfloor / gm1 + 0.5 * b2_raw
    efloor0 = tau < tau_min
    tau = torch.maximum(tau, tau_min)

    rpar_raw = (bx * mx + by * my + bz * mz) / d

    # normalized variables (eqs. 22-24)
    q = tau / d
    r = torch.sqrt(s2) / d
    isqrtd = 1.0 / torch.sqrt(d)
    b2 = b2_raw / d
    rpar = rpar_raw * isqrtd

    # stage 1: upper bracket from fa(mu) = 0 (eq. 49)
    zm = torch.zeros_like(d)
    zp = torch.ones_like(d)

    def f49(z):
        return _eq49(z, b2, rpar, r)

    mu_up, done1 = _illinois(f49, zm, zp, f49(zm), f49(zp))

    # stage 2: solve f(mu) = 0 (eq. 44) in [0, mu_up]
    def f44(z):
        return _eq44(z, b2, rpar, r, q, d, eos)

    mu, done2 = _illinois(f44, zm, mu_up, f44(zm), f44(mu_up))
    c2p_failure = ~(done1 & done2)

    x = 1.0 / (1.0 + mu * b2)
    rbar = x * x * r * r + mu * x * (1.0 + x) * rpar * rpar
    qbar = q - 0.5 * b2 - 0.5 * (mu * mu * (b2 * rbar - rpar * rpar))
    z2 = mu * mu * rbar / torch.abs(1.0 - mu * mu * rbar)
    lor = torch.sqrt(1.0 + z2)

    dens = torch.maximum(d / lor, dfloor_eff)
    eps = lor * (qbar - mu * rbar) + z2 / (lor + 1.0)
    epsmin = torch.maximum(eos.pfloor / (dens * gm1),
                           eos.sfloor * dens ** gm1 / gm1)
    efloor_used = eps <= epsmin
    eps = torch.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    conv = lor / (h * lor + b2)

    bxn, byn, bzn = bx * isqrtd, by * isqrtd, bz * isqrtd
    zero = torch.zeros_like(d)
    wd = where(c2p_failure, dfloor_eff, dens)
    we = where(c2p_failure, torch.full_like(d, eos.pfloor / gm1), dens * eps)
    wvx = where(c2p_failure, zero, conv * (mx / d + bxn * rpar / (h * lor)))
    wvy = where(c2p_failure, zero, conv * (my / d + byn * rpar / (h * lor)))
    wvz = where(c2p_failure, zero, conv * (mz / d + bzn * rpar / (h * lor)))
    w = torch.stack([wd, wvx, wvy, wvz, we], dim=-4)

    u_fail = prim_to_cons_sr_mhd(w, bcc, eos)
    fail_b = (c2p_failure | dfloor_used | efloor0).unsqueeze(-4)
    u_fixed = where(fail_b, u_fail, u)

    counters = {
        "neos_dfloor": dfloor_used.sum(),
        "neos_efloor": (efloor_used | efloor0).sum(),
        "nc2p_fail": c2p_failure.sum(),
    }
    return w, u_fixed, counters


def prim_to_cons_sr_mhd(w, bcc, eos: EOSData):
    """SR MHD p2c (reference: SingleP2C_IdealSRMHD,
    ideal_c2p_mhd.hpp:292-312)."""
    gam = eos.gamma
    d = w[..., IDN, :, :, :]
    ux = w[..., IVX, :, :, :]
    uy = w[..., IVY, :, :, :]
    uz = w[..., IVZ, :, :, :]
    e = w[..., IEN, :, :, :]
    bx = bcc[..., 0, :, :, :]
    by = bcc[..., 1, :, :, :]
    bz = bcc[..., 2, :, :, :]

    u0 = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    b0 = bx * ux + by * uy + bz * uz
    b1 = (bx + b0 * ux) / u0
    b2_ = (by + b0 * uy) / u0
    b3 = (bz + b0 * uz) / u0
    b_sq = -b0 * b0 + b1 * b1 + b2_ * b2_ + b3 * b3

    wtot_u02 = (d + gam * e + b_sq) * u0 * u0
    dd = d * u0
    return torch.stack([
        dd,
        wtot_u02 * ux / u0 - b0 * b1,
        wtot_u02 * uy / u0 - b0 * b2_,
        wtot_u02 * uz / u0 - b0 * b3,
        wtot_u02 - b0 * b0 - ((gam - 1.0) * e + 0.5 * b_sq) - dd], dim=-4)
