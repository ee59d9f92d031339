"""GR ideal-gas EOS on a stationary spacetime, hydro and MHD: c2p and
p2c.

Counterpart of ``athenak_tpu/ops/eos_gr.py`` (reference:
src/eos/ideal_grhyd.cpp:50-260, ideal_c2p_hyd.hpp:251-333,
src/eos/ideal_grmhd.cpp, ideal_c2p_mhd.hpp:320-426), on torch tensors
laid out ``[..., nvar, n3, n2, n1]`` with the metric as nested 4x4 lists
of tensors (``coordinates.GRGeometry``).  Conventions:

  primitives  w = (rho, utilde^i, e)  utilde^i = u^i + alpha gamma g^0i,
                                      e = internal energy density
  conserved   u = (D, T^0_i, T^0_0 + D)

The c2p transforms (D, T^0_i, T^0_0 + D) into boosted SR variables
(valid because sqrt(-g) = 1 in CKS) and runs the SR root finds of
``eos_sr`` (the Galeazzi et al. hydro solve, the Kastaun et al. MHD
solve), then applies the Lorentz-factor ceiling and horizon excision.
Every fix selects with ``torch.where``: in float32 the ceiling's guard
1e-300 is 0 and its factor is inf in cells at rest, which a select
never lets into the state.  Neither has a kernel: the JAX package has
none for them either.
"""

from __future__ import annotations

import torch

from ..indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ
from . import eos_sr
from .eos import EOSData

_NFLUID = 5


def _alpha(gupper):
    return torch.sqrt(-1.0 / gupper[0][0])


def _transform_momenta(u, gupper):
    """(d_sr, mx_sr, my_sr, mz_sr, e_sr, s2, (m1l, m2l, m3l), alpha)
    shared by the hydro and MHD transforms (reference:
    TransformToSRHyd, ideal_c2p_hyd.hpp:251-299)."""
    d = u[..., IDN, :, :, :]
    mx = u[..., IM1, :, :, :]
    my = u[..., IM2, :, :, :]
    mz = u[..., IM3, :, :, :]
    e = u[..., IEN, :, :, :]
    alpha = _alpha(gupper)
    d_sr = d * alpha
    e_sr = (gupper[0][0] * (e - d) + gupper[0][1] * mx
            + gupper[0][2] * my + gupper[0][3] * mz)
    e_sr = e_sr * (-1.0 / gupper[0][0]) - d_sr
    m1l, m2l, m3l = mx * alpha, my * alpha, mz * alpha
    g00 = gupper[0][0]

    def gamma_ij(i, j):
        return gupper[i][j] - gupper[0][i] * gupper[0][j] / g00

    mx_sr = gamma_ij(1, 1) * m1l + gamma_ij(1, 2) * m2l + gamma_ij(1, 3) * m3l
    my_sr = gamma_ij(2, 1) * m1l + gamma_ij(2, 2) * m2l + gamma_ij(2, 3) * m3l
    mz_sr = gamma_ij(3, 1) * m1l + gamma_ij(3, 2) * m2l + gamma_ij(3, 3) * m3l
    s2 = m1l * mx_sr + m2l * my_sr + m3l * mz_sr
    return d_sr, mx_sr, my_sr, mz_sr, e_sr, s2, (m1l, m2l, m3l), alpha


def _transform_to_sr(u, glower, gupper):
    """(reference: TransformToSRHyd, ideal_c2p_hyd.hpp:251-299)."""
    d_sr, mx_sr, my_sr, mz_sr, e_sr, s2, _, _ = _transform_momenta(u, gupper)
    return d_sr, mx_sr, my_sr, mz_sr, e_sr, s2


def _transform_to_sr_mhd(u, bcc, glower, gupper):
    """(reference: TransformToSRMHD, ideal_c2p_mhd.hpp:320-379)."""
    d_sr, mx_sr, my_sr, mz_sr, e_sr, s2, (m1l, m2l, m3l), alpha = \
        _transform_momenta(u, gupper)
    bx_sr = alpha * bcc[..., 0, :, :, :]
    by_sr = alpha * bcc[..., 1, :, :, :]
    bz_sr = alpha * bcc[..., 2, :, :, :]
    b2 = (glower[1][1] * bx_sr ** 2 + glower[2][2] * by_sr ** 2
          + glower[3][3] * bz_sr ** 2
          + 2.0 * (bx_sr * (glower[1][2] * by_sr + glower[1][3] * bz_sr)
                   + glower[2][3] * by_sr * bz_sr))
    rpar = (bx_sr * m1l + by_sr * m2l + bz_sr * m3l) / d_sr
    return (d_sr, mx_sr, my_sr, mz_sr, e_sr, s2, bx_sr, by_sr, bz_sr, b2,
            rpar)


def _ceiling_and_excision(wd, we, wv, glower, eos: EOSData, excise_mask,
                          dexcise, pexcise):
    """The Lorentz-factor ceiling (reference: ideal_grhyd.cpp:133-146)
    and the horizon excision overwrite (:104-119); returns
    (wd, we, (wvx, wvy, wvz), vceil)."""
    where = torch.where
    gm1 = eos.gamma - 1.0
    wvx, wvy, wvz = wv
    tmp = (glower[1][1] * wvx * wvx + glower[2][2] * wvy * wvy
           + glower[3][3] * wvz * wvz
           + 2.0 * (glower[1][2] * wvx * wvy + glower[1][3] * wvx * wvz
                    + glower[2][3] * wvy * wvz))
    lor_w = torch.sqrt(1.0 + torch.clamp(tmp, min=0.0))
    vceil = lor_w > eos.gamma_max
    factor = torch.sqrt((eos.gamma_max ** 2 - 1.0)
                        / torch.clamp(lor_w ** 2 - 1.0, min=1.0e-300))
    wvx = where(vceil, wvx * factor, wvx)
    wvy = where(vceil, wvy * factor, wvy)
    wvz = where(vceil, wvz * factor, wvz)
    if excise_mask is not None:
        zero = torch.zeros_like(wd)
        wd = where(excise_mask, torch.full_like(wd, dexcise), wd)
        we = where(excise_mask, torch.full_like(we, pexcise / gm1), we)
        wvx = where(excise_mask, zero, wvx)
        wvy = where(excise_mask, zero, wvy)
        wvz = where(excise_mask, zero, wvz)
    return wd, we, (wvx, wvy, wvz), vceil


def _pack_prims(u, wd, wv, we, d):
    """w from its channels, the scalars' concentration u_s / d beyond
    the fluid channels."""
    w = torch.stack([wd, wv[0], wv[1], wv[2], we], dim=-4)
    if u.shape[-4] > _NFLUID:
        w = torch.cat([w, u[..., _NFLUID:, :, :, :] / d.unsqueeze(-4)],
                      dim=-4)
    return w


def _counters(dfloor_used, efloor, vceil, c2p_failure):
    return {"neos_dfloor": dfloor_used.sum(),
            "neos_efloor": efloor.sum(),
            "neos_vceil": vceil.sum(),
            "nc2p_fail": c2p_failure.sum()}


def cons_to_prim_gr_hydro(u, eos: EOSData, glower, gupper,
                          excise_mask=None, dexcise=None, pexcise=None):
    """GR hydro c2p (reference: ideal_grhyd.cpp:50-190).  Returns
    ``(w, u_fixed, counters)``: ``u_fixed`` is ``u`` but where a floor,
    the ceiling, excision or a failed root find fixed the primitives,
    there their conserved state; the counts cover the whole array."""
    gm1 = eos.gamma - 1.0
    where = torch.where
    d_sr, mx_sr, my_sr, mz_sr, e_sr, s2 = _transform_to_sr(u, glower, gupper)

    # the SR c2p core on the transformed state (Galeazzi et al.)
    dfloor_used = d_sr < eos.dfloor
    d_sr = torch.clamp(d_sr, min=eos.dfloor)
    efloor0 = e_sr < eos.pfloor / gm1
    e_sr = torch.clamp(e_sr, min=eos.pfloor / gm1)
    s2 = torch.clamp(s2, min=0.0)

    kmax = 2.0 * eos_sr._VMAX / (1.0 + eos_sr._VMAX ** 2)
    q = e_sr / d_sr
    r = torch.sqrt(s2) / d_sr
    kk = torch.clamp(r / (1.0 + q), max=kmax)
    zm = 0.5 * kk / torch.sqrt(1.0 - 0.25 * kk * kk)
    zp = kk / torch.sqrt(torch.clamp(1.0 - kk * kk, min=1.0e-30))

    def f(z):
        return eos_sr._eq_c22(z, d_sr, q, r, eos)

    z, done = eos_sr._illinois(f, zm, zp, f(zm), f(zp))
    c2p_failure = ~done

    lor = torch.sqrt(1.0 + z * z)
    dens = torch.clamp(d_sr / lor, min=eos.dfloor)
    eps = lor * q - z * r + (z * z) / (1.0 + lor)
    epsmin = torch.maximum(eos.pfloor / (dens * gm1),
                           eos.sfloor * dens ** gm1 / gm1)
    efloor_used = eps <= epsmin
    eps = torch.maximum(eps, epsmin)
    h = 1.0 + eos.gamma * eps
    conv = 1.0 / h

    zero = torch.zeros_like(dens)
    wd = where(c2p_failure, torch.full_like(dens, eos.dfloor), dens)
    we = where(c2p_failure, torch.full_like(dens, eos.pfloor / gm1),
               dens * eps)
    wv = (where(c2p_failure, zero, conv * (mx_sr / d_sr)),
          where(c2p_failure, zero, conv * (my_sr / d_sr)),
          where(c2p_failure, zero, conv * (mz_sr / d_sr)))
    wd, we, wv, vceil = _ceiling_and_excision(
        wd, we, wv, glower, eos, excise_mask, dexcise, pexcise)
    w = _pack_prims(u, wd, wv, we, d_sr)

    fixed = dfloor_used | efloor_used | efloor0 | vceil | c2p_failure
    if excise_mask is not None:
        fixed = fixed | excise_mask
    u_fail = prim_to_cons_gr_hydro(w, eos, glower, gupper)
    u_fixed = where(fixed.unsqueeze(-4), u_fail, u)
    return w, u_fixed, _counters(dfloor_used, efloor_used | efloor0, vceil,
                                 c2p_failure)


def four_velocity(w, glower, gupper):
    """(u^mu, u_mu) from the utilde primitives, as the c2p, the cell
    EMFs and the source terms of the JAX package form them (the solvers
    sum the spatial norm in another order, ``rsolvers_gr``)."""
    wvx = w[..., IVX, :, :, :]
    wvy = w[..., IVY, :, :, :]
    wvz = w[..., IVZ, :, :, :]
    q = (glower[1][1] * wvx * wvx + glower[2][2] * wvy * wvy
         + glower[3][3] * wvz * wvz
         + 2.0 * (glower[1][2] * wvx * wvy + glower[1][3] * wvx * wvz
                  + glower[2][3] * wvy * wvz))
    alpha = _alpha(gupper)
    gamma = torch.sqrt(1.0 + q)
    uu = (gamma / alpha,
          wvx - alpha * gamma * gupper[0][1],
          wvy - alpha * gamma * gupper[0][2],
          wvz - alpha * gamma * gupper[0][3])
    return uu, lower_index(uu, glower)


def lower_index(v, glower):
    return tuple(glower[mu][0] * v[0] + glower[mu][1] * v[1]
                 + glower[mu][2] * v[2] + glower[mu][3] * v[3]
                 for mu in range(4))


def _pack_cons(w, chans, dd):
    u = torch.stack(list(chans), dim=-4)
    if w.shape[-4] > _NFLUID:
        u = torch.cat([u, w[..., _NFLUID:, :, :, :] * dd.unsqueeze(-4)],
                      dim=-4)
    return u


def prim_to_cons_gr_hydro(w, eos: EOSData, glower, gupper):
    """(reference: SingleP2C_IdealGRHyd, ideal_c2p_hyd.hpp:305-333)."""
    gam = eos.gamma
    d = w[..., IDN, :, :, :]
    e = w[..., IEN, :, :, :]
    uu, ul = four_velocity(w, glower, gupper)
    wgas_u0 = (d + gam * e) * uu[0]
    dd = d * uu[0]
    return _pack_cons(w, (dd, wgas_u0 * ul[1], wgas_u0 * ul[2],
                          wgas_u0 * ul[3],
                          wgas_u0 * ul[0] + (gam - 1.0) * e + dd), dd)


# ------------------------------------------------------------------ GR MHD
def cons_to_prim_gr_mhd(u, bcc, eos: EOSData, glower, gupper,
                        excise_mask=None, dexcise=None, pexcise=None):
    """GR MHD c2p: the boosted SR state and the Kastaun et al. (2021)
    root find (reference: src/eos/ideal_grmhd.cpp).  Returns
    ``(w, u_fixed, counters)`` as ``cons_to_prim_gr_hydro``."""
    gm1 = eos.gamma - 1.0
    where = torch.where
    (d, mx, my, mz, tau, s2, bx, by, bz, b2_raw, rpar_raw) = \
        _transform_to_sr_mhd(u, bcc, glower, gupper)

    dfloor_eff = torch.clamp(b2_raw / eos.sigma_max, min=eos.dfloor)
    dfloor_used = d < dfloor_eff
    d = torch.maximum(d, dfloor_eff)
    tau_min = eos.pfloor / gm1 + 0.5 * b2_raw
    efloor0 = tau < tau_min
    tau = torch.maximum(tau, tau_min)
    s2 = torch.clamp(s2, min=0.0)

    q = tau / d
    r = torch.sqrt(s2) / d
    isqrtd = 1.0 / torch.sqrt(d)
    b2 = b2_raw / d
    rpar = rpar_raw * isqrtd

    zm = torch.zeros_like(d)
    zp = torch.ones_like(d)

    def f49(z):
        return eos_sr._eq49(z, b2, rpar, r)

    mu_up, done1 = eos_sr._illinois(f49, zm, zp, f49(zm), f49(zp))

    def f44(z):
        return eos_sr._eq44(z, b2, rpar, r, q, d, eos)

    mu, done2 = eos_sr._illinois(f44, zm, mu_up, f44(zm), f44(mu_up))
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
    wv = (where(c2p_failure, zero, conv * (mx / d + bxn * rpar / (h * lor))),
          where(c2p_failure, zero, conv * (my / d + byn * rpar / (h * lor))),
          where(c2p_failure, zero, conv * (mz / d + bzn * rpar / (h * lor))))
    wd, we, wv, vceil = _ceiling_and_excision(
        wd, we, wv, glower, eos, excise_mask, dexcise, pexcise)
    w = _pack_prims(u, wd, wv, we, d)

    fixed = dfloor_used | efloor0 | efloor_used | vceil | c2p_failure
    if excise_mask is not None:
        fixed = fixed | excise_mask
    u_fail = prim_to_cons_gr_mhd(w, bcc, eos, glower, gupper)
    u_fixed = where(fixed.unsqueeze(-4), u_fail, u)
    return w, u_fixed, _counters(dfloor_used, efloor_used | efloor0, vceil,
                                 c2p_failure)


def four_field(bcc, uu, ul):
    """The contravariant 4-field b^mu from the cell field and u^mu, u_mu
    (reference: ideal_c2p_mhd.hpp:405-412)."""
    bx = bcc[..., 0, :, :, :]
    by = bcc[..., 1, :, :, :]
    bz = bcc[..., 2, :, :, :]
    b0 = ul[1] * bx + ul[2] * by + ul[3] * bz
    return (b0, (bx + b0 * uu[1]) / uu[0], (by + b0 * uu[2]) / uu[0],
            (bz + b0 * uu[3]) / uu[0])


def prim_to_cons_gr_mhd(w, bcc, eos: EOSData, glower, gupper):
    """(reference: SingleP2C_IdealGRMHD, ideal_c2p_mhd.hpp:386-426)."""
    gam = eos.gamma
    d = w[..., IDN, :, :, :]
    e = w[..., IEN, :, :, :]
    uu, ul = four_velocity(w, glower, gupper)
    bu = four_field(bcc, uu, ul)
    bl = lower_index(bu, glower)
    b_sq = bu[0] * bl[0] + bu[1] * bl[1] + bu[2] * bl[2] + bu[3] * bl[3]
    wtot = d + gam * e + b_sq
    ptot = (gam - 1.0) * e + 0.5 * b_sq
    dd = d * uu[0]
    return _pack_cons(w, (dd,
                          wtot * uu[0] * ul[1] - bu[0] * bl[1],
                          wtot * uu[0] * ul[2] - bu[0] * bl[2],
                          wtot * uu[0] * ul[3] - bu[0] * bl[3],
                          wtot * uu[0] * ul[0] - bu[0] * bl[0] + ptot + dd),
                      dd)


def coord_src_terms(u, w, eos: EOSData, geom, beta_dt, bcc=None):
    """The geometric source terms S_i = 1/2 T^ab d_i(g_ab) on the momenta,
    with the magnetic stress when ``bcc`` is given (reference:
    Coordinates::CoordSrcTerms, src/coordinates/coordinates.cpp:122-233
    and the MHD version :244-376).  Adds ``beta_dt * S_i`` to ``u`` in
    place (the stage's fresh register) and returns it."""
    gl, gu = geom.metric("cc")
    dgs = geom.metric_derivatives()
    gp = eos.gamma / (eos.gamma - 1.0)
    rho = w[:, IDN]
    p = eos.pressure(w[:, IEN])
    uv, ul = four_velocity(w, gl, gu)
    if bcc is None:
        wtot, ptot, bv = rho + gp * p, p, None
    else:
        bv = four_field(bcc, uv, ul)
        bl = lower_index(bv, gl)
        b_sq = None
        for mu in range(4):
            t = bl[mu] * bv[mu]
            b_sq = t if b_sq is None else b_sq + t
        wtot = rho + gp * p + b_sq
        ptot = p + 0.5 * b_sq
    for d, im in ((0, IM1), (1, IM2), (2, IM3)):
        dg = dgs[d]
        s = None
        for mu in range(4):
            for nu in range(mu, 4):
                fac = 0.5 if mu == nu else 1.0
                tt = wtot * uv[mu] * uv[nu] + ptot * gu[mu][nu]
                if bv is not None:
                    tt = tt - bv[mu] * bv[nu]
                term = fac * dg[mu][nu] * tt
                s = term if s is None else s + term
        u[:, im] += beta_dt * s
    return u
