"""Implicit radiation-fluid coupling in the comoving frame, on tensors.

Counterpart of ``athenak_tpu/radiation/coupling.py`` (reference:
``Radiation::RadFluidCoupling``, src/radiation/radiation_source.cpp:34-392):
a per-cell implicit exchange between the gas and the intensities,
absorption and scattering with the exact quartic solve for the new gas
temperature (``fourth_poly_root``), the energy and momentum handed to the
fluid as the change of the radiation moments, and the thermal Compton
stage.  Every per-angle loop is a sum over the angle axis; the root's
branches are ``where`` masks.
"""

from __future__ import annotations

import math

import torch

FOUR_PI = 4.0 * math.pi
_IDN, _IEN, _IVX, _IVY, _IVZ = 0, 4, 1, 2, 3


def cbrt(x):
    """The real cube root of x >= 0 as ``pow(x, 1/3)`` (torch has no
    cbrt).  It equals XLA's ``jnp.cbrt`` on about 98% of arguments and is
    an ulp off on the rest; a Newton step would round it correctly but
    part it from XLA on some 90%.  The quartic root below subtracts two
    cube roots of nearly equal numbers, which turns an ulp into a
    relative error of about eps delta1^(2/3) (ROADMAP F23)."""
    return torch.pow(x, 1.0 / 3.0)


def fourth_poly_root(coef4, tconst):
    """The real root of coef4 x^4 + x + tconst = 0 (reference:
    FourthPolyRoot, radiation_source.cpp:396-436).  Returns (root, ok),
    ok False where no acceptable root exists."""
    ccubic = tconst * tconst * tconst
    delta1 = 0.25 - 64.0 * ccubic * coef4 / 27.0
    ok = delta1 >= 0.0
    delta1 = torch.sqrt(torch.clamp(delta1, min=0.0))
    ok = ok & (delta1 >= 0.5)
    zroot = torch.where(
        delta1 > 1.0e11,
        (torch.clamp(delta1, min=1e-300) ** (-2.0 / 3.0)) / 3.0,
        cbrt(0.5 + delta1) - cbrt(torch.clamp(delta1 - 0.5, min=0.0)))
    ok = ok & (zroot >= 0.0)
    zroot = zroot * torch.clamp(coef4, min=1e-300) ** (-2.0 / 3.0)
    rcoef = torch.sqrt(torch.clamp(zroot, min=0.0))
    delta2 = -zroot + 2.0 / torch.clamp(coef4 * rcoef, min=1e-300)
    ok = ok & (delta2 >= 0.0)
    root = 0.5 * (torch.sqrt(torch.clamp(delta2, min=0.0)) - rcoef)
    ok = ok & (root >= 0.0) & torch.isfinite(root)
    return root, ok


def rad_fluid_coupling(rad, i0, u, w, gm1, dt_eff, affect_fluid=True):
    """One implicit coupling step; returns (i0_new, u_new).

    ``rad``: the Radiation module (tetrads, grid, opacities); ``u, w``:
    the fluid's conserved and primitive arrays; ``dt_eff``: the stage's
    beta dt.  Every array has its ghosts; the fill afterwards is the
    caller's (the reference applies it to the active zones, then
    exchanges)."""
    n0, n_0, n_mu, n2t = rad.tet_quantities()
    sang = rad.sang
    nh_b = rad.nh_b
    gl, gu = rad.metric_cc()
    alpha = 1.0 / torch.sqrt(-gu[0][0])

    wdn = w[:, _IDN]
    wvx, wvy, wvz = w[:, _IVX], w[:, _IVY], w[:, _IVZ]
    wen = w[:, _IEN]
    pgas = gm1 * wen
    tgas = pgas / wdn
    q = (gl[1][1] * wvx * wvx + 2.0 * gl[1][2] * wvx * wvy
         + 2.0 * gl[1][3] * wvx * wvz + gl[2][2] * wvy * wvy
         + 2.0 * gl[2][3] * wvy * wvz + gl[3][3] * wvz * wvz)
    gamma = torch.sqrt(1.0 + q)
    u0 = gamma / alpha

    if rad.power_opacity:
        # Kramers opacity kappa ~ rho T^-3.5 (reference:
        # radiation_opacities.hpp OpacityFunction, the power branch; the
        # Rosseland and Planck-minus-Rosseland coefficients 1 and 0 in
        # code units, radiation_source.cpp:65-75)
        ross = getattr(rad, "rosseland_coef", 1.0)
        pmr = getattr(rad, "planck_minus_rosseland_coef", 0.0)
        power_law = wdn * (gm1 / torch.clamp(tgas, min=1e-30)) ** 3.5
        sigma_a = wdn * ross * power_law
        sigma_p = wdn * pmr * power_law
        sigma_s = wdn * rad.kappa_s
    else:
        sigma_a = wdn * rad.kappa_a
        sigma_s = wdn * rad.kappa_s
        sigma_p = wdn * rad.kappa_p
    dtcsiga = dt_eff * sigma_a
    dtcsigs = dt_eff * sigma_s
    dtcsigp = dt_eff * sigma_p
    dtaucsiga = dtcsiga / u0
    dtaucsigs = dtcsigs / u0
    dtaucsigp = dtcsigp / u0

    # the fluid velocity in the tetrad frame
    comps = (gamma, wvx, wvy, wvz)
    u_tet = [sum(n2t[a][nu] * comps[nu] for nu in range(4))[:, None]
             for a in range(4)]

    # per-angle comoving n^0
    n0_cm = (u_tet[0] * nh_b[0] - u_tet[1] * nh_b[1]
             - u_tet[2] * nh_b[2] - u_tet[3] * nh_b[3])
    omega_cm = sang / (n0_cm * n0_cm)
    intensity_cm = FOUR_PI * (i0 / (n0 * n_0)) * n0_cm ** 4
    dts = (dtcsiga + dtcsigs)[:, None]
    vncsigma = 1.0 / (n0 + dts * n0_cm)
    vncsigma2 = n0_cm * vncsigma
    ir_weight = intensity_cm * omega_cm

    wght_sum = torch.sum(omega_cm, dim=1)
    suma1 = torch.sum(omega_cm * vncsigma2, dim=1) / wght_sum
    suma2 = torch.sum(ir_weight * n0 * vncsigma, dim=1) / wght_sum
    suma3 = suma1 * (dtcsigs - dtcsigp)
    suma1 = suma1 * (dtcsiga + dtcsigp)

    coef1 = ((dtaucsiga + dtaucsigp)
             * (1.0 - suma1 / (1.0 - suma3))
             * rad.arad * gm1 / wdn)
    coef0 = -tgas - (dtaucsiga + dtaucsigp) * suma2 * gm1 \
        / (wdn * (1.0 - suma3))

    root, ok = fourth_poly_root(torch.abs(coef1) + 1e-300, coef0)
    lin = torch.abs(coef1) <= 1.0e-20
    tgasnew = torch.where(lin, -coef0, torch.where(ok, root, tgas))
    badcell = (~lin) & (~ok)

    emission = rad.arad * tgasnew ** 4
    jr_cm = (suma1 * emission + suma2) / (1.0 - suma3)

    di_cm = (((dtcsigs - dtcsigp)[:, None] * jr_cm[:, None]
              + (dtcsiga + dtcsigp)[:, None] * emission[:, None]
              - dts * intensity_cm) * vncsigma2)
    prim_new = i0 / (n0 * n_0) + di_cm / (FOUR_PI * n0_cm ** 4)
    i0_new = n0 * n_0 * torch.clamp(prim_new, min=0.0)
    # bad cells keep the old intensity
    i0_new = torch.where(badcell[:, None], i0, i0_new)

    if rad.is_compton:
        # the Compton stage (reference: radiation_source.cpp:290-377): a
        # second implicit update against the partly updated gas
        # temperature, at the thermal Compton rate 4 sigma_s (T_gas -
        # T_rad) / T_electron
        inv_te = rad.inv_t_electron
        tgas_c = tgasnew
        wght_cm = omega_cm / wght_sum[:, None]
        intensity_c = FOUR_PI * (i0_new / (n0 * n_0)) * n0_cm ** 4
        jr_cm_c = torch.sum(intensity_c * wght_cm, dim=1)
        csuma1 = torch.sum((n0_cm / n0) * 4.0 * dtcsigs[:, None]
                           * inv_te * wght_cm, dim=1)
        csuma2 = 4.0 * dtaucsigs * inv_te * gm1 / wdn
        trad = torch.sqrt(torch.sqrt(torch.clamp(jr_cm_c, min=0.0)
                                     / rad.arad))
        # the equilibrium deadband: the reference's absolute 1e-12 test
        # (radiation_source.cpp:314) widened by a relative band, as in
        # the JAX package
        eps_t = 8.0 * torch.finfo(i0.dtype).eps
        temp_equil = torch.abs(trad - tgas_c) < (
            1.0e-12 + eps_t * torch.abs(tgas_c))
        denom1 = csuma1 * jr_cm_c
        ccoef4 = (1.0 + csuma2 * jr_cm_c) \
            / torch.where(denom1 == 0.0, 1e-300, denom1) * rad.arad
        ccoef0 = -(1.0 + csuma2 * jr_cm_c) \
            / torch.where(csuma1 == 0.0, 1e-300, csuma1) - tgas_c
        tradnew, cok = fourth_poly_root(ccoef4, ccoef0)
        apply_c = cok & torch.isfinite(tradnew) & (~temp_equil) \
            & (denom1 > 0.0)
        tgasnew_c = (rad.arad * tradnew ** 4 - jr_cm_c) \
            / torch.where(denom1 == 0.0, 1e-300, denom1) + tradnew
        # the exact implicit step moves both temperatures toward each
        # other: bracket the roots by [min, max](trad, tgas)
        t_lo = torch.minimum(trad, tgas_c)
        t_hi = torch.maximum(trad, tgas_c)
        tradnew = torch.minimum(torch.maximum(tradnew, t_lo), t_hi)
        tgasnew_c = torch.minimum(torch.maximum(tgasnew_c, t_lo), t_hi)
        di_cm_c = ((n0_cm / n0) * dtcsigs[:, None] * 4.0
                   * jr_cm_c[:, None] * inv_te
                   * (tgasnew_c - tradnew)[:, None])
        prim_c = i0_new / (n0 * n_0) + di_cm_c / (FOUR_PI * n0_cm ** 4)
        i0_compton = n0 * n_0 * torch.clamp(prim_c, min=0.0)
        i0_new = torch.where(apply_c[:, None], i0_compton, i0_new)

    if rad.excise_mask is not None:
        i0_new = torch.where(rad.excise_mask[:, None], 0.0, i0_new)
        i0_new = torch.where(torch.abs(n_0) < rad.n_0_floor, 0.0, i0_new)

    if not affect_fluid:
        return i0_new, u

    # the fluid's feedback: the change of the moments (reference:
    # radiation_source.cpp:233-292)
    def mom(ii, comp):
        if comp == 0:
            return torch.sum(ii * sang, dim=1)
        return torch.sum(n_mu[comp] * ii / n_0 * sang, dim=1)

    u_new = u.clone()
    u_new[:, _IEN] += mom(i0, 0) - mom(i0_new, 0)
    for c in (1, 2, 3):
        u_new[:, c] += mom(i0, c) - mom(i0_new, c)
    return i0_new, u_new
