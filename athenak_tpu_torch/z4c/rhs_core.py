"""The Z4c right-hand side, written once against a finite-difference
backend.

Counterpart of ``athenak_tpu/z4c/rhs_core.py`` (reference: Z4c::CalcRHS,
z4c_calcrhs.cpp:180-590), line by line with the same operation order, so
that the whole-array torch path (``z4c.py`` ``_WholeArrayOps``) rounds as
the JAX package's jnp path does; the CUDA stage kernel
(``csrc/z4c_rhs.cuh``) repeats the same order cell by cell.  The matter
coupling (``tmunu``, dynamical GRMHD) adds its source terms after the
gauge rows, as the JAX package does; only the whole-array path takes it
(the kernel's gate is closed by ``tmunu``).

Backend protocol (``ops``):
  d1(f, d)        first derivative, FD order 2*ng - 2
  d2(f, da, db)   second derivative (da==db centred, else mixed)
  ladv(f)         upwinded advective term sum_d beta^d d_d f
  ko(f)           sum_d undivided 2*ng-th difference * idx[d]
  d1_o2(f, d)     2nd-order first derivative (Sommerfeld, z4c_Sbc.cpp)
  center(f)       restrict a full-window field to the output region
  sbc()           None, or (mask, r, s_u[3]) Sommerfeld geometry
                  (mask = outermost active layer)
"""

from __future__ import annotations

import itertools
import math

import torch

from .z4c import (  # channel order; reference: z4c.hpp:46-56
    I_CHI, I_GXX, I_KHAT, I_AXX, I_GAMX, I_THETA, I_ALPHA, I_BETAX,
    NZ4C, sym_idx, _sym_pairs, spatial_det, spatial_inv)


def unpack_fields(ch):
    """ch: callable idx -> channel tensor. Returns the named views."""
    chi = ch(I_CHI)
    g = [[ch(I_GXX + sym_idx(a, b)) for b in range(3)] for a in range(3)]
    khat = ch(I_KHAT)
    A = [[ch(I_AXX + sym_idx(a, b)) for b in range(3)] for a in range(3)]
    gam = [ch(I_GAMX + a) for a in range(3)]
    theta = ch(I_THETA)
    alpha = ch(I_ALPHA)
    beta = [ch(I_BETAX + a) for a in range(3)]
    return chi, g, khat, A, gam, theta, alpha, beta


def rhs_core(ch, ops, opt, diss, tmunu=None):
    """Z4c RHS; returns the 22 channel tensors in evolved-variable order.
    ``ch``: idx -> full-window channel field; ``diss``: the pre-scaled
    sigma * 2^-2ng * sign factor."""
    chi, g, khat, A, gam, theta, alpha, beta = unpack_fields(ch)

    D1, D2 = ops.d1, ops.d2

    # first derivatives
    dalpha = [D1(alpha, d) for d in range(3)]
    dchi = [D1(chi, d) for d in range(3)]
    dkhat = [D1(khat, d) for d in range(3)]
    dtheta = [D1(theta, d) for d in range(3)]
    dbeta = [[D1(beta[a], d) for a in range(3)] for d in range(3)]
    dgam = [[D1(gam[a], d) for a in range(3)] for d in range(3)]
    dg = [[[D1(g[a][b], d) if a <= b else None for b in range(3)]
           for a in range(3)] for d in range(3)]
    for d in range(3):
        for a in range(3):
            for b in range(a):
                dg[d][a][b] = dg[d][b][a]

    # second derivatives
    ddalpha = [[D2(alpha, a, b) if a <= b else None for b in range(3)]
               for a in range(3)]
    ddchi = [[D2(chi, a, b) if a <= b else None for b in range(3)]
             for a in range(3)]
    for a in range(3):
        for b in range(a):
            ddalpha[a][b] = ddalpha[b][a]
            ddchi[a][b] = ddchi[b][a]
    ddbeta = [[[D2(beta[c], a, b) if a <= b else None for c in range(3)]
               for b in range(3)] for a in range(3)]
    for a in range(3):
        for b in range(a):
            ddbeta[a][b] = ddbeta[b][a]
    ddg = {}
    for a, b in itertools.combinations_with_replacement(range(3), 2):
        for c, d in _sym_pairs():
            ddg[(a, b, c, d)] = D2(g[c][d], a, b)

    def DDg(a, b, c, d):
        a, b = (a, b) if a <= b else (b, a)
        c, d = (c, d) if c <= d else (d, c)
        return ddg[(a, b, c, d)]

    # advective (Lie) pieces
    Ladv = ops.ladv
    Lalpha = Ladv(alpha)
    Lchi = Ladv(chi)
    Lkhat = Ladv(khat)
    Ltheta = Ladv(theta)
    Lbeta = [Ladv(beta[a]) for a in range(3)]
    Lgam = [Ladv(gam[a]) for a in range(3)]
    Lg = [[Ladv(g[a][b]) if a <= b else None for b in range(3)]
          for a in range(3)]
    LA = [[Ladv(A[a][b]) if a <= b else None for b in range(3)]
          for a in range(3)]

    # KO dissipation per channel (reference: z4c_calcrhs.cpp:570-585)
    ko = [ops.ko(ch(c)) for c in range(NZ4C)] if diss != 0.0 else None

    # ---- derivatives done: center every algebraic operand
    C = ops.center
    chi = C(chi)
    g = [[C(g[a][b]) for b in range(3)] for a in range(3)]
    khat = C(khat)
    A = [[C(A[a][b]) for b in range(3)] for a in range(3)]
    gam = [C(gam[a]) for a in range(3)]
    theta = C(theta)
    alpha = C(alpha)
    beta = [C(beta[a]) for a in range(3)]

    K = khat + 2.0 * theta

    detg = spatial_det(g)
    gu = spatial_inv(g, detg)

    # Christoffels of the conformal metric
    Gddd = [[[0.5 * (dg[a][b][c] + dg[b][a][c] - dg[c][a][b])
              for b in range(3)] for a in range(3)] for c in range(3)]
    Gudd = [[[sum(gu[c][d] * Gddd[d][a][b] for d in range(3))
              for b in range(3)] for a in range(3)] for c in range(3)]
    gam_c = [sum(gu[b][c] * Gudd[a][b][c]
                 for b in range(3) for c in range(3))
             for a in range(3)]  # computed Gamma_u

    # conformal Ricci (reference: z4c_calcrhs.cpp:305-328)
    Rdd = [[None] * 3 for _ in range(3)]
    for a, b in _sym_pairs():
        # note the index placement of the Gamma-Gamma_ddd term:
        # Gam^c (Gamma_{a,bc} + Gamma_{b,ac}), NOT Gamma_{c,ab}
        # (reference: z4c_calcrhs.cpp:309-311)
        r = sum(0.5 * (g[c][a] * dgam[b][c] + g[c][b] * dgam[a][c]
                       + gam_c[c] * (Gddd[a][b][c] + Gddd[b][a][c]))
                for c in range(3))
        r = r - sum(0.5 * gu[c][d] * DDg(c, d, a, b)
                    for c in range(3) for d in range(3))
        r = r + sum(gu[c][d] * (Gudd[e][c][a] * Gddd[b][e][d]
                                + Gudd[e][c][b] * Gddd[a][e][d]
                                + Gudd[e][a][d] * Gddd[e][c][b])
                    for c in range(3) for d in range(3)
                    for e in range(3))
        Rdd[a][b] = r
        Rdd[b][a] = r

    # conformal-factor pieces (reference: z4c_calcrhs.cpp:329-356)
    chi_g = torch.clamp(chi, min=opt.chi_div_floor)
    oopsi4 = chi_g ** (-4.0 / opt.chi_psi_power)
    npow = opt.chi_psi_power
    dphi = [dchi[a] / (chi_g * npow) for a in range(3)]
    Ddphi = [[None] * 3 for _ in range(3)]
    for a, b in _sym_pairs():
        v = (ddchi[a][b] / (chi_g * npow)
             - npow * dphi[a] * dphi[b]
             - sum(Gudd[c][a][b] * dphi[c] for c in range(3)))
        Ddphi[a][b] = v
        Ddphi[b][a] = v
    trDdphi = sum(gu[c][d] * (Ddphi[c][d] + 2.0 * dphi[c] * dphi[d])
                  for c in range(3) for d in range(3))
    Rphi = [[None] * 3 for _ in range(3)]
    for a, b in _sym_pairs():
        v = (4.0 * dphi[a] * dphi[b] - 2.0 * Ddphi[a][b]
             - 2.0 * g[a][b] * trDdphi)
        Rphi[a][b] = v
        Rphi[b][a] = v

    # second covariant derivative of the lapse
    # (reference: z4c_calcrhs.cpp:370-388)
    dphidalpha = sum(gu[c][d] * dphi[c] * dalpha[d]
                     for c in range(3) for d in range(3))
    Ddalpha_dd = [[None] * 3 for _ in range(3)]
    for a, b in _sym_pairs():
        v = (ddalpha[a][b]
             - 2.0 * (dphi[a] * dalpha[b] + dphi[b] * dalpha[a])
             - sum(Gudd[c][a][b] * dalpha[c] for c in range(3))
             + 2.0 * g[a][b] * dphidalpha)
        Ddalpha_dd[a][b] = v
        Ddalpha_dd[b][a] = v
    Ddalpha = sum(oopsi4 * gu[a][b] * Ddalpha_dd[a][b]
                  for a in range(3) for b in range(3))

    # A contractions (reference: z4c_calcrhs.cpp:392-420)
    AA_dd = [[None] * 3 for _ in range(3)]
    for a, b in _sym_pairs():
        v = sum(gu[c][d] * A[a][c] * A[d][b]
                for c in range(3) for d in range(3))
        AA_dd[a][b] = v
        AA_dd[b][a] = v
    AA = sum(gu[a][b] * AA_dd[a][b] for a in range(3) for b in range(3))
    Auu = [[sum(gu[a][c] * gu[b][d] * A[c][d]
                for c in range(3) for d in range(3))
            for b in range(3)] for a in range(3)]
    DA_u = []
    for a in range(3):
        v = sum(-(3.0 / 2.0) * Auu[a][b] * dchi[b] / chi_g
                - (1.0 / 3.0) * gu[a][b] * (2.0 * dkhat[b] + dtheta[b])
                for b in range(3))
        v = v + sum(Gudd[a][b][c] * Auu[b][c]
                    for b in range(3) for c in range(3))
        DA_u.append(v)

    # Ricci scalar + Hamiltonian (vacuum)
    R = sum(oopsi4 * gu[a][b] * (Rdd[a][b] + Rphi[a][b])
            for a in range(3) for b in range(3))
    Ht = R + (2.0 / 3.0) * K * K - AA

    # shift contractions (reference: z4c_calcrhs.cpp:438-480)
    divbeta = sum(dbeta[a][a] for a in range(3))
    ddbeta_d = [sum((1.0 / 3.0) * ddbeta[a][b][b] for b in range(3))
                for a in range(3)]

    Lchi = Lchi + (1.0 / 6.0) * npow * chi_g * divbeta
    for a in range(3):
        Lgam[a] = (Lgam[a] + (2.0 / 3.0) * gam_c[a] * divbeta
                   + sum(gu[a][b] * ddbeta_d[b]
                         - gam_c[b] * dbeta[b][a] for b in range(3))
                   + sum(gu[b][c] * ddbeta[b][c][a]
                         for b in range(3) for c in range(3)))
    for a, b in _sym_pairs():
        Lg[a][b] = (Lg[a][b] - (2.0 / 3.0) * g[a][b] * divbeta
                    + sum(dbeta[a][c] * g[b][c] + dbeta[b][c] * g[a][c]
                          for c in range(3)))
        LA[a][b] = (LA[a][b] - (2.0 / 3.0) * A[a][b] * divbeta
                    + sum(dbeta[b][c] * A[a][c] + dbeta[a][c] * A[b][c]
                          for c in range(3)))

    # ---------------------------------------------------------- assemble
    out = [None] * NZ4C
    k1, k2 = opt.damp_kappa1, opt.damp_kappa2

    out[I_KHAT] = (-Ddalpha + alpha * (AA + (1.0 / 3.0) * K * K) + Lkhat
                   + k1 * (1.0 - k2) * alpha * theta)
    out[I_CHI] = Lchi - (1.0 / 6.0) * npow * chi_g * alpha * K
    out[I_THETA] = opt.use_z4c * (
        Ltheta + alpha * (0.5 * Ht - (2.0 + k2) * k1 * theta))

    for a in range(3):
        out[I_GAMX + a] = (
            2.0 * alpha * DA_u[a] + Lgam[a]
            - 2.0 * alpha * k1 * (gam[a] - gam_c[a])
            - sum(2.0 * Auu[a][b] * dalpha[b] for b in range(3)))

    for a, b in _sym_pairs():
        out[I_GXX + sym_idx(a, b)] = -2.0 * alpha * A[a][b] + Lg[a][b]
        out[I_AXX + sym_idx(a, b)] = (
            oopsi4 * (-Ddalpha_dd[a][b]
                      + alpha * (Rdd[a][b] + Rphi[a][b]))
            - (1.0 / 3.0) * g[a][b] * (-Ddalpha + alpha * R)
            + alpha * (K * A[a][b] - 2.0 * AA_dd[a][b])
            + LA[a][b])

    # gauge (reference: z4c_calcrhs.cpp:536-567)
    f = opt.lapse_oplog * opt.lapse_harmonicf + opt.lapse_harmonic * alpha
    out[I_ALPHA] = opt.lapse_advect * Lalpha - f * alpha * khat
    for a in range(3):
        v = (opt.shift_ggamma * gam[a] + opt.shift_advect * Lbeta[a]
             - opt.shift_eta * beta[a]
             + opt.shift_alpha2ggamma * alpha * alpha * gam[a])
        if opt.shift_hh != 0.0:
            v = v + sum(opt.shift_hh * alpha * chi_g
                        * (0.5 * alpha * dchi[b] - dalpha[b]) * gu[a][b]
                        for b in range(3))
        out[I_BETAX + a] = v

    # ------------------------------------------------- matter coupling
    # stress-energy source terms (reference: z4c_calcrhs.cpp:364,
    # 490-532; tmunu = {"E", "S_d"[3], "S_dd"[6]} undensitised,
    # centre-shaped)
    if tmunu is not None:
        fourpi = 4.0 * math.pi
        E_m = tmunu["E"]
        S_d_m = tmunu["S_d"]
        S_dd_m = tmunu["S_dd"]
        S_m = oopsi4 * sum(
            gu[a][b] * S_dd_m[sym_idx(a, b)]
            for a in range(3) for b in range(3))
        out[I_KHAT] = out[I_KHAT] + fourpi * alpha * (S_m + E_m)
        out[I_THETA] = out[I_THETA] - (
            2.0 * fourpi * alpha * E_m * opt.use_z4c)
        for a in range(3):
            out[I_GAMX + a] = out[I_GAMX + a] - (
                4.0 * fourpi * alpha
                * sum(gu[a][b] * S_d_m[b] for b in range(3)))
        for a, b in _sym_pairs():
            c = I_AXX + sym_idx(a, b)
            out[c] = out[c] - (
                2.0 * fourpi * alpha
                * (oopsi4 * S_dd_m[sym_idx(a, b)]
                   - (1.0 / 3.0) * S_m * g[a][b]))

    # Sommerfeld radiative RHS on the outer active layer
    # (reference: Z4cSommerfeld, z4c_Sbc.cpp:25-122; derivatives forced
    # to 2nd order for stability as in the reference)
    sbc = ops.sbc()
    if sbc is not None:
        mask, r, s_u = sbc

        def somm(cidx, speed):
            ff = ch(cidx)
            o = -speed * ops.center(ff) / r
            for d in range(3):
                o = o - speed * s_u[d] * ops.d1_o2(ff, d)
            return o

        out[I_KHAT] = torch.where(mask, somm(I_KHAT, math.sqrt(2.0)),
                                  out[I_KHAT])
        out[I_THETA] = torch.where(mask, somm(I_THETA, 1.0), out[I_THETA])
        for a in range(3):
            out[I_GAMX + a] = torch.where(
                mask, somm(I_GAMX + a, 1.0), out[I_GAMX + a])
        for a, b in _sym_pairs():
            c = I_AXX + sym_idx(a, b)
            out[c] = torch.where(mask, somm(c, 1.0), out[c])

    # Kreiss-Oliger dissipation on every channel
    if ko is not None:
        out = [o + diss * k for o, k in zip(out, ko)]
    return out
