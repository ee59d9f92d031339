"""ADM -> Z4c initial-data conversion.

Counterpart of ``athenak_tpu/z4c/adm_ic.py``, a copy kept in the port:
host-side (numpy, float64) analogue of the reference's Z4c::ADMToZ4c
(reference: src/z4c/z4c_adm.cpp:27-195):

    p         = detg^(-1/3)
    chi       = detg^(chi_psi_power/12)
    gt_ij     = p g_ij            (unit-determinant conformal metric)
    Kt_ij     = p K_ij
    Khat      = gt^ij Kt_ij       (Theta = 0 initially)
    At_ij     = Kt_ij - Khat gt_ij / 3
    Gam^i     = -d_j gt^ji        (central differences, interior)

Gauge defaults follow GaugePreCollapsedLapse
(src/z4c/z4c_gauge.cpp:25-48): alpha = psi4^(-1/2) = detg^(-1/6),
beta = 0; callers may pass explicit alpha / beta_u (the reference's ADM
gauge storage aliases the evolved Z4c gauge, coordinates/adm.cpp:49-50,
so pgen-set shifts seed the evolution there too).

Used by the analytic-ADM problem generators (boosted puncture, Kerr-
Schild, the AwA gauge wave and robust-stability tests) that give their
data as (g_ij, K_ij) rather than in Z4c variables; they move the result
to the run's device at its dtype.
"""

from __future__ import annotations

import numpy as np

from .z4c import (I_ALPHA, I_AXX, I_BETAX, I_CHI, I_GAMX, I_GXX, I_KHAT,
                  I_THETA, NZ4C, sym_idx)

_SYM6 = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def _det_sym(g):
    """det of a [6, ...] symmetric-storage 3-metric."""
    gxx, gxy, gxz, gyy, gyz, gzz = g
    return (gxx * (gyy * gzz - gyz * gyz)
            - gxy * (gxy * gzz - gyz * gxz)
            + gxz * (gxy * gyz - gyy * gxz))


def _inv_sym(g, detg):
    """Inverse of a [6, ...] symmetric-storage 3-metric (same layout)."""
    gxx, gxy, gxz, gyy, gyz, gzz = g
    inv = np.empty_like(g)
    inv[0] = (gyy * gzz - gyz * gyz) / detg
    inv[1] = (gxz * gyz - gxy * gzz) / detg
    inv[2] = (gxy * gyz - gxz * gyy) / detg
    inv[3] = (gxx * gzz - gxz * gxz) / detg
    inv[4] = (gxy * gxz - gxx * gyz) / detg
    inv[5] = (gxx * gyy - gxy * gxy) / detg
    return inv


def adm_to_z4c(mesh, g_dd, K_dd, alpha=None, beta_u=None,
               chi_psi_power: float = -4.0) -> np.ndarray:
    """Convert ADM data to the Z4c evolved vector.

    g_dd, K_dd : [nmb, 6, n3, n2, n1] symmetric-storage metric and
                 extrinsic curvature (xx,xy,xz,yy,yz,zz).
    alpha      : [nmb, n3, n2, n1] lapse, default precollapsed
                 detg^(-1/6).
    beta_u     : [nmb, 3, n3, n2, n1] shift, default zero.

    Returns u [nmb, NZ4C, n3, n2, n1]; Gam^i is valid away from the two
    outermost cells of each block face (5-point stencil via
    np.gradient); the driver's first ghost exchange overwrites block-
    edge ghosts.
    """
    g_dd = np.asarray(g_dd, dtype=np.float64)
    K_dd = np.asarray(K_dd, dtype=np.float64)
    nmb = g_dd.shape[0]
    u = np.zeros((nmb, NZ4C) + g_dd.shape[2:], dtype=np.float64)

    detg = _det_sym(np.moveaxis(g_dd, 1, 0))
    oopsi4 = detg ** (-1.0 / 3.0)
    u[:, I_CHI] = detg ** (chi_psi_power / 12.0)

    gt = g_dd * oopsi4[:, None]
    Kt = K_dd * oopsi4[:, None]

    detgt = _det_sym(np.moveaxis(gt, 1, 0))
    gtinv = np.moveaxis(
        _inv_sym(np.moveaxis(gt, 1, 0), detgt), 0, 1)

    # Khat = gt^ij Kt_ij: off-diagonal sym entries count twice
    w6 = np.array([1.0, 2.0, 2.0, 1.0, 2.0, 1.0]).reshape(
        (1, 6) + (1,) * (g_dd.ndim - 2))
    khat = np.sum(gtinv * Kt * w6, axis=1)
    u[:, I_KHAT] = khat

    for s in range(6):
        u[:, I_AXX + s] = Kt[:, s] - khat * gt[:, s] / 3.0
    for s in range(6):
        u[:, I_GXX + s] = gt[:, s]

    # Gam^a = -d_b gt^{ba} per block, with the SAME 2*ng-2 order FD the
    # evolution uses — a lower-order Gamma seed contaminates the Ricci
    # (via dGam) with an O(amp dx^2) constraint violation that would
    # dominate smooth-data tests (np.roll wrap garbage lands in ghosts,
    # overwritten by the first fill)
    from . import fd
    ng = mesh.mb_indcs.ng
    sten = fd._D1[min(max(ng, 2), 5)]
    dxs = [np.asarray(mesh.mb_size[f"d{ax}"], dtype=np.float64)
           for ax in ("x1", "x2", "x3")]
    for m in range(nmb):
        for a in range(3):
            gam = np.zeros_like(detg[m])
            for b, axis in enumerate((2, 1, 0)):
                comp = gtinv[m, sym_idx(b, a)]
                h = float(dxs[b][m])
                for off, c in sten:
                    gam -= (c / h) * np.roll(comp, -off, axis=axis)
            u[m, I_GAMX + a] = gam

    u[:, I_THETA] = 0.0
    if alpha is None:
        u[:, I_ALPHA] = detg ** (-1.0 / 6.0)
    else:
        u[:, I_ALPHA] = np.asarray(alpha, dtype=np.float64)
    if beta_u is not None:
        for a in range(3):
            u[:, I_BETAX + a] = np.asarray(beta_u[:, a], dtype=np.float64)
    return u
