"""Boosted single puncture (no spin) initial data for Z4c.

Counterpart of ``athenak_tpu/pgen/z4c_boosted_puncture.py`` (reference:
src/pgen/tests/z4c_boosted_puncture.cpp):
analytic Lorentz boost of the isotropic Schwarzschild puncture,
following arXiv:0810.4735 (eqs. 2-4) and arXiv:1909.02997.  In the
frame where the puncture moves with velocity v along x1:

    x0      = Gamma (x - c)            (comoving coordinate at t = 0)
    psi0    = 1 + m/(2 r0)
    alpha0  = (1 - m/(2 r0)) / psi0
    B0^2    = Gamma^2 (1 - v^2 alpha0^2 / psi0^4)

    g_xx    = B0^2 psi0^4,  g_yy = g_zz = psi0^4
    beta^x  = v (alpha0^2 - psi0^4) / (psi0^4 - alpha0^2 v^2)
    K_ij    = boosted extrinsic curvature (x1-aligned; see below)

The ADM data is converted through z4c.adm_ic.adm_to_z4c (the
reference's ADMToZ4c) with the precollapsed lapse alpha = psi4^(-1/2)
(GaugePreCollapsedLapse).  The z4c_amr chi criterion plus the puncture
tracker make this the standard moving-puncture regression
(reference: tst/test_suite/z4c/test_z4c_boosted_gpu.py).
"""

from __future__ import annotations

import numpy as np

from ..z4c.adm_ic import adm_to_z4c
from . import to_device


def _adm_boosted(X1, X2, X3, m0: float, vel: float):
    """ADM (g_dd[6], K_dd[6], beta_u[3]) of a puncture boosted along x1.

    X* are broadcastable cell-center offsets from the puncture center.
    Expressions follow arXiv:0810.4735 eq. 2-4 / arXiv:1909.02997 (the
    reference implements the same algebra pointwise,
    z4c_boosted_puncture.cpp:75-178).
    """
    gam2 = 1.0 / (1.0 - vel * vel)
    Gamma = np.sqrt(gam2)

    x0 = Gamma * X1
    r0 = np.sqrt(x0 ** 2 + X2 ** 2 + X3 ** 2)
    r0 = np.maximum(r0, 1e-12)

    psi0 = 1.0 + 0.5 * m0 / r0
    psi4 = psi0 ** 4
    alpha0 = (1.0 - 0.5 * m0 / r0) / psi0
    B0 = np.sqrt(gam2 * (1.0 - vel * vel * alpha0 ** 2 / psi4))

    shape = np.broadcast_shapes(X1.shape, X2.shape, X3.shape)
    g = np.zeros((6,) + shape)
    K = np.zeros((6,) + shape)
    beta = np.zeros((3,) + shape)

    g[0] = psi4 * B0 ** 2          # xx
    g[3] = psi4 + 0.0 * r0         # yy
    g[5] = psi4 + 0.0 * r0         # zz
    beta[0] = vel * (alpha0 ** 2 - psi4) / (psi4 - alpha0 ** 2 * vel ** 2)

    # d alpha0 / d r0 and the shared curvature bracket
    alpha0p = 4.0 * m0 / (m0 + 2.0 * r0) ** 2
    num = (4.0 * vel ** 2 * (m0 - 2.0 * r0) ** 2 / (m0 + 2.0 * r0) ** 3
           + 4.0 * vel ** 2 * (m0 - 2.0 * r0) / (m0 + 2.0 * r0) ** 2
           - m0 * (m0 + 2.0 * r0) ** 3 / (4.0 * r0 ** 5))
    den = psi0 ** 4 - vel ** 2 * (m0 - 2.0 * r0) ** 2 \
        / (m0 + 2.0 * r0) ** 2
    sec = num / den

    dpsi = -0.5 * m0 / r0 ** 2      # d psi0 / d r0
    K[0] = gam2 * B0 * X1 * vel / r0 * (2.0 * alpha0p - 0.5 * alpha0 * sec)
    K[3] = 2.0 * gam2 * X1 * vel * alpha0 * dpsi / (psi0 * B0 * r0)
    K[5] = K[3].copy()
    K[1] = B0 * X2 * vel / r0 * (alpha0p - 0.5 * alpha0 * sec)
    K[2] = B0 * X3 * vel / r0 * (alpha0p - 0.5 * alpha0 * sec)
    return g, K, beta


def init(pin, mesh, phys):
    m0 = pin.get_or_add_real("problem", "punc_ADM_mass", 1.0)
    c1 = pin.get_or_add_real("problem", "punc_center_x1", 0.0)
    c2 = pin.get_or_add_real("problem", "punc_center_x2", 0.0)
    c3 = pin.get_or_add_real("problem", "punc_center_x3", 0.0)
    v1 = pin.get_or_add_real("problem", "punc_velocity_x1", 0.0)
    # (the reference also reads vx2/vx3 but its algebra assumes an
    # x1-aligned boost; enforce that here)
    if (pin.get_or_add_real("problem", "punc_velocity_x2", 0.0) != 0.0 or
            pin.get_or_add_real("problem", "punc_velocity_x3", 0.0) != 0.0):
        raise NotImplementedError("boosted puncture: only x1 boosts")

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    sh = (nmb, 6, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    g_dd = np.zeros(sh)
    K_dd = np.zeros(sh)
    beta_u = np.zeros((nmb, 3) + sh[2:])
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X1 = np.broadcast_to(x1v[None, None, :] - c1, sh[2:])
        X2 = np.broadcast_to(x2v[None, :, None] - c2, sh[2:])
        X3 = np.broadcast_to(x3v[:, None, None] - c3, sh[2:])
        g, K, b = _adm_boosted(X1, X2, X3, m0, v1)
        g_dd[gid], K_dd[gid], beta_u[gid] = g, K, b

    u = adm_to_z4c(mesh, g_dd, K_dd, beta_u=beta_u,
                   chi_psi_power=phys.opt.chi_psi_power)
    return phys.make_state(to_device(phys, u))
