"""Kerr black hole in Cartesian Kerr-Schild coordinates as Z4c data.

Counterpart of ``athenak_tpu/pgen/z4c_kerr_schild.py`` (reference:
src/pgen/z4c/kerr_schild.cpp + the analytic ADM decomposition
ComputeADMDecomposition (src/coordinates/cartesian_ks.hpp:100-260):
g_ij = eta_ij + 2H l_i l_j, alpha = 1/sqrt(1+2H), beta^i = 2H l^i/(1+2H),
and the stationary extrinsic curvature K_ij = D_(i beta_j) / alpha from
the analytic dH, dl expressions.  The evolved lapse is then set
pre-collapsed, alpha = psi4^-1/2 (Z4c::GaugePreCollapsedLapse,
z4c_gauge.cpp:28-50), the standard start for single-BH gauge evolution.
"""

from __future__ import annotations

import numpy as np

from ..z4c.adm_ic import adm_to_z4c
from ..z4c.z4c import sym_idx
from . import to_device


def ks_adm(x, y, z, a: float, minkowski: bool = False):
    """Vectorized ADM decomposition of the CKS metric.

    Returns (alpha, beta_u[3], g_dd[6], K_dd[6]) with sym6 component
    order; inputs broadcast to a common shape.
    """
    x, y, z = np.broadcast_arrays(x, y, z)
    rad2 = x * x + y * y + z * z
    r2 = (rad2 - a * a
          + np.sqrt((rad2 - a * a) ** 2 + 4.0 * a * a * z * z)) / 2.0
    r = np.sqrt(r2)
    eps = 1e-6
    r = np.where(r < eps, 0.5 * (eps + r * r / eps), r)
    r2 = r * r

    qb = r2 + a * a
    l_d = np.stack([(r * x + a * y) / qb,
                    (r * y - a * x) / qb,
                    z / r])
    H = r2 * r / (r2 * r2 + a * a * z * z)
    if minkowski:
        H = np.zeros_like(H)

    alpha = 1.0 / np.sqrt(1.0 + 2.0 * H)
    beta_u = [2.0 * H / (1.0 + 2.0 * H) * l_d[i] for i in range(3)]

    g_dd = [2.0 * H * l_d[i] * l_d[j] + (1.0 if i == j else 0.0)
            for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]

    # analytic gradients (cartesian_ks.hpp:168-231)
    qa = 2.0 * r2 - rad2 + a * a
    qc = 3.0 * (a * z) ** 2 - r2 * r2
    dH = np.stack([
        H * H * x / r ** 3 * qc / qa,
        H * H * y / r ** 3 * qc / qa,
        H * H * z / r ** 5 * (qc * qb / qa - 2.0 * (a * r) ** 2)])
    common_x = (a * a * x - 2.0 * a * r * y - r2 * x)
    common_y = (a * a * y + 2.0 * a * r * x - r2 * y)
    dl = np.empty((3, 3) + x.shape)
    dl[0, 0] = x * r * common_x / (qb * qb * qa) + r / qb
    dl[0, 1] = x * r * common_y / (qb * qb * qa) - a / qb
    dl[0, 2] = -x * z / (r * qa)
    dl[1, 0] = y * r * common_x / (qb * qb * qa) + a / qb
    dl[1, 1] = y * r * common_y / (qb * qb * qa) + r / qb
    dl[1, 2] = -y * z / (r * qa)
    dl[2, 0] = z / r * common_x / (qb * qa)
    dl[2, 1] = z / r * common_y / (qb * qa)
    dl[2, 2] = -z * z / (r2 * r) * qb / qa + 1.0 / r
    if minkowski:
        dH = np.zeros_like(dH)

    def g6(i, j):
        return g_dd[sym_idx(i, j)]

    # metric gradient and Christoffels of gamma_ij
    dg = np.empty((3, 3, 3) + x.shape)
    for i in range(3):
        for aa in range(3):
            for bb in range(3):
                dg[i, aa, bb] = (2.0 * dH[i] * l_d[aa] * l_d[bb]
                                 + 2.0 * H * dl[i, aa] * l_d[bb]
                                 + 2.0 * H * l_d[aa] * dl[i, bb])
    det = (g6(0, 0) * (g6(1, 1) * g6(2, 2) - g6(1, 2) ** 2)
           - g6(0, 1) * (g6(0, 1) * g6(2, 2) - g6(0, 2) * g6(1, 2))
           + g6(0, 2) * (g6(0, 1) * g6(1, 2) - g6(0, 2) * g6(1, 1)))
    idet = 1.0 / det
    gu = np.empty((3, 3) + x.shape)
    gu[0, 0] = (g6(1, 1) * g6(2, 2) - g6(1, 2) ** 2) * idet
    gu[0, 1] = (g6(0, 2) * g6(1, 2) - g6(0, 1) * g6(2, 2)) * idet
    gu[0, 2] = (g6(0, 1) * g6(1, 2) - g6(0, 2) * g6(1, 1)) * idet
    gu[1, 1] = (g6(0, 0) * g6(2, 2) - g6(0, 2) ** 2) * idet
    gu[1, 2] = (g6(0, 1) * g6(0, 2) - g6(0, 0) * g6(1, 2)) * idet
    gu[2, 2] = (g6(0, 0) * g6(1, 1) - g6(0, 1) ** 2) * idet
    gu[1, 0], gu[2, 0], gu[2, 1] = gu[0, 1], gu[0, 2], gu[1, 2]

    gamma = np.empty((3, 3, 3) + x.shape)
    for aa in range(3):
        for bb in range(3):
            for cc in range(3):
                gamma[aa, bb, cc] = 0.5 * sum(
                    gu[aa, d] * (dg[cc, bb, d] + dg[bb, d, cc]
                                 - dg[d, bb, cc]) for d in range(3))

    dbeta = np.empty((3, 3) + x.shape)
    for i in range(3):
        for j in range(3):
            dbeta[i, j] = 2.0 * dH[i] * l_d[j] + 2.0 * H * dl[i, j]
    beta_d = [2.0 * H * l_d[i] for i in range(3)]

    # K_ij = (D_i beta_j + D_j beta_i) / (2 alpha), stationary spacetime
    K_dd = []
    for (i, j) in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)):
        Dij = dbeta[i, j] - sum(gamma[c, i, j] * beta_d[c]
                                for c in range(3))
        Dji = dbeta[j, i] - sum(gamma[c, j, i] * beta_d[c]
                                for c in range(3))
        K_dd.append((Dij + Dji) / (2.0 * alpha))
    return alpha, beta_u, g_dd, K_dd


def init(pin, mesh, phys):
    a = pin.get_or_add_real("problem", "punc_spin", 0.0)
    cx = pin.get_or_add_real("problem", "punc_center_x1", 0.0)
    cy = pin.get_or_add_real("problem", "punc_center_x2", 0.0)
    cz = pin.get_or_add_real("problem", "punc_center_x3", 0.0)
    minkowski = pin.get_or_add_boolean("problem", "minkowski", False)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    shp = (nmb, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    alpha = np.empty(shp)
    beta_u = np.empty((nmb, 3) + shp[1:])
    g_dd = np.empty((nmb, 6) + shp[1:])
    K_dd = np.empty((nmb, 6) + shp[1:])
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X1 = x1v[None, None, :] - cx
        X2 = x2v[None, :, None] - cy
        X3 = x3v[:, None, None] - cz
        al, bu, gd, kd = ks_adm(X1, X2, X3, a, minkowski)
        alpha[gid] = al
        for c in range(3):
            beta_u[gid, c] = bu[c]
        for c in range(6):
            g_dd[gid, c] = gd[c]
            K_dd[gid, c] = kd[c]

    # alpha=None -> the pre-collapsed lapse detg^(-1/6) = psi4^(-1/2)
    # (adm_to_z4c default; matches GaugePreCollapsedLapse after the
    # analytic KS lapse is discarded, kerr_schild.cpp:55-60)
    u = adm_to_z4c(mesh, g_dd, K_dd, alpha=None, beta_u=beta_u)
    del alpha
    return phys.make_state(to_device(phys, u))
