"""Cartesian Kerr-Schild metric on torch tensors.

Counterpart of ``athenak_tpu/gr/cks.py`` (reference: the inline metric
functions of src/coordinates/cartesian_ks.hpp:26-379): g_ab = f l_a l_b +
eta_ab with the Kerr-Schild null vector, its inverse, the spatial
derivatives and the ADM decomposition.  The functions take tensors of
any dtype and shape (broadcastable coordinate arrays) and return nested
4x4 (3x3) lists of tensors, as the JAX package's do.  The JAX package
recomputes the metric inside ``jit``, where XLA fuses it into its
consumers; the port computes it once a run (``coordinates.GRGeometry``).
"""

from __future__ import annotations

import torch

_EPS = 1.0e-6


def _ks_radius(x, y, z, a):
    rad2 = x * x + y * y + z * z
    r2 = 0.5 * (rad2 - a * a
                + torch.sqrt((rad2 - a * a) ** 2 + 4.0 * a * a * z * z))
    r = torch.sqrt(r2)
    return torch.where(r < _EPS, 0.5 * (_EPS + r * r / _EPS), r)


def _null_vector(x, y, z, r, a):
    qb = r * r + a * a
    return (torch.ones_like(r), (r * x + a * y) / qb,
            (r * y - a * x) / qb, z / r)


_ETA = ((-1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0),
        (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def metric(x, y, z, a, minkowski=False):
    """(glower, gupper) as nested 4x4 lists of tensors (reference:
    ComputeMetricAndInverse, cartesian_ks.hpp:26-99)."""
    r = _ks_radius(x, y, z, a)
    ll = _null_vector(x, y, z, r, a)
    f = 2.0 * r ** 3 / (r ** 4 + a * a * z * z)
    if minkowski:
        f = torch.zeros_like(r)
    glower = [[f * ll[i] * ll[j] + _ETA[i][j] for j in range(4)]
              for i in range(4)]
    # l^0 = -1, l^i = l_i; g^ab = -f l^a l^b + eta^ab
    lu = (-ll[0], ll[1], ll[2], ll[3])
    gupper = [[-f * lu[i] * lu[j] + _ETA[i][j] for j in range(4)]
              for i in range(4)]
    return glower, gupper


def metric_derivatives(x, y, z, a, minkowski=False):
    """(dg_dx1, dg_dx2, dg_dx3), nested 4x4 lists (reference:
    ComputeMetricDerivatives, cartesian_ks.hpp:276-379)."""
    r = _ks_radius(x, y, z, a)
    ll = _null_vector(x, y, z, r, a)
    rad2 = x * x + y * y + z * z
    qa = 2.0 * r * r - rad2 + a * a
    qb = r * r + a * a
    qc = 3.0 * (a * z) ** 2 - r ** 4
    f = 2.0 * r ** 3 / (r ** 4 + a * a * z * z)

    df = (f * f * x / (2.0 * r ** 3) * qc / qa,
          f * f * y / (2.0 * r ** 3) * qc / qa,
          f * f * z / (2.0 * r ** 5) * (qc * qb / qa - 2.0 * (a * r) ** 2))
    qx = a * a * x - 2.0 * a * r * y - r * r * x
    qy = a * a * y + 2.0 * a * r * x - r * r * y
    dl1 = (x * r * qx / (qb * qb * qa) + r / qb,
           y * r * qx / (qb * qb * qa) + a / qb,
           z / r * qx / (qb * qa))
    dl2 = (x * r * qy / (qb * qb * qa) - a / qb,
           y * r * qy / (qb * qb * qa) + r / qb,
           z / r * qy / (qb * qa))
    dl3 = (-x * z / (r * qa),
           -y * z / (r * qa),
           -z * z / (r ** 3) * qb / qa + 1.0 / r)
    zero = torch.zeros_like(r)
    dl0 = (zero, zero, zero)
    if minkowski:
        f = zero
        df = (zero, zero, zero)
    dl = (dl0, dl1, dl2, dl3)
    out = []
    for d in range(3):
        out.append([[df[d] * ll[i] * ll[j] + f * dl[i][d] * ll[j]
                     + f * ll[i] * dl[j][d] for j in range(4)]
                    for i in range(4)])
    return out[0], out[1], out[2]


def adm_decomposition(x, y, z, a, minkowski=False):
    """Lapse, shift and spatial metric of CKS (reference:
    ComputeADMDecomposition, cartesian_ks.hpp:106-268).  Returns
    (alp, (bx, by, bz), g_dd as a nested 3x3 list)."""
    r = _ks_radius(x, y, z, a)
    _, l1, l2, l3 = _null_vector(x, y, z, r, a)
    h = r ** 3 / (r ** 4 + a * a * z * z)
    if minkowski:
        h = torch.zeros_like(r)
    alp = 1.0 / torch.sqrt(1.0 + 2.0 * h)
    fac = 2.0 * h / (1.0 + 2.0 * h)
    beta = (fac * l1, fac * l2, fac * l3)
    ld = (l1, l2, l3)
    g_dd = [[2.0 * h * ld[i] * ld[j] + (1.0 if i == j else 0.0)
             for j in range(3)] for i in range(3)]
    return alp, beta, g_dd
