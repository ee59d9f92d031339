"""Orthonormal tetrads on Cartesian Kerr-Schild coordinates, on tensors.

Counterpart of ``athenak_tpu/radiation/tetrad.py`` (reference:
src/radiation/radiation_tetrad.hpp:17-175, radiation_tetrad.cpp:26-280):
the closed-form CKS tetrad (the time leg along the coordinate normal of
the KS form, the spatial legs by explicit Gram-Schmidt), its analytic
derivatives, the Ricci rotation coefficients the angular fluxes use, and
the normal-frame -> tetrad-frame velocity transformation.  Every function
is elementwise over broadcastable coordinate tensors and returns nested
lists of tensors, as the JAX package's do; the metric comes from the
port's ``gr/cks.py``.
"""

from __future__ import annotations

import torch

from ..gr.cks import metric, metric_derivatives

_ETA_SIGN = (-1.0, 1.0, 1.0, 1.0)


def _ks_terms(x, y, z, a):
    """(rad2, r, ll1, ll2, ll3, f) of the tetrad: the KS radius clamped
    at 1, the null vector and f = 2 r^3 / (r^4 + a^2 z^2)."""
    rad2 = x * x + y * y + z * z
    r2 = (rad2 - a * a
          + torch.sqrt((rad2 - a * a) ** 2 + 4.0 * a * a * z * z)) / 2.0
    r = torch.clamp(torch.sqrt(r2), min=1.0)
    ll1 = (r * x + a * y) / (r * r + a * a)
    ll2 = (r * y - a * x) / (r * r + a * a)
    ll3 = z / r
    f = 2.0 * r ** 3 / (r ** 4 + a * a * z * z)
    return rad2, r, ll1, ll2, ll3, f


def tetrad(x, y, z, spin, minkowski=False):
    """Tetrad e[a][mu] = e_(a)^mu and covariant ecov[a][mu] = e_(a)_mu
    (reference: ComputeTetrad, radiation_tetrad.hpp:17-54)."""
    _, _, ll1, ll2, ll3, f = _ks_terms(x, y, z, spin)
    if minkowski:
        f = 0.0 * f
    wa = torch.sqrt(1.0 + f)
    wb = torch.sqrt(1.0 + f * (ll1 * ll1 + ll2 * ll2))
    wc = torch.sqrt(1.0 + f * ll2 * ll2)
    iwa, iwb, iwc = 1.0 / wa, 1.0 / wb, 1.0 / wc
    zero = 0.0 * wa
    e = [[wa, -f * iwa * ll1, -f * iwa * ll2, -f * iwa * ll3],
         [zero, iwb * wc, -f * iwb * iwc * ll1 * ll2, zero],
         [zero, zero, iwc, zero],
         [zero, -f * iwa * iwb * ll1 * ll3,
          -f * iwa * iwb * ll2 * ll3, iwa * wb]]
    # e_(a)_mu = g_mu_nu e_(a)^nu with g = eta + f l l, l_mu = (1, l1,
    # l2, l3)
    ll = [1.0 + zero, ll1, ll2, ll3]

    def gdot(v):
        lv = v[0] + ll1 * v[1] + ll2 * v[2] + ll3 * v[3]
        return [_ETA_SIGN[mu] * v[mu] + f * ll[mu] * lv for mu in range(4)]

    return e, [gdot(e[aa]) for aa in range(4)]


def norm_to_tet(x, y, z, spin, minkowski=False):
    """Transformation from the normal-frame (gamma, u~^i) to the
    tetrad-frame 4-velocity: u_tet[a] = sum_mu M[a][mu] (gamma, u1, u2,
    u3) (reference: radiation_tetrad.cpp norm_to_tet block)."""
    _, gu = metric(x, y, z, spin, minkowski)
    _, ecov = tetrad(x, y, z, spin, minkowski)
    alpha = 1.0 / torch.sqrt(-gu[0][0])
    zero = 0.0 * alpha
    one = 1.0 + zero
    # norm_to_coord[mu][nu'] maps (gamma, uu1, uu2, uu3) -> u^mu
    n2c = [[1.0 / alpha, zero, zero, zero],
           [-alpha * gu[0][1], one, zero, zero],
           [-alpha * gu[0][2], zero, one, zero],
           [-alpha * gu[0][3], zero, zero, one]]
    return [[sum(_ETA_SIGN[aa] * ecov[aa][mu] * n2c[mu][nu]
                 for mu in range(4))
             for nu in range(4)] for aa in range(4)]


def tetrad_derivatives(x, y, z, spin, minkowski=False):
    """Analytic coordinate derivatives de[d][a][mu] = d_d e_(a)^mu
    (reference: radiation_tetrad.hpp:55-126)."""
    a = spin
    rad2, r, ll1, ll2, ll3, f = _ks_terms(x, y, z, a)
    qa = 2.0 * r * r - rad2 + a * a
    qb = r * r + a * a
    qc = 3.0 * a * a * z * z - r ** 4
    df = [f * f * x / (2.0 * r ** 3) * qc / qa,
          f * f * y / (2.0 * r ** 3) * qc / qa,
          f * f * z / (2.0 * r ** 5) * (qc * qb / qa - 2.0 * (a * r) ** 2)]
    if minkowski:
        f = 0.0 * f
        df = [0.0 * d for d in df]
    qx = a * a * x - 2.0 * a * r * y - r * r * x
    qy = a * a * y + 2.0 * a * r * x - r * r * y
    dl1 = [x * r * qx / (qb * qb * qa) + r / qb,
           y * r * qx / (qb * qb * qa) + a / qb,
           z / r * qx / (qb * qa)]
    dl2 = [x * r * qy / (qb * qb * qa) - a / qb,
           y * r * qy / (qb * qb * qa) + r / qb,
           z / r * qy / (qb * qa)]
    dl3 = [-x * z / (r * qa),
           -y * z / (r * qa),
           -z * z / (r ** 3) * qb / qa + 1.0 / r]

    wa = torch.sqrt(1.0 + f)
    wb = torch.sqrt(1.0 + f * (ll1 * ll1 + ll2 * ll2))
    wc = torch.sqrt(1.0 + f * ll2 * ll2)
    iwa, iwb, iwc = 1.0 / wa, 1.0 / wb, 1.0 / wc
    iwasq, iwbsq, iwcsq = iwa * iwa, iwb * iwb, iwc * iwc
    dwa = [0.5 * iwa * df[d] for d in range(3)]
    dwb = [0.5 * iwb * (2.0 * f * ll1 * dl1[d] + 2.0 * f * ll2 * dl2[d]
                        + (ll1 * ll1 + ll2 * ll2) * df[d])
           for d in range(3)]
    dwc = [0.5 * iwc * (2.0 * f * ll2 * dl2[d] + ll2 * ll2 * df[d])
           for d in range(3)]

    zero = 0.0 * wa
    de = [[[zero for _ in range(4)] for _ in range(4)] for _ in range(3)]
    dls = [dl1, dl2, dl3]
    lls = [ll1, ll2, ll3]
    for d in range(3):
        de[d][0][0] = dwa[d]
        for c in range(3):
            de[d][0][c + 1] = (-f * iwa * dls[c][d]
                               - iwa * lls[c] * df[d]
                               + f * iwasq * lls[c] * dwa[d])
        de[d][1][1] = iwb * dwc[d] - iwbsq * wc * dwb[d]
        de[d][1][2] = (-f * iwb * iwc * ll1 * dl2[d]
                       - f * iwb * iwc * ll2 * dl1[d]
                       + (-iwb * iwc * df[d] + f * iwbsq * iwc * dwb[d]
                          + f * iwb * iwcsq * dwc[d]) * ll1 * ll2)
        de[d][2][2] = -iwcsq * dwc[d]
        de[d][3][1] = (-f * iwa * iwb * ll1 * dl3[d]
                       - f * iwa * iwb * ll3 * dl1[d]
                       + (-iwa * iwb * df[d] + f * iwasq * iwb * dwa[d]
                          + f * iwa * iwbsq * dwb[d]) * ll1 * ll3)
        de[d][3][2] = (-f * iwa * iwb * ll2 * dl3[d]
                       - f * iwa * iwb * ll3 * dl2[d]
                       + (-iwa * iwb * df[d] + f * iwasq * iwb * dwa[d]
                          + f * iwa * iwbsq * dwb[d]) * ll2 * ll3)
        de[d][3][3] = iwa * dwb[d] - iwasq * wb * dwa[d]
    return de


def rotation_coefficients(e, ecov, gu, dg, de):
    """omega[i][j][k] = ei[i]_l e[k]^m (d_m e[j]^l + Gamma^l_mn e[j]^n)
    from the tetrad, its covariant form, the inverse metric and the
    four-index derivatives dg[m][l][n] = d_m g_ln, de[m][a][l] = d_m
    e_(a)^l (index 0, the time derivative, zero); ei[a][mu] = eta^ab
    e_(b)_mu (reference: ComputeTetrad tail, radiation_tetrad.hpp:127-175,
    and rad_snake.cpp:352-367)."""
    ei = [[_ETA_SIGN[aa] * ecov[aa][mu] for mu in range(4)]
          for aa in range(4)]
    gamma = [[[sum(0.5 * gu[ii][ll] * (dg[jj][ll][kk] + dg[kk][ll][jj]
                                       - dg[ll][jj][kk])
                   for ll in range(4))
               for kk in range(4)] for jj in range(4)]
             for ii in range(4)]
    omega = [[[None] * 4 for _ in range(4)] for _ in range(4)]
    for ii in range(4):
        for jj in range(4):
            for kk in range(4):
                v = 0.0 * ei[0][0]
                for ll in range(4):
                    for mm in range(4):
                        v = v + ei[ii][ll] * e[kk][mm] * de[mm][jj][ll]
                        for nn in range(4):
                            v = v + (ei[ii][ll] * e[kk][mm]
                                     * gamma[ll][mm][nn] * e[jj][nn])
                omega[ii][jj][kk] = v
    return omega


def ricci_rotation(x, y, z, spin, minkowski=False):
    """Ricci rotation coefficients omega[i][j][k] (reference:
    ComputeTetrad tail, radiation_tetrad.hpp:127-175)."""
    _, gu = metric(x, y, z, spin, minkowski)
    dgs = metric_derivatives(x, y, z, spin, minkowski)
    e, ecov = tetrad(x, y, z, spin, minkowski)
    de = tetrad_derivatives(x, y, z, spin, minkowski)
    zero = 0.0 * (x + y + z)
    dg = [[[zero] * 4 for _ in range(4)]] + [
        [[dgs[d][mu][nu] for nu in range(4)] for mu in range(4)]
        for d in range(3)]
    de4 = [[[zero] * 4 for _ in range(4)]] + de
    return rotation_coefficients(e, ecov, gu, dg, de4)
