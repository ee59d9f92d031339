"""Spatial reconstruction: DC, PLM, PPM4, PPMX, WENO-Z and TENO.

Counterpart of ``athenak_tpu/ops/recon.py`` (reference:
src/reconstruct/{plm,ppm,wenoz,teno}.hpp).  Face convention: along
``axis`` the returned ``(ql, qr)`` hold the left/right states at face i
(the lower face of cell i).  The stencils wrap around circularly, so the
first ``ng`` and last ``ng-1`` face slots are garbage; callers consume
faces ``is..ie+1``.
"""

from __future__ import annotations

import torch


def _sh(q, s: int, axis: int):
    """q shifted so result[i] = q[i + s] (circular; edges are garbage)."""
    return torch.roll(q, -s, dims=axis)


def dc(q, axis: int):
    """Donor cell (piecewise constant)."""
    return _sh(q, -1, axis), q


def plm(q, axis: int):
    """Piecewise linear with the van Leer (harmonic-mean) limiter."""
    dql = q - _sh(q, -1, axis)
    dqr = _sh(q, +1, axis) - q
    dq2 = dql * dqr
    # 0/0 in the branch that is not taken is discarded by where()
    dqm = torch.where(dq2 <= 0.0, torch.zeros_like(q), dq2 / (dql + dqr))
    return _sh(q + dqm, -1, axis), q - dqm


def _ppm_interfaces(q, axis: int):
    """4th-order interface interpolants a_{j,-}, a_{j,+} (CS eqn 16)."""
    qm2 = _sh(q, -2, axis)
    qm1 = _sh(q, -1, axis)
    qp1 = _sh(q, +1, axis)
    qp2 = _sh(q, +2, axis)
    qlv = (7.0 * (q + qm1) - (qm2 + qp1)) / 12.0
    qrv = (7.0 * (q + qp1) - (qm1 + qp2)) / 12.0
    return qm2, qm1, qp1, qp2, qlv, qrv


def _clip(x, lo, hi):
    """jnp.clip(x, lo, hi): min(max(x, lo), hi)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def ppm4(q, axis: int):
    """Original PPM with the Colella-Woodward limiters (reference:
    src/reconstruct/ppm.hpp PPM4)."""
    _, qm1, qp1, _, qlv, qrv = _ppm_interfaces(q, axis)
    # limit to the neighbouring cell values (CS eqn 13)
    qlv = _clip(qlv, torch.minimum(q, qm1), torch.maximum(q, qm1))
    qrv = _clip(qrv, torch.minimum(q, qp1), torch.maximum(q, qp1))
    # monotonize (CS eqns 14, 15)
    qc = qrv - q
    qd = qlv - q
    flat = (qc * qd) >= 0.0
    qrv_m = torch.where(torch.abs(qc) >= 2.0 * torch.abs(qd),
                        q - 2.0 * qd, qrv)
    qlv_m = torch.where(torch.abs(qd) >= 2.0 * torch.abs(qc),
                        q - 2.0 * qc, qlv)
    qlv = torch.where(flat, q, qlv_m)
    qrv = torch.where(flat, q, qrv_m)
    return _sh(qrv, -1, axis), qlv


def _sign(x):
    return torch.where(x < 0.0, -1.0, 1.0).to(x.dtype)


def _limit_d2(d2qc, d2ql, d2qr):
    """PH 3.36 second-derivative limiter."""
    lim_slope = torch.minimum(torch.abs(d2ql), torch.abs(d2qr))
    same_pos = (d2qc > 0.0) & (d2ql > 0.0) & (d2qr > 0.0)
    same_neg = (d2qc < 0.0) & (d2ql < 0.0) & (d2qr < 0.0)
    lim = _sign(d2qc) * torch.minimum(1.25 * lim_slope, torch.abs(d2qc))
    return torch.where(same_pos | same_neg, lim, 0.0)


def ppmx(q, axis: int):
    """PPM with the Colella-Sekora extremum-preserving limiters
    (reference: src/reconstruct/ppm.hpp PPMX)."""
    qm2, qm1, qp1, qp2, qlv, qrv = _ppm_interfaces(q, axis)

    # CS monotonicity limiters on qlv, then on qrv
    d2qc = 3.0 * ((qm1 + q) - 2.0 * qlv)
    d2ql = (qm2 + q) - 2.0 * qm1
    d2qr = (qm1 + qp1) - 2.0 * q
    d2qlim = _limit_d2(d2qc, d2ql, d2qr)
    qlv = torch.where((qm1 - qlv) * (q - qlv) > 0.0,
                      0.5 * (q + qm1) - d2qlim / 6.0, qlv)
    d2qc = 3.0 * ((q + qp1) - 2.0 * qrv)
    d2qr_r = (q + qp2) - 2.0 * qp1
    d2qlim = _limit_d2(d2qc, d2qr, d2qr_r)
    qrv = torch.where((q - qrv) * (qp1 - qrv) > 0.0,
                      0.5 * (q + qp1) - d2qlim / 6.0, qrv)

    # extremum detection + smooth-extremum limiter (CS 20, PH 3.31)
    qa = (qrv - q) * (q - qlv)
    qb = (qm1 - q) * (q - qp1)
    at_extremum = (qa <= 0.0) | (qb <= 0.0)
    d2q = 6.0 * (qlv + qrv - 2.0 * q)
    d2qc_e = (qm1 + qp1) - 2.0 * q
    d2ql_e = (qm2 + q) - 2.0 * qm1
    d2qr_e = (q + qp2) - 2.0 * qp1
    lim_slope = torch.minimum(torch.abs(d2ql_e), torch.abs(d2qr_e))
    lim_slope = torch.minimum(torch.abs(d2qc_e), lim_slope)
    same_pos = ((d2qc_e > 0.0) & (d2ql_e > 0.0) & (d2qr_e > 0.0)
                & (d2q > 0.0))
    same_neg = ((d2qc_e < 0.0) & (d2ql_e < 0.0) & (d2qr_e < 0.0)
                & (d2q < 0.0))
    d2qlim_e = torch.where(same_pos | same_neg,
                           _sign(d2q) * torch.minimum(1.25 * lim_slope,
                                                      torch.abs(d2q)), 0.0)
    sensitive = torch.abs(d2q) > 1.0e-12 * torch.maximum(
        torch.abs(qm1), torch.maximum(torch.abs(q), torch.abs(qp1)))
    # 0/0 in the branch not taken is discarded by where()
    rho = torch.where(sensitive,
                      d2qlim_e / torch.where(d2q == 0.0, 1.0, d2q), 0.0)
    qlv_ext = q + (qlv - q) * rho
    qrv_ext = q + (qrv - q) * rho

    # away from extrema: CW monotonization (CW 1.10, PH 3.32)
    qc = qrv - q
    qd = qlv - q
    qrv_mono = torch.where(torch.abs(qc) >= 2.0 * torch.abs(qd),
                           q - 2.0 * qd, qrv)
    qlv_mono = torch.where(torch.abs(qd) >= 2.0 * torch.abs(qc),
                           q - 2.0 * qc, qlv)
    qlv = torch.where(at_extremum, qlv_ext, qlv_mono)
    qrv = torch.where(at_extremum, qrv_ext, qrv_mono)
    return _sh(qrv, -1, axis), qlv


def _smoothness(qm2, qm1, q, qp1, qp2):
    """The three WENO smoothness indicators beta0..beta2."""
    b0c, b1c = 13.0 / 12.0, 0.25
    beta0 = (b0c * (qm2 + q - 2.0 * qm1) ** 2
             + b1c * (qm2 + 3.0 * q - 4.0 * qm1) ** 2)
    beta1 = b0c * (qm1 + qp1 - 2.0 * q) ** 2 + b1c * (qm1 - qp1) ** 2
    beta2 = (b0c * (qp2 + q - 2.0 * qp1) ** 2
             + b1c * (qp2 + 3.0 * q - 4.0 * qp1) ** 2)
    return beta0, beta1, beta2


def wenoz(q, axis: int):
    """5th-order WENO-Z (reference: src/reconstruct/wenoz.hpp)."""
    qm2 = _sh(q, -2, axis)
    qm1 = _sh(q, -1, axis)
    qp1 = _sh(q, +1, axis)
    qp2 = _sh(q, +2, axis)
    beta0, beta1, beta2 = _smoothness(qm2, qm1, q, qp1, qp2)
    eps = 1.0e-42
    tau5 = torch.abs(beta0 - beta2)
    ind0 = (tau5 / (beta0 + eps)) ** 2
    ind1 = (tau5 / (beta1 + eps)) ** 2
    ind2 = (tau5 / (beta2 + eps)) ** 2
    # left state at face i+1 (cell i's right edge), then the right state
    # at face i (cell i's left edge) from the mirrored stencil
    f0 = 2.0 * qm2 - 7.0 * qm1 + 11.0 * q
    f1 = -qm1 + 5.0 * q + 2.0 * qp1
    f2 = 2.0 * q + 5.0 * qp1 - qp2
    a0 = 0.1 * (1.0 + ind0)
    a1 = 0.6 * (1.0 + ind1)
    a2 = 0.3 * (1.0 + ind2)
    ql_cell = (f0 * a0 + f1 * a1 + f2 * a2) / (6.0 * (a0 + a1 + a2))
    g0 = 2.0 * qp2 - 7.0 * qp1 + 11.0 * q
    g1 = -qp1 + 5.0 * q + 2.0 * qm1
    g2 = 2.0 * q + 5.0 * qm1 - qm2
    c0 = 0.1 * (1.0 + ind2)
    c2 = 0.3 * (1.0 + ind0)
    qr_cell = (g0 * c0 + g1 * a1 + g2 * c2) / (6.0 * (c0 + a1 + c2))
    return _sh(ql_cell, -1, axis), qr_cell


def teno(q, axis: int):
    """5th-order TENO (Fu et al. 2016/2019; reference:
    src/reconstruct/teno.hpp): the WENO-Z smoothness indicators with a
    hard cut-off, each candidate stencil fully on or fully off."""
    qm2 = _sh(q, -2, axis)
    qm1 = _sh(q, -1, axis)
    qp1 = _sh(q, +1, axis)
    qp2 = _sh(q, +2, axis)
    beta0, beta1, beta2 = _smoothness(qm2, qm1, q, qp1, qp2)
    eps_t, c_t = 1.0e-40, 1.0e-6
    al0 = 1.0 / (beta0 + eps_t) ** 6
    al1 = 1.0 / (beta1 + eps_t) ** 6
    al2 = 1.0 / (beta2 + eps_t) ** 6
    asum = al0 + al1 + al2
    one, zero = torch.ones_like(q), torch.zeros_like(q)
    ind0 = torch.where(al0 < c_t * asum, zero, one)
    ind1 = torch.where(al1 < c_t * asum, zero, one)
    ind2 = torch.where(al2 < c_t * asum, zero, one)
    f0 = 2.0 * qm2 - 7.0 * qm1 + 11.0 * q
    f1 = -qm1 + 5.0 * q + 2.0 * qp1
    f2 = 2.0 * q + 5.0 * qp1 - qp2
    a0 = 0.1 * ind0
    a1 = 0.6 * ind1
    a2 = 0.3 * ind2
    ql_cell = (f0 * a0 + f1 * a1 + f2 * a2) / (6.0 * (a0 + a1 + a2))
    g0 = 2.0 * qp2 - 7.0 * qp1 + 11.0 * q
    g1 = -qp1 + 5.0 * q + 2.0 * qm1
    g2 = 2.0 * q + 5.0 * qm1 - qm2
    c0 = 0.1 * ind2
    c2 = 0.3 * ind0
    qr_cell = (g0 * c0 + g1 * a1 + g2 * c2) / (6.0 * (c0 + a1 + c2))
    return _sh(ql_cell, -1, axis), qr_cell


RECON_FNS = {"dc": dc, "plm": plm, "ppm4": ppm4, "ppmx": ppmx,
             "wenoz": wenoz, "teno": teno}

# methods whose face states are floored on the density and energy
# channels (reference: src/reconstruct/recon.hpp:78-110)
FLOORED_METHODS = ("ppmx", "wenoz", "teno")


def reconstruct(method: str, q, axis: int):
    return RECON_FNS[method](q, axis)
