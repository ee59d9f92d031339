"""High-order finite-difference operators for the Z4c solver.

Counterpart of ``athenak_tpu/z4c/fd.py`` (reference:
src/utils/finite_diff.hpp): the same stencil tables for nghost 2-5
(2nd/4th/6th/8th-order centred first and second derivatives, the
one-sided-biased advective stencils and 2*ng-order Kreiss-Oliger
dissipation), applied as whole-array ``torch.roll`` stencils on
[..., n3, n2, n1] channel tensors with the same shift sign and the same
order of terms, so the sums round as the JAX package's do.  The CUDA
stage kernel keeps a copy of these tables (``csrc/z4c_rhs.cuh``);
``tests/test_torch_z4c_ops.py`` holds the two equal.

Direction convention: dir 0/1/2 = x1/x2/x3 -> tensor axes -1/-2/-3.
"""

from __future__ import annotations

import torch

_AXIS = {0: -1, 1: -2, 2: -3}

# centred first derivative: {ng: [(offset, coeff), ...]}
_D1 = {
    2: [(-1, -1.0 / 2.0), (1, 1.0 / 2.0)],
    3: [(-2, 1.0 / 12.0), (-1, -2.0 / 3.0), (1, 2.0 / 3.0),
        (2, -1.0 / 12.0)],
    4: [(-3, -1.0 / 60.0), (-2, 3.0 / 20.0), (-1, -3.0 / 4.0),
        (1, 3.0 / 4.0), (2, -3.0 / 20.0), (3, 1.0 / 60.0)],
    5: [(-4, 1.0 / 280.0), (-3, -4.0 / 105.0), (-2, 1.0 / 5.0),
        (-1, -4.0 / 5.0), (1, 4.0 / 5.0), (2, -1.0 / 5.0),
        (3, 4.0 / 105.0), (4, -1.0 / 280.0)],
}

# centred second derivative (same axis)
_D2 = {
    2: [(-1, 1.0), (0, -2.0), (1, 1.0)],
    3: [(-2, -1.0 / 12.0), (-1, 4.0 / 3.0), (0, -5.0 / 2.0),
        (1, 4.0 / 3.0), (2, -1.0 / 12.0)],
    4: [(-3, 1.0 / 90.0), (-2, -3.0 / 20.0), (-1, 3.0 / 2.0),
        (0, -49.0 / 18.0), (1, 3.0 / 2.0), (2, -3.0 / 20.0),
        (3, 1.0 / 90.0)],
    5: [(-4, -1.0 / 560.0), (-3, 8.0 / 315.0), (-2, -1.0 / 5.0),
        (-1, 8.0 / 5.0), (0, -205.0 / 72.0), (1, 8.0 / 5.0),
        (2, -1.0 / 5.0), (3, 8.0 / 315.0), (4, -1.0 / 560.0)],
}

# one-sided-biased advective stencils (dl for beta<0, dr for beta>0)
_ADV_L = {
    2: [(-2, 0.5), (-1, -2.0), (0, 1.5)],
    3: [(-3, -1.0 / 12.0), (-2, 6.0 / 12.0), (-1, -18.0 / 12.0),
        (0, 10.0 / 12.0), (1, 3.0 / 12.0)],
    4: [(-4, 1.0 / 60.0), (-3, -2.0 / 15.0), (-2, 1.0 / 2.0),
        (-1, -4.0 / 3.0), (0, 7.0 / 12.0), (1, 2.0 / 5.0),
        (2, -1.0 / 30.0)],
    5: [(-5, -1.0 / 280.0), (-4, 1.0 / 28.0), (-3, -1.0 / 6.0),
        (-2, 1.0 / 2.0), (-1, -5.0 / 4.0), (0, 9.0 / 20.0),
        (1, 1.0 / 2.0), (2, -1.0 / 14.0), (3, 1.0 / 168.0)],
}
_ADV_R = {ng: [(-o, -c) for o, c in sten] for ng, sten in _ADV_L.items()}

# Kreiss-Oliger dissipation (undivided 2*ng-th difference, x idx)
_DISS = {
    2: [(-2, 1.0), (-1, -4.0), (0, 6.0), (1, -4.0), (2, 1.0)],
    3: [(-3, 1.0), (-2, -6.0), (-1, 15.0), (0, -20.0), (1, 15.0),
        (2, -6.0), (3, 1.0)],
    4: [(-4, 1.0), (-3, -8.0), (-2, 28.0), (-1, -56.0), (0, 70.0),
        (1, -56.0), (2, 28.0), (3, -8.0), (4, 1.0)],
    5: [(-5, 1.0), (-4, -10.0), (-3, 45.0), (-2, -120.0), (-1, 210.0),
        (0, -252.0), (1, 210.0), (2, -120.0), (3, 45.0), (4, -10.0),
        (5, 1.0)],
}


def _apply(f, sten, axis):
    out = None
    for off, c in sten:
        t = c * (f if off == 0 else torch.roll(f, -off, dims=axis))
        out = t if out is None else out + t
    return out


def d1(f, d: int, idx, ng: int):
    """First derivative along direction d (0=x1, 1=x2, 2=x3)."""
    return _apply(f, _D1[ng], _AXIS[d]) * idx[d]


def d2(f, d: int, idx, ng: int):
    return _apply(f, _D2[ng], _AXIS[d]) * (idx[d] * idx[d])


def d1d1(f, da: int, db: int, idx, ng: int):
    """Mixed second derivative (da != db): the first derivative along da,
    then along db (the reference Dxy stencil is the tensor product of two
    D1s)."""
    return d1(d1(f, da, idx, ng), db, idx, ng)


def adv(beta, f, d: int, idx, ng: int):
    """Upwinded advective term beta * d_f along direction d
    (reference: Lx, finite_diff.hpp:1204+)."""
    dl = _apply(f, _ADV_L[ng], _AXIS[d]) * idx[d]
    dr = _apply(f, _ADV_R[ng], _AXIS[d]) * idx[d]
    return torch.where(beta < 0.0, beta * dl, beta * dr)


def ko_diss(f, d: int, idx, ng: int):
    """Undivided 2*ng-th difference times 1/dx (the caller applies the
    sigma * 2^-2ng * sign factor, reference: z4c.cpp:158)."""
    return _apply(f, _DISS[ng], _AXIS[d]) * idx[d]
