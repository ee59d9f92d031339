"""Spatial reconstruction: DC and PLM.

Counterpart of ``athenak_tpu/ops/recon.py`` (reference:
src/reconstruct/plm.hpp:20-37).  Face convention: along ``axis`` the
returned ``(ql, qr)`` hold the left/right states at face i (the lower face
of cell i).  The stencils wrap around circularly, so the first ``ng`` and
last ``ng-1`` face slots are garbage; callers consume faces ``is..ie+1``.
PPM and WENO are not ported yet.
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


RECON_FNS = {"dc": dc, "plm": plm}
