"""Shu-Osher shock-entropy wave interaction (hydro).

Counterpart of ``athenak_tpu/pgen/shu_osher.py`` (reference:
src/pgen/fluids/shu_osher.cpp): a Mach-3 shock at x = -0.8 running into
a sinusoidal density field, over the whole array, ghosts included.
"""

from __future__ import annotations

import numpy as np

from ..indices import IDN, IEN, IVX

from . import state_from_prims


def init(pin, mesh, phys):
    gm1 = phys.eos.gamma - 1.0
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    for gid in range(nmb):
        x1v, _, _ = mesh.cell_centers(gid)
        X = x1v[None, None, :]
        left = X < -0.8
        w[gid, IDN] = np.where(left, 3.857143, 1.0 + 0.2 * np.sin(5.0 * X))
        w[gid, IVX] = np.where(left, 2.629369, 0.0)
        w[gid, IEN] = np.where(left, 10.33333, 1.0) / gm1
    return state_from_prims(phys, w)
