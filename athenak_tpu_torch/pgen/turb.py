"""Driven turbulence: a uniform medium; the forcing supplies the energy.

Counterpart of ``athenak_tpu/pgen/turb.py`` (reference:
src/pgen/fluids/turb.cpp): uniform d0 and (ideal gas) p0 over the whole
array, ghosts included, and under MHD a uniform x1 field ``problem/b0``
on every x1 face.  All dynamics come from the ``<turb_driving>`` forcing
(``turb_driver.py``).
"""

from __future__ import annotations

import numpy as np

from ..indices import IDN, IEN

from . import state_from_prims


def init(pin, mesh, phys):
    d0 = pin.get_or_add_real("problem", "d0", 1.0)
    p0 = pin.get_or_add_real("problem", "p0", 1.0)
    gm1 = phys.eos.gamma - 1.0

    mbi = mesh.mb_indcs
    w = np.zeros((mesh.nmb_total, phys.nvar,
                  mbi.ncells3, mbi.ncells2, mbi.ncells1))
    w[:, IDN] = d0
    if phys.eos.is_ideal:
        w[:, IEN] = p0 / gm1
    if not getattr(phys, "is_mhd", False):
        return state_from_prims(phys, w)
    b0 = pin.get_or_add_real("problem", "b0", 0.0)
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    bfc["x1f"][:] = b0
    return state_from_prims(phys, w, bfc)
