"""Driven turbulence: a uniform medium; the forcing supplies the energy.

Counterpart of ``athenak_tpu/pgen/turb.py`` (reference:
src/pgen/fluids/turb.cpp), MHD branch: uniform d0 and p0 over the whole
array, ghosts included, and a uniform x1 field ``problem/b0`` on every
x1 face.  All dynamics come from the ``<turb_driving>`` forcing
(``turb_driver.py``).
"""

from __future__ import annotations

import numpy as np

from ..indices import IDN, IEN

from . import state_from_prims


def init(pin, mesh, phys):
    if not getattr(phys, "is_mhd", False):
        raise NotImplementedError(
            "hydro turbulence is not ported to athenak_tpu_torch yet")
    d0 = pin.get_or_add_real("problem", "d0", 1.0)
    p0 = pin.get_or_add_real("problem", "p0", 1.0)
    b0 = pin.get_or_add_real("problem", "b0", 0.0)
    gm1 = phys.eos.gamma - 1.0

    mbi = mesh.mb_indcs
    w = np.zeros((mesh.nmb_total, phys.nvar,
                  mbi.ncells3, mbi.ncells2, mbi.ncells1))
    w[:, IDN] = d0
    w[:, IEN] = p0 / gm1
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    bfc["x1f"][:] = b0
    return state_from_prims(phys, w, bfc)
