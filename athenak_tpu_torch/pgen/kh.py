"""Kelvin-Helmholtz instability (hydro or MHD).

Counterpart of ``athenak_tpu/pgen/kh.py`` (reference:
src/pgen/fluids/kh.cpp): ``problem/ichoice`` 1 is the smooth double
shear layer of Lecoanet et al. (2016); any other choice the classic
discontinuous layer with a sinusoidal seed.  The primitives cover the
whole array, ghosts included; under MHD a uniform x1 field
``problem/b0`` lies on every x1 face.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVX, IVY

from . import state_from_prims


def init(pin, mesh, phys):
    ich = pin.get_or_add_integer("problem", "ichoice", 1)
    amp = pin.get_or_add_real("problem", "amp", 0.01)
    sigma = pin.get_or_add_real("problem", "sigma", 0.2)
    vshear = pin.get_or_add_real("problem", "vshear", 1.0)
    drat = pin.get_or_add_real("problem", "drat", 1.0)
    gm1 = phys.eos.gamma - 1.0

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    for gid in range(nmb):
        x1v, x2v, _ = mesh.cell_centers(gid)
        X = x1v[None, None, :]
        Y = x2v[None, :, None]
        if ich == 1:
            # Lecoanet: smooth tanh layers at y = +/- 0.5
            prof = (np.tanh((Y + 0.5) / sigma)
                    - np.tanh((Y - 0.5) / sigma))
            w[gid, IDN] = 1.0 + 0.5 * (drat - 1.0) * prof
            w[gid, IVX] = vshear * (prof - 1.0)
            w[gid, IVY] = (amp * np.sin(2.0 * math.pi * X)
                           * (np.exp(-((Y + 0.5) / sigma) ** 2)
                              + np.exp(-((Y - 0.5) / sigma) ** 2)))
            w[gid, IEN] = 10.0 / gm1
        else:
            inner = np.abs(Y) < 0.25
            w[gid, IDN] = np.where(inner, drat, 1.0)
            w[gid, IVX] = np.where(inner, vshear, -vshear)
            w[gid, IVY] = amp * np.sin(2.0 * math.pi * X)
            w[gid, IEN] = 2.5 / gm1

    if not getattr(phys, "is_mhd", False):
        return state_from_prims(phys, w)
    b0 = pin.get_or_add_real("problem", "b0", 0.0)
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    bfc["x1f"][:] = b0
    return state_from_prims(phys, w, bfc)
