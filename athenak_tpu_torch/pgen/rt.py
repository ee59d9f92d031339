"""Rayleigh-Taylor instability (hydro or MHD; needs constant gravity).

Counterpart of ``athenak_tpu/pgen/rt.py`` (reference:
src/pgen/fluids/rt.cpp): a heavy fluid (density ``problem/drat``) over a
light one in hydrostatic balance under the constant acceleration of
``<hydro_srcterms>/const_accel_val`` along x2, with a single-mode
velocity seed of amplitude ``problem/amp`` at the interface y = 0.  The
primitives cover the whole array, ghosts included.  Under MHD a uniform
x1 field ``problem/b0``, parallel to the interface, lies on every x1
face; the JAX generator builds no MHD state (it calls the one-argument
hydro p2c), so this branch follows the reference.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVY

from . import state_from_prims


def init(pin, mesh, phys):
    amp = pin.get_or_add_real("problem", "amp", 0.01)
    drat = pin.get_or_add_real("problem", "drat", 2.0)
    grav = pin.get_real("hydro_srcterms", "const_accel_val")
    gm1 = phys.eos.gamma - 1.0
    ms = mesh.mesh_size

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    lx = ms.x1max - ms.x1min
    for gid in range(nmb):
        x1v, x2v, _ = mesh.cell_centers(gid)
        X = x1v[None, None, :]
        Y = x2v[None, :, None]
        den = np.where(Y > 0.0, drat, 1.0) + 0.0 * X
        pres = 2.5 + grav * np.where(Y > 0.0, drat * Y, Y) + 0.0 * X
        w[gid, IDN] = den
        w[gid, IEN] = pres / gm1
        w[gid, IVY] = (amp * (1.0 + np.cos(2.0 * math.pi * X / lx)) / 2.0
                       * (1.0 + np.cos(1.5 * math.pi * Y)) / 2.0)

    if not getattr(phys, "is_mhd", False):
        return state_from_prims(phys, w)
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    bfc["x1f"][:] = pin.get_or_add_real("problem", "b0", 0.0)
    return state_from_prims(phys, w, bfc)
