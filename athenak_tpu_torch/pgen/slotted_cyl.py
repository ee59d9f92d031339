"""Slotted-cylinder passive-scalar advection (Zalesak's disk).

Counterpart of ``athenak_tpu/pgen/slotted_cyl.py`` (reference:
src/pgen/fluids/slotted_cyl.cpp, inputs/hydro/slotted_cyl.athinput):
rigid rotation at 2 pi omega about (omega_x1, omega_x2) of a radius-R
cylinder with a rectangular slot carried in the passive scalars; with
kinematic evolution and the advect solver it measures the quality of
scalar advection.  The conserved state of the interior is made in host
numpy and the physics module's c2p makes the primitives on the device.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IM1, IM2

from . import to_device

D0 = 1.0


def profile(x1, x2, radius, cx, cy, s_width, s_height):
    """Pointwise cylinder-with-slot indicator (SlottedCylinderProfile)."""
    zx = x1 - cx
    zy = x2 - cy
    r = np.sqrt(zx ** 2 + zy ** 2)
    in_slot = ((np.abs(2.0 * zx) < s_width)
               & (zy + radius < s_height) & (zy + radius > 0.0))
    return np.where((r <= radius) & ~in_slot, 1.0, 0.0)


def init(pin, mesh, phys):
    if phys.nscalars < 1:
        raise ValueError("slotted_cyl needs <hydro> nscalars >= 1")
    radius = pin.get_or_add_real("problem", "radius", 0.15)
    cx = pin.get_or_add_real("problem", "center_x1", 0.50)
    cy = pin.get_or_add_real("problem", "center_x2", 0.75)
    omega = pin.get_or_add_real("problem", "omega", 1.0)
    ox = pin.get_or_add_real("problem", "omega_x1", 0.50)
    oy = pin.get_or_add_real("problem", "omega_x2", 0.50)
    s_width = pin.get_or_add_real("problem", "s_width", 0.05)
    s_height = pin.get_or_add_real("problem", "s_height", 0.25)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    for gid in range(nmb):
        x1v, x2v, _ = mesh.cell_centers(gid)
        X1 = x1v[None, None, mbi.is_:mbi.ie + 1] + np.zeros(
            (1, mbi.je + 1 - mbi.js, 1))
        X2 = x2v[None, mbi.js:mbi.je + 1, None] + np.zeros(
            (1, 1, mbi.ie + 1 - mbi.is_))
        u[gid, IDN][act] = D0
        u[gid, IM1][act] = -D0 * 2.0 * math.pi * omega * (X2 - oy) * D0
        u[gid, IM2][act] = D0 * 2.0 * math.pi * omega * (X1 - ox) * D0
        sc = profile(X1, X2, radius, cx, cy, s_width, s_height)
        for n in range(phys.nscalars):
            u[gid, phys.nhydro + n][act] = sc * D0

    w, ut, _ = phys.cons_to_prim(to_device(phys, u))
    return phys.make_state(ut, w)
