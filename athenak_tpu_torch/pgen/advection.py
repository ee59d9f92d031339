"""Advection of a density profile at a constant velocity.

Counterpart of ``athenak_tpu/pgen/advection.py`` (reference:
src/pgen/tests/advection.cpp): a sine (``problem/iproblem`` 1) or square
profile of amplitude ``problem/amp`` carried at ``problem/velocity``
along ``problem/flow_dir``; with kinematic evolution and the advect
solver it exercises the advection path.  The interior primitives are
made in host numpy (ghosts zero) and moved to the device.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVX, IVY, IVZ

from . import state_from_prims


def init(pin, mesh, phys):
    flow_dir = pin.get_or_add_integer("problem", "flow_dir", 1)
    iprob = pin.get_or_add_integer("problem", "iproblem", 1)
    vel = pin.get_or_add_real("problem", "velocity", 1.0)
    amp = pin.get_or_add_real("problem", "amp", 0.1)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    a = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
         slice(mbi.is_, mbi.ie + 1))
    ms = mesh.mesh_size
    length = (ms.x1max - ms.x1min, ms.x2max - ms.x2min,
              ms.x3max - ms.x3min)[flow_dir - 1]
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[a[0]], x2v[a[1]], x1v[a[2]],
                                 indexing="ij")
        x = (X1, X2, X3)[flow_dir - 1]
        if iprob == 1:      # sine profile
            prof = 1.0 + amp * np.sin(2.0 * math.pi * x / length)
        else:               # square profile
            prof = np.where(np.abs(x) < 0.25 * length, 1.0 + amp, 1.0)
        w[gid, IDN][a] = prof
        w[gid, (IVX, IVY, IVZ)[flow_dir - 1]][a] = vel
        if phys.eos.is_ideal:
            w[gid, IEN][a] = 1.0 / (phys.eos.gamma - 1.0)
    return state_from_prims(phys, w)
