"""Orszag-Tang vortex (2-D MHD).

Counterpart of ``athenak_tpu/pgen/orszag_tang.py`` (reference:
src/pgen/tests/orszag_tang.cpp): d0 = 25/(36 pi), v = v0 (sin 2 pi y,
-sin 2 pi x), p0 = 5/(12 pi), and B from the vector potential A3 =
(B0/4pi)(cos 4 pi x - 2 cos 2 pi y) by a staggered curl with each
block's own cell sizes (level-dependent on a refined mesh).  The initial
primitives and face fields are made in host numpy and moved to the
device, where the physics module's p2c makes the conserved state.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVX, IVY

from . import state_from_prims


def init(pin, mesh, phys):
    if not getattr(phys, "is_mhd", False):
        raise ValueError("orszag_tang requires <mhd>")
    B0 = 1.0 / math.sqrt(4.0 * math.pi)
    d0 = 25.0 / (36.0 * math.pi)
    v0 = 1.0
    p0 = 5.0 / (12.0 * math.pi)
    gm1 = phys.eos.gamma - 1.0

    def A3(x1, x2):
        return (B0 / (4.0 * math.pi)) * (np.cos(4.0 * math.pi * x1)
                                         - 2.0 * np.cos(2.0 * math.pi * x2))

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))
    for gid in range(nmb):
        dx1 = mesh.mb_size["dx1"][gid]
        dx2 = mesh.mb_size["dx2"][gid]
        x1v, x2v, _ = mesh.cell_centers(gid)
        x1f, x2f, _ = mesh.face_edges(gid)
        X2, X1 = np.meshgrid(x2v[act[1]], x1v[act[2]], indexing="ij")
        w[gid, IDN][act] = d0
        w[gid, IVX][act] = v0 * np.sin(2.0 * math.pi * X2)[None]
        w[gid, IVY][act] = -v0 * np.sin(2.0 * math.pi * X1)[None]
        w[gid, IEN][act] = p0 / gm1

        # staggered curl of A3 (2-D; the x3 faces stay zero)
        A = A3(x1f.reshape(1, -1), x2f.reshape(-1, 1))  # [n2+1, n1+1]
        bfc["x1f"][gid, 0] = (A[1:, :] - A[:-1, :]) / dx2
        bfc["x2f"][gid, 0] = -(A[:, 1:] - A[:, :-1]) / dx1
    return state_from_prims(phys, w, bfc)
