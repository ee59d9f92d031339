"""Liska & Wendroff square implosion (SIAM J. Sci. Comput. 25, 995, 2003).

Counterpart of ``athenak_tpu/pgen/lw_implode.py`` (reference:
src/pgen/tests/lw_implode.cpp): a diagonal discontinuity whose y0 lies
half-way between a cell centre and a face, so that the initial state is
exactly symmetric about x = y; reflecting walls.  The conserved state of
the interior is made in host numpy (ghosts zero) and the physics
module's c2p makes the primitives on the device.  Hydro only.
"""

from __future__ import annotations

import numpy as np

from ..indices import IDN, IEN

from . import to_device


def init(pin, mesh, phys):
    if getattr(phys, "is_mhd", False):
        raise ValueError("lw_implode is a hydro-only test")
    d_in = pin.get_real("problem", "d_in")
    p_in = pin.get_real("problem", "p_in")
    d_out = pin.get_real("problem", "d_out")
    p_out = pin.get_real("problem", "p_out")

    eos = phys.eos
    gm1 = eos.gamma - 1.0
    ms = mesh.mesh_size
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        dx2 = float(mesh.mb_size["dx2"][gid])
        # y0 between a cell centre and a face (lw_implode.cpp:60)
        y0 = 0.5 * (ms.x2max + ms.x2min) + 0.25 * dx2
        _, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                indexing="ij")
        outside = X2 > (y0 - X1)
        u[gid, IDN][act] = np.where(outside, d_out, d_in)
        if eos.is_ideal:
            u[gid, IEN][act] = np.where(outside, p_out, p_in) / gm1
        if phys.nscalars > 0:
            u[gid, phys.nhydro][act] = np.where(outside, 0.0, d_in)

    w, ut, _ = phys.cons_to_prim(to_device(phys, u))
    return phys.make_state(ut, w)
