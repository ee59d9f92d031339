"""Shock-cloud interaction: a Mach-M shock hits an overdense sphere.

Counterpart of ``athenak_tpu/pgen/shock_cloud.py`` (reference:
src/pgen/fluids/shock_cloud.cpp): the Rankine-Hugoniot post-shock state
at x < -2, the ambient state beyond, a cloud drat times denser within
r < 1 of the origin, and the post-shock state held on the inner-x1
boundary (``inflow``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..indices import IDN, IEN, IM1
from . import to_device


def init(pin, mesh, phys):
    if getattr(phys, "is_mhd", False):
        raise ValueError("shock_cloud is the hydro problem")
    eos = phys.eos
    if not eos.is_ideal:
        raise ValueError("shock_cloud requires the ideal-gas EOS")
    mach = pin.get_real("problem", "Mach")
    drat = pin.get_real("problem", "drat")
    xshock, rad = -2.0, 1.0
    gm = eos.gamma
    gm1 = gm - 1.0
    dr, pr, ur = 1.0, 1.0 / gm, 0.0
    # the Rankine-Hugoniot jumps (shock_cloud.cpp:49-55)
    jump1 = (gm + 1.0) / (gm1 + 2.0 / (mach * mach))
    jump2 = (2.0 * gm * mach * mach - gm1) / (gm + 1.0)
    jump3 = 2.0 * (1.0 - 1.0 / (mach * mach)) / (gm + 1.0)
    dl = dr * jump1
    pl = pr * jump2
    ul = ur + jump3 * mach * math.sqrt(gm * pr / dr)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X1 = x1v[None, None, mbi.is_:mbi.ie + 1]
        X2 = x2v[None, mbi.js:mbi.je + 1, None] if mbi.nx2 > 1 \
            else np.zeros((1, 1, 1))
        X3 = x3v[mbi.ks:mbi.ke + 1, None, None] if mbi.nx3 > 1 \
            else np.zeros((1, 1, 1))
        post = X1 < xshock
        cloud = np.sqrt(X1 ** 2 + X2 ** 2 + X3 ** 2) < rad
        dens = np.where(post, dl, np.where(cloud, dr * drat, dr))
        u[gid, IDN][act] = dens
        u[gid, IM1][act] = np.where(post, dl * ul, 0.0) + 0.0 * dens
        u[gid, IEN][act] = np.where(post, pl / gm1 + 0.5 * dl * ul * ul,
                                    pr / gm1 + 0.0 * dens)

    # the post-shock inflow state on inner x1 (shock_cloud.cpp:58-63)
    uin = np.zeros(phys.nvar)
    uin[IDN], uin[IM1] = dl, dl * ul
    uin[IEN] = pl / gm1 + 0.5 * dl * ul * ul
    phys.bvals.inflow_state["x1m"] = torch.as_tensor(
        uin, dtype=phys.dtype, device=phys.device)
    w, ut, _ = phys.cons_to_prim(to_device(phys, u))
    return phys.make_state(ut, w)
