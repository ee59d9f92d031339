"""The radiation shadow test.

Counterpart of ``athenak_tpu/pgen/rad_shadow.py`` (reference:
src/pgen/radiation/rad_shadow.cpp, inputs/radiation/shadow.athinput): a
collimated beam (the two most +x-aligned angles of the nlevel = 2 grid)
enters at inner x1 past an optically thick elliptical cloud,
rho = 1 + 9 / (1 + exp(10 ((x/0.1)^2 + (y/0.06)^2 - 1))), and casts a
sharp shadow behind it.  The inner-x1 inflow is a user boundary: the
upstream gas in the fluid's ghosts, the beam in i0's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm import local_blocks
from ..indices import IDN, IEN, IVX, IVY, IVZ
from . import to_device
from .rad_beam import side_mask


def init(pin, mesh, phys):
    rad = phys.rad
    if rad.grid.nlevel != 2:
        raise ValueError("shadow test requires the nlevel=2 geodesic "
                         "mesh (reference: rad_shadow.cpp:60)")
    ibeam = pin.get_or_add_real("problem", "i_beam", 100.0)
    # the reference's angles 2 and 5 of its own ordering: the two most
    # +x-aligned directions, chosen by direction
    beam_angles = np.argsort(-rad.grid.nh[:, 0])[:2]

    w = np.zeros(phys.shape)
    for gid in range(mesh.nmb_total):
        x1v, x2v, _ = mesh.cell_centers(gid)
        X1 = x1v[None, None, :]
        X2 = x2v[None, :, None]
        w[gid, IDN] = 1.0 + 9.0 / (
            1.0 + np.exp(10.0 * ((X1 / 0.1) ** 2
                                 + (X2 / 0.06) ** 2 - 1.0)))
        w[gid, IEN] = 1.0 / (phys.eos.gamma - 1.0)
    w[:, IVX] = w[:, IVY] = w[:, IVZ] = 0.0
    i0 = torch.zeros(rad.shape, dtype=phys.dtype, device=phys.device)

    ghosts = side_mask(mesh, ("x1m",), phys.device)
    beam = np.zeros((1, rad.nangles, 1, 1, 1), dtype=bool)
    beam[0, beam_angles] = True
    gmask = ghosts & torch.as_tensor(beam, device=phys.device)
    beam_i0 = rad.n0 * rad.n_0 * ibeam
    uin = np.zeros(phys.nvar)
    uin[IDN] = 1.0
    uin[IEN] = 1.0 / (phys.eos.gamma - 1.0)
    uin = to_device(phys, uin.reshape(1, -1, 1, 1, 1))

    def shadow_bc(q, bv):
        # every filled array comes here: the channel count tells them
        # apart; the [nmb, ...] tables are read through local_blocks, so
        # the hook also runs on one rank's blocks
        if q.dim() == 5 and q.shape[1] == rad.nangles:
            return torch.where(local_blocks(gmask),
                               local_blocks(beam_i0), q,
                               out=q)
        if q.dim() == 5 and q.shape[1] == phys.nvar:
            return torch.where(local_blocks(ghosts), uin, q, out=q)
        return q

    shadow_bc.shard_safe = True
    phys.bvals.user_bc_func = shadow_bc
    wt = to_device(phys, w)
    return phys.make_state(phys.prim_to_cons(wt), wt, i0)
