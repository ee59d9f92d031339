"""Hohlraum: a vacuum box lit from its inner-x1 wall.

Counterpart of ``athenak_tpu/pgen/rad_hohlraum.py`` (reference:
src/pgen/radiation/hohlraum.cpp, inputs/radiation/hohlraum_1d): the
intensities start at zero, the inner-x1 ghosts hold I = i_beam for the
angles with n_x > 0 (a user boundary on i0 = n^0 n_0 I), and a light
front crosses the box.
"""

from __future__ import annotations

import torch

from ..comm import local_blocks
from .rad_beam import side_mask


def init(pin, mesh, phys):
    ibeam = pin.get_or_add_real("problem", "i_beam", 1.0)
    i0 = torch.zeros(phys.shape, dtype=phys.dtype, device=phys.device)
    nx_pos = torch.as_tensor(phys.grid.nh[:, 0] > 0.0,
                             device=phys.device).reshape(1, -1, 1, 1, 1)
    mask = side_mask(mesh, ("x1m",), phys.device) & nx_pos
    beam_i0 = phys.n0 * phys.n_0 * ibeam

    # the [nmb, ...] tables are read through local_blocks, so the hook
    # also runs on one rank's blocks
    def hohlraum_bc(u, bv):
        return torch.where(local_blocks(mask),
                           local_blocks(beam_i0), u, out=u)

    hohlraum_bc.shard_safe = True
    phys.bvals.user_bc_func = hohlraum_bc
    return phys.make_state(i0)
