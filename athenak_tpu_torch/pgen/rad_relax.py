"""Radiation-matter thermal relaxation.

Counterpart of ``athenak_tpu/pgen/rad_relax.py`` (reference:
src/pgen/radiation/rad_relax.cpp, inputs/radiation/relax.athinput): a
uniform gas at temperature T0 with an isotropic radiation field erad;
absorption drives both to the common equilibrium a T^4 + rho T/(gamma-1)
= erad + rho T0/(gamma-1).  With v1 != 0 the intensity is isotropic in
the fluid frame and boosted into the tetrad frame by the invariant
(n^0_fluid)^-4 (rad_relax.cpp:80-112).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..indices import IDN, IEN, IVX
from . import to_device


def init(pin, mesh, phys):
    erad = pin.get_real("problem", "erad")
    temp = pin.get_real("problem", "temp")
    v1 = pin.get_or_add_real("problem", "v1", 0.0)
    lf = 1.0 / math.sqrt(1.0 - v1 * v1)
    rad = phys.rad

    w = np.zeros(phys.shape)
    w[:, IDN] = 1.0
    w[:, IVX] = lf * v1
    # the primitive IEN slot holds the internal energy rho T / (gamma-1)
    w[:, IEN] = temp / (phys.eos.gamma - 1.0)

    # the isotropic fluid-frame intensity boosted per angle: u_tet = (lf,
    # lf v1, 0, 0) in flat space
    n0_f = lf * 1.0 - lf * v1 * rad.grid.nh[:, 0]
    ii_f = erad / (4.0 * math.pi)
    f64 = torch.float64
    n0_f = torch.as_tensor(n0_f, dtype=f64,
                           device=phys.device).reshape(1, -1, 1, 1, 1)
    i0 = (rad.n0.to(f64) * rad.n_0.to(f64) * ii_f / n0_f ** 4
          * torch.ones(rad.shape, dtype=f64, device=phys.device))
    wt = to_device(phys, w)
    return phys.make_state(phys.prim_to_cons(wt), wt, i0.to(phys.dtype))
