"""Single puncture (isotropic Schwarzschild) initial data for Z4c.

Counterpart of ``athenak_tpu/pgen/z4c_one_puncture.py`` (reference:
src/pgen/z4c/z4c_one_puncture.cpp): Brill-Lindquist conformal factor
psi = 1 + m/(2r), conformally flat metric, zero extrinsic curvature,
precollapsed lapse alpha = psi^-2 (reference: GaugePreCollapsedLapse,
z4c_gauge.cpp).  Made in float64 on the host and moved to the device at
the run's dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..z4c.z4c import I_ALPHA, I_CHI, I_GXX, I_GYY, I_GZZ, NZ4C


def init(pin, mesh, phys):
    m =pin.get_or_add_real("problem", "punc_ADM_mass", 1.0)
    c1 = pin.get_or_add_real("problem", "punc_center_x1", 0.0)
    c2 = pin.get_or_add_real("problem", "punc_center_x2", 0.0)
    c3 = pin.get_or_add_real("problem", "punc_center_x3", 0.0)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    u = np.zeros((nmb, NZ4C, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X1 = x1v[None, None, :] - c1
        X2 = x2v[None, :, None] - c2
        X3 = x3v[:, None, None] - c3
        r = np.sqrt(X1 ** 2 + X2 ** 2 + X3 ** 2)
        r = np.maximum(r, 1e-12)
        psi = 1.0 + m / (2.0 * r)
        # chi = psi^chi_psi_power (default -4)
        u[gid, I_CHI] = psi ** phys.opt.chi_psi_power
        u[gid, I_GXX] = 1.0
        u[gid, I_GYY] = 1.0
        u[gid, I_GZZ] = 1.0
        # precollapsed lapse alpha = psi^-2
        u[gid, I_ALPHA] = psi ** (-2.0)

    return phys.make_state(torch.as_tensor(u, dtype=phys.dtype,
                                           device=phys.device))
