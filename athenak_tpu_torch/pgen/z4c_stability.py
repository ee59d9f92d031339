"""AWA robust-stability test: flat space + O(1e-10/rho^2) random noise.

Counterpart of ``athenak_tpu/pgen/z4c_stability.py`` (reference:
src/pgen/z4c/z4c_stability.cpp): Minkowski ADM data with
uniform random perturbations of amplitude 1e-10/rho^2 (rho = grid
refinement factor) on g_dd and K_dd; a stable formulation+gauge keeps
the noise bounded over many crossing times.  The noise comes from numpy's
``default_rng(seed)`` on the host, the JAX package's generator, so both
packages start from the same bits.
"""

from __future__ import annotations

import numpy as np

from ..z4c.adm_ic import adm_to_z4c
from . import to_device


def init(pin, mesh, phys):
    rho = pin.get_or_add_real("problem", "rho", 1.0)
    amp = 1e-10 / (rho * rho)
    seed = pin.get_or_add_integer("problem", "seed", 17)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    shp = (nmb, 6, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    rng = np.random.default_rng(seed)
    g_dd = np.zeros(shp)
    for s, diag in enumerate((True, False, False, True, False, True)):
        g_dd[:, s] = (1.0 if diag else 0.0)
    g_dd += amp * 2.0 * (rng.random(shp) - 0.5)
    K_dd = amp * 2.0 * (rng.random(shp) - 0.5)
    alpha = np.ones(shp[:1] + shp[2:])

    u = adm_to_z4c(mesh, g_dd, K_dd, alpha=alpha)
    return phys.make_state(to_device(phys, u))
