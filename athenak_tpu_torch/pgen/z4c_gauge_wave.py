"""AWA gauge-wave test: a pure-gauge sinusoid on flat space.

Counterpart of ``athenak_tpu/pgen/z4c_gauge_wave.py`` (reference:
src/pgen/z4c/z4c_gauge_wave.cpp): the Apples-with-Apples
gauge wave g_xx = 1 - H, alpha = sqrt(1 - H), K_xx = dH/dt / (2 alpha)
with H = A sin(2 pi x / L); an exact solution that should propagate
without growing constraint violations under harmonic-type gauges.
"""

from __future__ import annotations

import math

import numpy as np

from ..z4c.adm_ic import adm_to_z4c
from . import to_device


def init(pin, mesh, phys):
    amp = pin.get_or_add_real("problem", "amp", 0.001)
    ms = mesh.mesh_size
    lx = ms.x1max - ms.x1min

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    shp = (nmb, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    alpha = np.empty(shp)
    g_dd = np.zeros((nmb, 6) + shp[1:])
    K_dd = np.zeros((nmb, 6) + shp[1:])
    for gid in range(nmb):
        x1v, _, _ = mesh.cell_centers(gid)
        X1 = np.broadcast_to(x1v[None, None, :], shp[1:])
        H = amp * np.sin(2.0 * math.pi * X1 / lx)
        dH_dt = -amp * 2.0 * math.pi / lx * np.cos(2.0 * math.pi * X1 / lx)
        g_dd[gid, 0] = 1.0 - H                   # g_xx
        g_dd[gid, 3] = 1.0                       # g_yy
        g_dd[gid, 5] = 1.0                       # g_zz
        K_dd[gid, 0] = 0.5 * dH_dt / np.sqrt(1.0 - H)
        alpha[gid] = np.sqrt(1.0 - H)

    u = adm_to_z4c(mesh, g_dd, K_dd, alpha=alpha)
    return phys.make_state(to_device(phys, u))
