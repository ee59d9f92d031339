"""Z4c linear gravitational wave along an arbitrary wavevector.

Counterpart of ``athenak_tpu/pgen/z4c_linear_wave.py`` (reference:
src/pgen/tests/z4c_linear_wave.cpp:70-175): a
transverse-traceless plane wave in the conformal metric and extrinsic
curvature, propagating at light speed; the final error hook compares the
evolved state against the re-initialized analytic data.
"""

from __future__ import annotations

import math

import numpy as np

from ..z4c.z4c import I_ALPHA, I_AXX, I_GXX, NZ4C, sym_idx
from . import errors as err_mod
from . import to_device


def _build_u(pin, mesh, phys, time=0.0):
    amp = pin.get_or_add_real("problem", "amp", 0.001)
    ms = mesh.mesh_size
    lx1 = ms.x1max - ms.x1min
    lx2 = ms.x2max - ms.x2min
    lx3 = ms.x3max - ms.x3min
    kx1 = pin.get_or_add_real("problem", "kx1", 1.0 / lx1)
    kx2 = pin.get_or_add_real("problem", "kx2", 1.0 / lx2)
    kx3 = pin.get_or_add_real("problem", "kx3", 1.0 / lx3)
    knorm = math.sqrt(kx1 ** 2 + kx2 ** 2 + kx3 ** 2)
    theta = math.atan2(math.sqrt(kx1 ** 2 + kx2 ** 2), kx3)
    phi = math.atan2(kx1, kx2)

    # + polarization tensor rotated to the propagation direction
    # (reference: z4c_linear_wave.cpp:107-112)
    apol = {}
    ct, st = math.cos(theta), math.sin(theta)
    cp, sp = math.cos(phi), math.sin(phi)
    apol[(0, 0)] = -ct ** 2 * math.cos(2 * phi) - cp ** 2 * st ** 2
    apol[(0, 1)] = -0.25 * (3 + math.cos(2 * theta)) * math.sin(2 * phi)
    apol[(0, 2)] = -ct * st * sp
    apol[(1, 1)] = ct ** 2 * math.cos(2 * phi) - st ** 2 * sp ** 2
    apol[(1, 2)] = ct * st * cp
    apol[(2, 2)] = st ** 2

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    u = np.zeros((nmb, NZ4C, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X1 = x1v[None, None, :]
        X2 = x2v[None, :, None]
        X3 = x3v[:, None, None]
        # traveling wave evaluated at `time` (phase speed = 1)
        phase = 2.0 * math.pi * (kx1 * X1 + kx2 * X2 + kx3 * X3
                                 - knorm * time)
        sinkx = np.sin(phase)
        coskx = knorm * math.pi * np.cos(phase)
        for (a, b), pol in apol.items():
            u[gid, I_GXX + sym_idx(a, b)] = (1.0 if a == b else 0.0) \
                + pol * amp * sinkx
            u[gid, I_AXX + sym_idx(a, b)] = pol * amp * coskx
    u[:, 0] = 1.0        # chi
    u[:, I_ALPHA] = 1.0  # lapse
    return to_device(phys, u)


def init(pin, mesh, phys):
    u = _build_u(pin, mesh, phys, time=0.0)
    return phys.make_state(u)


def final(pin, mesh, phys, state):
    """L1 errors vs the analytic traveling wave (the reference compares
    against re-initialized t=0 data after an integer number of periods;
    we evaluate the analytic solution at the final time, which is
    equivalent and also valid mid-period)."""
    u_ref = _build_u(pin, mesh, phys, time=mesh.time)
    # compare the 6 metric components (reference compares g + A: 6 vars)
    l1, linf = err_mod.compute_errors(
        mesh, state["u"][:, I_GXX:I_GXX + 6], u_ref[:, I_GXX:I_GXX + 6], 6)
    fname = err_mod.write_error_file(
        pin, mesh, l1, linf,
        ["gxx", "gxy", "gxz", "gyy", "gyz", "gzz"])
    print(f"errors written to {fname}")
