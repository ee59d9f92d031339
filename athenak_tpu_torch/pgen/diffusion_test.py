"""Diffusion decay tests: a sinusoidal shear, field or entropy
perturbation of a uniform medium.

Counterpart of ``athenak_tpu/pgen/diffusion_test.py`` (reference:
tst/test_suite/diffusion/, the viscous, resistive and conductive decay
of sinusoidal perturbations):

    perturb = vy | by | temp | bz_pb   (problem/perturb)
    amp                                the perturbation amplitude
    kx_mult                            wavenumber multiple of 2 pi / Lx

The linear decay rates are nu k^2 (shear), eta k^2 (field) and
alpha (gamma - 1) / gamma k^2 (the entropy mode at constant pressure).
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVY
from . import state_from_prims


def init(pin, mesh, phys):
    amp = pin.get_or_add_real("problem", "amp", 1.0e-6)
    kxm = pin.get_or_add_integer("problem", "kx_mult", 1)
    perturb = pin.get_string("problem", "perturb")
    d0 = pin.get_or_add_real("problem", "d0", 1.0)
    p0 = pin.get_or_add_real("problem", "p0", 1.0)
    gm1 = phys.eos.gamma - 1.0
    ms = mesh.mesh_size
    kx = 2.0 * math.pi * kxm / (ms.x1max - ms.x1min)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    w[:, IDN] = d0
    w[:, IEN] = p0 / gm1
    b0 = pin.get_or_add_real("problem", "b0", 0.0)
    for gid in range(nmb):
        x1v, _, _ = mesh.cell_centers(gid)
        sinx = np.sin(kx * x1v)[None, None, :]
        if perturb == "vy":
            w[gid, IVY] += amp * sinx
        elif perturb == "temp":
            # the isobaric entropy mode: dT/T = amp sin, drho/rho = -dT/T
            w[gid, IDN] = d0 / (1.0 + amp * sinx)
        elif perturb == "by":
            pass                    # the face field below
        elif perturb == "bz_pb":
            # Bz perturbed with the gas pressure balancing it: a
            # stationary mode that decays by diffusion alone
            w[gid, IEN] = (p0 - b0 * amp * sinx) / gm1
        else:
            raise ValueError(f"problem/perturb={perturb} unknown")

    if not getattr(phys, "is_mhd", False):
        return state_from_prims(phys, w)
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    if perturb == "bz_pb":
        for gid in range(nmb):
            x1v, _, _ = mesh.cell_centers(gid)
            bfc["x3f"][gid] = b0 + amp * np.sin(kx * x1v)[None, None, :]
    else:
        bfc["x1f"][:] = b0
        if perturb == "by":
            for gid in range(nmb):
                # By on the x2 faces, sampled at the x1 cell centres
                x1v, _, _ = mesh.cell_centers(gid)
                bfc["x2f"][gid] += amp * np.sin(kx * x1v)[None, None, :]
    return state_from_prims(phys, w, bfc)
