"""Two-fluid (ion-neutral) uniform state with a velocity offset.

Counterpart of ``athenak_tpu/pgen/twofluid.py`` (reference:
src/pgen/fluids/twofluid.cpp): uniform ion and neutral states from
``problem/d_i``, ``d_n``, ``p_i``, ``p_n``, ``v*_i``, ``v*_n``, a uniform
x1 field ``b0`` on the ions, and with ``problem/amp`` a sinusoidal vx
perturbation in x1 (zero reproduces the reference's uniform state).  The
JAX package builds the state at the float width of ``jax_enable_x64``;
the port builds it at the deck's precision (``job/precision``).
"""

from __future__ import annotations

import numpy as np

from ..indices import IDN, IEN, IVX, IVY, IVZ

from . import to_device


def init(pin, mesh, phys):
    gm1 = phys.eos.gamma - 1.0
    mbi = mesh.mb_indcs
    amp = pin.get_or_add_real("problem", "amp", 0.0)
    x1min = pin.get_real("mesh", "x1min")
    x1max = pin.get_real("mesh", "x1max")

    def fluid(prefix, nvar):
        w = np.zeros((mesh.nmb_total, nvar,
                      mbi.ncells3, mbi.ncells2, mbi.ncells1))
        w[:, IDN] = pin.get_or_add_real("problem", f"d_{prefix}", 1.0)
        w[:, IVX] = pin.get_or_add_real("problem", f"vx_{prefix}", 0.0)
        w[:, IVY] = pin.get_or_add_real("problem", f"vy_{prefix}", 0.0)
        w[:, IVZ] = pin.get_or_add_real("problem", f"vz_{prefix}", 0.0)
        w[:, IEN] = pin.get_or_add_real("problem", f"p_{prefix}", 1.0) / gm1
        if amp != 0.0:
            for g in range(mesh.nmb_total):
                xv = mesh.cell_centers(g)[0]
                ph = 2.0 * np.pi * (xv - x1min) / (x1max - x1min)
                w[g, IVX] += amp * np.sin(ph)[None, None, :]
        return to_device(phys, w)

    wn = fluid("n", phys.phydro.nvar)
    wi = fluid("i", phys.pmhd.nvar)
    b0 = pin.get_or_add_real("problem", "b0", 0.0)
    bfc = {k: np.zeros(s) for k, s in phys.pmhd.fc_shapes.items()}
    bfc["x1f"][:] = b0
    bfc = {k: to_device(phys, v) for k, v in bfc.items()}
    bcc = phys.pmhd.compute_bcc(bfc)
    un = phys.phydro.prim_to_cons(wn)
    ui = phys.pmhd.prim_to_cons(wi, bcc)
    return phys.make_state(un, wn, ui, wi, bfc)
