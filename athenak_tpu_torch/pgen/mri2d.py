"""The 2-D r-z MRI (Hawley & Balbus 1992, "HB3").

Counterpart of ``athenak_tpu/pgen/mri2d.py`` (reference:
src/pgen/fluids/mri2d.cpp, inputs/shearing_box/mri2d.athinput).  The grid
plane is (x1, x2) = (R, z), the toroidal direction is component 3, and
the vertical seed field lies on the x2 faces: ``ifield = 1`` gives
B2 = binit sin(kx x1) (zero net flux), 2 a uniform B2.  Random pressure
(ideal gas) or density (isothermal) perturbations, from numpy's
``default_rng(13)`` as in the JAX package, seed the instability.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IM1, IM2, IM3

from . import to_device


def init(pin, mesh, phys):
    if not getattr(phys, "is_mhd", False):
        raise ValueError("mri2d only works in mhd")
    if phys.psbox is None:
        raise ValueError("mri2d requires the <shearing_box> block")
    if mesh.mb_indcs.nx3 > 1:
        raise ValueError("mri2d is the 2D (nx3=1) r-z problem; "
                         "use mri3d in 3D")
    eos = phys.eos
    amp = pin.get_real("problem", "amp")
    beta = pin.get_real("problem", "beta")
    nwx = pin.get_or_add_integer("problem", "nwx", 1)
    ifield = pin.get_or_add_integer("problem", "ifield", 1)
    d0, p0 = 1.0, 1.0
    binit = math.sqrt(2.0 * p0 / beta)
    ms = mesh.mesh_size
    kx = 2.0 * math.pi / (ms.x1max - ms.x1min) * nwx

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    gm1 = eos.gamma - 1.0 if eos.is_ideal else 0.0
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    rng = np.random.default_rng(13)

    for gid in range(nmb):
        if ifield not in (1, 2):
            raise ValueError(f"mri2d ifield={ifield} not in (1,2)")
        x1v = mesh.cell_centers(gid)[0][None, None, mbi.is_:mbi.ie + 1]
        bz = binit * np.sin(kx * x1v) if ifield == 1 \
            else binit + 0.0 * x1v
        # constant along x2, so the one extra face keeps div B = 0
        bfc["x2f"][gid][(act[0], slice(mbi.js, mbi.je + 2), act[2])] = bz
        shape = (mbi.ke + 1 - mbi.ks, mbi.je + 1 - mbi.js,
                 mbi.ie + 1 - mbi.is_)
        rval = 1.0 + amp * (rng.random(shape) - 0.5)
        u[gid, IDN][act] = rval * d0 if not eos.is_ideal \
            else d0 + 0.0 * rval
        for comp in (IM1, IM2, IM3):
            u[gid, comp][act] = 0.0
        if eos.is_ideal:
            u[gid, IEN][act] = rval * p0 / gm1 + 0.5 * bz ** 2

    bt = {k: to_device(phys, v) for k, v in bfc.items()}
    bcc = phys.compute_bcc(bt)
    w, ut, _ = phys.cons_to_prim(to_device(phys, u), bcc)
    return phys.make_state(ut, w, bt, bcc=bcc)
