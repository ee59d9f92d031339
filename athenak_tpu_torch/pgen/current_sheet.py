"""Double Harris current sheets (tearing / plasmoid test).

Counterpart of ``athenak_tpu/pgen/current_sheet.py`` (reference:
src/pgen/fluids/current_sheet.cpp): two sech^2 density sheets at
x = -/+ x01 with a tanh reversing field B2, an optional guide field bg,
and (epsv, epsb) tearing-mode velocity and field perturbations.  The
conserved state is set on the interior and converted to primitives
with the physics module's c2p (hydro: no field; or MHD).
"""

from __future__ import annotations

import numpy as np

from ..indices import IDN, IEN, IM1, IM2

from . import to_device


def init(pin, mesh, phys):
    d0 = pin.get_or_add_real("problem", "d0", 1.0)
    ngas = pin.get_or_add_real("problem", "ng", 1.0)
    bb0 = pin.get_or_add_real("problem", "b0", 1.0)
    a0 = pin.get_or_add_real("problem", "a0", 1.0)
    bg = pin.get_or_add_real("problem", "bg", 0.0)
    x01 = pin.get_or_add_real("problem", "x01", 3.0)
    epsb = pin.get_or_add_real("problem", "epsb", 0.0)
    epsv = pin.get_or_add_real("problem", "epsv", 0.0)
    kval = pin.get_or_add_real("problem", "kval", 1.0)

    eos = phys.eos
    gm1 = eos.gamma - 1.0 if eos.is_ideal else 0.0
    p0 = 1.0 / eos.gamma

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    is_mhd = getattr(phys, "is_mhd", False)
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()} \
        if is_mhd else None
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))

    def gauss(x):
        return (np.exp(-((x + x01) / a0) ** 2)
                + np.exp(-((x - x01) / a0) ** 2))

    def gaussx(x):
        return (np.exp(-((x + x01) / a0) ** 2) * (x + x01)
                + np.exp(-((x - x01) / a0) ** 2) * (x - x01))

    for gid in range(nmb):
        x1v, x2v, _ = mesh.cell_centers(gid)
        x1f, x2f, _ = mesh.face_edges(gid)
        X1 = x1v[None, None, mbi.is_:mbi.ie + 1]
        X2 = x2v[None, mbi.js:mbi.je + 1, None]
        dens = (d0 / np.cosh((X1 + x01) / a0) ** 2
                + d0 / np.cosh((X1 - x01) / a0) ** 2 + ngas)
        u[gid, IDN][act] = dens + 0.0 * X2
        u[gid, IM1][act] = epsv * np.sin(kval * X2) * gauss(X1)
        u[gid, IM2][act] = (-2.0 * epsv * np.cos(kval * X2)
                            * gaussx(X1) / (kval * a0 * a0))
        if eos.is_ideal:
            u[gid, IEN][act] = p0 / gm1 * (dens + 0.0 * X2)

        if is_mhd:
            X1F = x1f[None, None, mbi.is_:mbi.ie + 2]
            X2F = x2f[None, mbi.js:mbi.je + 2, None]
            bfc["x1f"][gid][(act[0], act[1],
                             slice(mbi.is_, mbi.ie + 2))] = \
                bb0 * epsb * np.sin(kval * X2) * gauss(X1F)
            b2 = (bb0 * np.tanh((X1 + x01) / a0)
                  - bb0 * np.tanh((X1 - x01) / a0) - bb0
                  - 2.0 * bb0 * epsb * np.cos(kval * X2F)
                  * gaussx(X1) / (kval * a0 * a0))
            bfc["x2f"][gid][(act[0], slice(mbi.js, mbi.je + 2),
                             act[2])] = b2
            bfc["x3f"][gid][(slice(mbi.ks, mbi.ke + 2), act[1],
                             act[2])] = bg

    ut = to_device(phys, u)
    if is_mhd:
        bt = {k: to_device(phys, v) for k, v in bfc.items()}
        bcc = phys.compute_bcc(bt)
        w, ut, _ = phys.cons_to_prim(ut, bcc)
        return phys.make_state(ut, w, bt, bcc=bcc)
    w, ut, _ = phys.cons_to_prim(ut)
    return phys.make_state(ut, w)
