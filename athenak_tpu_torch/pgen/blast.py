"""Spherical blast wave (hydro, or MHD Newtonian or SR).

Counterpart of ``athenak_tpu/pgen/blast.py`` (reference:
src/pgen/fluids/blast.cpp, Cartesian branch): ambient state with a
pressure/density ratio inside a sphere, a log-smooth ramp between the
inner and outer radii, and under MHD a uniform Bx from A3 = b_amb * y
(the ambient state is <problem>/pn_amb, dn_amb under hydro and pi_amb,
di_amb under MHD).  The initial
primitives are made in host numpy and moved to the device, where the
physics module's p2c (the SR one under <coord>/special_rel) makes the
conserved state.
"""

from __future__ import annotations

import numpy as np

from ..indices import IDN, IEN

from . import state_from_prims


def init(pin, mesh, phys):
    is_mhd = getattr(phys, "is_mhd", False)
    rout = pin.get_real("problem", "outer_radius")
    rin = rout - pin.get_real("problem", "inner_radius")
    p_amb = pin.get_or_add_real("problem",
                                "pi_amb" if is_mhd else "pn_amb", 1.0)
    d_amb = pin.get_or_add_real("problem",
                                "di_amb" if is_mhd else "dn_amb", 1.0)
    prat = pin.get_real("problem", "prat")
    drat = pin.get_or_add_real("problem", "drat", 1.0)
    b_amb = pin.get_or_add_real("problem", "b_amb", 0.1)
    gm1 = phys.eos.gamma - 1.0

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))

    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        rad = np.sqrt(X1 ** 2 + X2 ** 2 + X3 ** 2)

        f = np.clip((rad - rin) / (rout - rin), 0.0, 1.0)
        log_den = (1.0 - f) * np.log(drat * d_amb) + f * np.log(d_amb)
        log_pres = (1.0 - f) * np.log(prat * p_amb) + f * np.log(p_amb)
        den = np.where(rad < rout, np.exp(log_den), d_amb)
        pres = np.where(rad < rout, np.exp(log_pres), p_amb)

        w[gid, IDN][act] = den
        w[gid, IEN][act] = pres / gm1

    if not is_mhd:
        return state_from_prims(phys, w)
    # uniform Bx = b_amb (A3 = b_amb * y)
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    bfc["x1f"][:] = b_amb
    return state_from_prims(phys, w, bfc)
