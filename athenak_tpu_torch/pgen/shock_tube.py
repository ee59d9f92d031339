"""Shock tube (Riemann problem), hydro or MHD, Newtonian or SR.

Counterpart of ``athenak_tpu/pgen/shock_tube.py`` (reference:
src/pgen/tests/shock_tube.cpp): discontinuous left/right states along
``problem/shock_dir`` at ``problem/xshock``; under MHD a field from
``problem/bxl`` .. ``bzr`` (along x1 only), each side's value on the
faces left and right of the shock.  Under SR the velocities are the
primitives' u^i and the SR p2c makes the conserved state; SR hydro
raises in the physics constructor.  Under dynamical GRMHD (a physics
with the primitive solver ``ps``) the energy slot holds the pressure,
the background is a fixed Minkowski ADM slice, and the temperature
comes from the EOS policy (reference: shock_tube.cpp dyngr branch).
"""

from __future__ import annotations

import numpy as np
import torch

from ..indices import IDN, IEN, IVX, IVY, IVZ

from . import state_from_prims, to_device


def minkowski(mesh):
    """The flat ADM slice on ``mesh``: (g3d, alpha, beta_u, K_dd) host
    arrays [nmb, n3, n2, n1]."""
    mbi = mesh.mb_indcs
    shp = (mesh.nmb_total, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    one, zero = np.ones(shp), np.zeros(shp)
    return [one, zero, zero, one, zero, one], one, [zero, zero, zero], None


def init(pin, mesh, phys):
    shock_dir = pin.get_integer("problem", "shock_dir")
    xshock = pin.get_real("problem", "xshock")
    wl = [pin.get_real("problem", "dl"), pin.get_real("problem", "ul"),
          pin.get_real("problem", "vl"), pin.get_real("problem", "wl")]
    wr = [pin.get_real("problem", "dr"), pin.get_real("problem", "ur"),
          pin.get_real("problem", "vr"), pin.get_real("problem", "wr")]
    is_dyngr = hasattr(phys, "ps")
    if is_dyngr:
        wl.append(pin.get_real("problem", "pl"))
        wr.append(pin.get_real("problem", "pr"))
    elif phys.eos.is_ideal:
        gm1 = phys.eos.gamma - 1.0
        wl.append(pin.get_real("problem", "pl") / gm1)
        wr.append(pin.get_real("problem", "pr") / gm1)

    # the shock-normal velocity goes into the slot of shock_dir
    perm = {1: (IVX, IVY, IVZ), 2: (IVY, IVZ, IVX),
            3: (IVZ, IVX, IVY)}.get(shock_dir)
    if perm is None:
        raise ValueError("problem/shock_dir must be 1, 2, or 3")

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    a = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
         slice(mbi.is_, mbi.ie + 1))
    shape = (mbi.ke - mbi.ks + 1, mbi.je - mbi.js + 1,
             mbi.ie - mbi.is_ + 1)
    for gid in range(nmb):
        coords = mesh.cell_centers(gid)[shock_dir - 1]
        lo = (mbi.is_, mbi.js, mbi.ks)[shock_dir - 1]
        hi = (mbi.ie, mbi.je, mbi.ke)[shock_dir - 1]
        c = coords[lo:hi + 1]
        view = [1, 1, 1]
        view[3 - shock_dir] = -1
        mask = np.broadcast_to(c.reshape(view) < xshock, shape)
        w[gid, IDN][a] = np.where(mask, wl[0], wr[0])
        w[gid, perm[0]][a] = np.where(mask, wl[1], wr[1])
        w[gid, perm[1]][a] = np.where(mask, wl[2], wr[2])
        w[gid, perm[2]][a] = np.where(mask, wl[3], wr[3])
        if phys.eos.is_ideal:
            w[gid, IEN][a] = np.where(mask, wl[4], wr[4])

    if not getattr(phys, "is_mhd", False):
        return state_from_prims(phys, w)
    # MHD shock tubes: a field from problem/bxl .. bzr (Brio-Wu)
    bxl = pin.get_or_add_real("problem", "bxl", 0.0)
    byl = pin.get_or_add_real("problem", "byl", 0.0)
    bzl = pin.get_or_add_real("problem", "bzl", 0.0)
    bxr = pin.get_or_add_real("problem", "bxr", bxl)
    byr = pin.get_or_add_real("problem", "byr", byl)
    bzr = pin.get_or_add_real("problem", "bzr", bzl)
    if shock_dir != 1:
        raise NotImplementedError("MHD shock tube only along x1")
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    for gid in range(nmb):
        x1f = mesh.face_edges(gid)[0]
        x1v = mesh.cell_centers(gid)[0]
        bfc["x1f"][gid] = np.where(x1f.reshape(1, 1, -1) < xshock, bxl, bxr)
        bfc["x2f"][gid] = np.where(x1v.reshape(1, 1, -1) < xshock, byl, byr)
        bfc["x3f"][gid] = np.where(x1v.reshape(1, 1, -1) < xshock, bzl, bzr)
    if not is_dyngr:
        return state_from_prims(phys, w, bfc)
    phys.set_fixed_adm(*minkowski(mesh), sampler=minkowski)
    wt = to_device(phys, w)
    bfct = {k: to_device(phys, v) for k, v in bfc.items()}
    bcc = phys.compute_bcc(bfct)
    n = wt[:, IDN] / phys.ps.mb
    T = phys.policy.temperature_from_p(torch.clamp(n, min=phys.ps.n_atm),
                                       wt[:, IEN])
    u = phys.prim_to_cons_state(wt, T, bcc, phys.adm_of({}))
    return phys.make_state(u, wt, bfct, T=T)
