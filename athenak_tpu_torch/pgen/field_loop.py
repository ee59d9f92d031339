"""Field-loop advection test (Gardiner & Stone 2005).

Counterpart of ``athenak_tpu/pgen/field_loop.py`` (reference:
src/pgen/fluids/field_loop.cpp): a loop of vector potential (iprob 1:
the x1-x2 plane; 2: x2-x3; 3: x3-x1; 4: a rotated cylinder in 3-D), an
advection velocity that crosses the diagonal once in unit time, and
B = curl A on the staggered mesh (div B = 0 exactly).  Newtonian MHD.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVX, IVY, IVZ

from . import state_from_prims


def init(pin, mesh, phys):
    if not getattr(phys, "is_mhd", False):
        raise ValueError("field_loop requires the <mhd> block "
                         "(the hydro variant needs the shearing box)")
    rad = pin.get_or_add_real("problem", "rad", 0.0)
    amp = pin.get_or_add_real("problem", "amp", 0.0)
    press = pin.get_or_add_real("problem", "press", 1.0)
    iprob = pin.get_integer("problem", "iprob")

    ms = mesh.mesh_size
    lx = ms.x1max - ms.x1min
    ly = ms.x2max - ms.x2min
    lz = ms.x3max - ms.x3min
    x0, y0 = ms.x1min, ms.x2min
    xc = x0 + 0.5 * lx   # loop center (reference xpt[2]/ypt[2])
    yc = y0 + 0.5 * ly
    three_d = mesh.three_d
    diag = math.sqrt(lx * lx + ly * ly + (lz * lz if three_d else 0.0))
    vflow = diag  # one diagonal crossing per unit time

    cos_a2 = sin_a2 = 0.0
    lam = 0.0
    if iprob == 4:
        if lx == lz:
            cos_a2 = sin_a2 = math.sqrt(0.5)
        else:
            ang_2 = math.atan(lx / lz)
            sin_a2, cos_a2 = math.sin(ang_2), math.cos(ang_2)
        lam = lx * cos_a2 if cos_a2 >= sin_a2 else lz * sin_a2

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    eos = phys.eos
    gm1 = eos.gamma - 1.0
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))

    def pot(X1v_or_f, X2f, X3v_or_f, which):
        """A components on their edge locations (field_loop.cpp floop1)."""
        ax = np.zeros(np.broadcast(X1v_or_f, X2f, X3v_or_f).shape)
        ay = np.zeros_like(ax)
        az = np.zeros_like(ax)
        if iprob == 1 and which == "a3":
            r = np.sqrt((X1v_or_f - xc) ** 2 + (X2f - yc) ** 2)
            az = np.where(r < rad, amp * (rad - r), 0.0)
        if iprob == 2 and which == "a1":
            r = np.sqrt(X2f ** 2 + X3v_or_f ** 2)
            ax = np.where(r < rad, amp * (rad - r), 0.0)
        if iprob == 3 and which == "a2":
            r = np.sqrt(X1v_or_f ** 2 + X3v_or_f ** 2)
            ay = np.where(r < rad, amp * (rad - r), 0.0)
        if iprob == 4:
            x = X1v_or_f * cos_a2 + X3v_or_f * sin_a2
            x = x - lam * np.round(x / lam)
            r2 = x * x + X2f ** 2
            if which == "a1":
                ax = np.where(r2 < rad * rad,
                              amp * (rad - np.sqrt(r2)) * (-sin_a2), 0.0)
            if which == "a3":
                az = np.where(r2 < rad * rad,
                              amp * (rad - np.sqrt(r2)) * cos_a2, 0.0)
        return {"a1": ax, "a2": ay, "a3": az}[which]

    dx1 = float(ms.dx1)
    dx2 = float(ms.dx2)
    dx3 = float(ms.dx3)
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        x1f, x2f, x3f = mesh.face_edges(gid)
        x3f_use = x3f if mbi.nx3 > 1 else np.array([x3v[0], x3v[0]])
        x3v_use = x3v if mbi.nx3 > 1 else x3v[:1]

        # A1 at (x1v, x2f, x3f); A2 at (x1f, x2v, x3f); A3 at (x1f, x2f, x3v)
        X3, X2, X1 = np.meshgrid(x3f_use, x2f, x1v, indexing="ij")
        a1 = pot(X1, X2, X3, "a1")
        X3, X2, X1 = np.meshgrid(x3f_use, x2v, x1f, indexing="ij")
        a2 = pot(X1, X2, X3, "a2")
        X3, X2, X1 = np.meshgrid(x3v_use, x2f, x1f, indexing="ij")
        a3 = pot(X1, X2, X3, "a3")

        b1 = (a3[:, 1:, :] - a3[:, :-1, :]) / dx2
        b2 = -(a3[:, :, 1:] - a3[:, :, :-1]) / dx1
        b3 = ((a2[:, :, 1:] - a2[:, :, :-1]) / dx1
              - (a1[:, 1:, :] - a1[:, :-1, :]) / dx2)
        if mbi.nx3 > 1:
            b1 = b1 - (a2[1:, :, :] - a2[:-1, :, :]) / dx3
            b2 = b2 + (a1[1:, :, :] - a1[:-1, :, :]) / dx3
            bfc["x1f"][gid] = b1
            bfc["x2f"][gid] = b2
            bfc["x3f"][gid] = b3
        else:
            bfc["x1f"][gid] = b1[:1]
            bfc["x2f"][gid] = b2[:1]
            bfc["x3f"][gid][0] = b3[0]
            bfc["x3f"][gid][1] = b3[0]

        w[gid, IDN][act] = 1.0
        w[gid, IVX][act] = vflow * lx / diag
        w[gid, IVY][act] = vflow * ly / diag
        w[gid, IVZ][act] = 0.0
        if eos.is_ideal:
            w[gid, IEN][act] = press / gm1

    return state_from_prims(phys, w, bfc)
