"""Linear shearing waves in the shearing box.

Counterpart of ``athenak_tpu/pgen/shwave.py`` (reference:
src/pgen/tests/shwave.cpp): the incompressible (``ipert = 2``) and
compressible (3) hydro shearing waves of Johnson & Gammie (2005) and the
compressible MHD wave (4) of Johnson, Guan & Gammie (2008, their figure
11), whose field comes from a vector potential on the edges (div B = 0
to round-off).  ``ipert`` 3 and 4 enroll the user history of the
reference, the projection of vy (``dVyc``) or of By less its sheared
background (``dByc``) on the time-sheared wave mode.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IM1, IM2, IM3

from . import host64, to_device


def init(pin, mesh, phys):
    d0 = pin.get_real("problem", "d0")
    p0 = pin.get_or_add_real("problem", "p0", 1.0)
    amp = pin.get_real("problem", "amp")
    ipert = pin.get_integer("problem", "ipert")

    ms = mesh.mesh_size
    kx = (2.0 * math.pi / (ms.x1max - ms.x1min)) \
        * pin.get_integer("problem", "nwx")
    ky = (2.0 * math.pi / (ms.x2max - ms.x2min)) \
        * pin.get_integer("problem", "nwy")
    kz = (2.0 * math.pi / (ms.x3max - ms.x3min)) \
        * pin.get_integer("problem", "nwz")

    if phys.psbox is None:
        raise ValueError("shwave pgen requires a <shearing_box> block")
    qshear, omega0 = phys.psbox.qshear, phys.psbox.omega0
    eos = phys.eos
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    a = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
         slice(mbi.is_, mbi.ie + 1))

    is_mhd = getattr(phys, "is_mhd", False)
    if is_mhd and ipert != 4:
        raise ValueError("MHD shwave test requires ipert=4")

    if not is_mhd:
        gm1 = eos.gamma - 1.0 if eos.is_ideal else 0.0
        for gid in range(nmb):
            x1v, x2v, _ = mesh.cell_centers(gid)
            X2, X1 = np.meshgrid(x2v[mbi.js:mbi.je + 1],
                                 x1v[mbi.is_:mbi.ie + 1], indexing="ij")
            ph = kx * X1 + ky * X2
            if ipert == 2:
                u[gid, IM1][a] = d0 * (amp * np.sin(ph))
                u[gid, IM2][a] = d0 * (-amp * (kx / ky) * np.sin(ph))
            elif ipert == 3:
                u[gid, IM1][a] = -d0 * (amp * np.cos(ph))
                u[gid, IM2][a] = -d0 * (amp * (ky / kx) * np.cos(ph))
            else:
                raise ValueError(f"hydro shwave ipert={ipert} unknown "
                                 "(2 or 3)")
            u[gid, IDN][a] = d0
            if eos.is_ideal:
                u[gid, IEN][a] = p0 / gm1 \
                    + 0.5 * (u[gid, IM1][a] ** 2
                             + u[gid, IM2][a] ** 2) / d0
        if ipert == 3:
            _enroll_hist(phys, mesh, kx, ky, 0.0, qshear, omega0,
                         is_mhd=False)
        w, ut, _ = phys.cons_to_prim(to_device(phys, u))
        return phys.make_state(ut, w)

    # ipert 4: the compressible MHD wave (JGG08 figure 11)
    beta = pin.get_real("problem", "beta")
    B02 = p0 / beta
    k2 = kx * kx + ky * ky + kz * kz
    rbx = ky * math.sqrt(B02 / (kx * kx + ky * ky))
    rby = -kx * math.sqrt(B02 / (kx * kx + ky * ky))
    rbz = 0.0
    sch = eos.iso_cs / omega0
    cf1 = math.sqrt(B02 * (1.0 + beta))
    cf2 = amp * math.sqrt(sch * math.sqrt(k2 * beta / (1.0 + beta)))
    vd = cf1 / math.sqrt(k2) * cf2

    bfc = {k_: np.zeros(s) for k_, s in phys.fc_shapes.items()}
    dx1, dx2, dx3 = ms.dx1, ms.dx2, ms.dx3
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        x1f, x2f, x3f = mesh.face_edges(gid)
        X3, X2, X1 = np.meshgrid(x3v, x2v, x1v, indexing="ij")
        csk = np.cos(kx * X1 + ky * X2 + kz * X3)
        rd = d0 * (1.0 + cf2 * csk)
        u[gid, IDN] = rd
        u[gid, IM1] = rd * vd * kx * csk
        u[gid, IM2] = rd * vd * ky * csk
        u[gid, IM3] = rd * vd * kz * csk

        # the vector potential on the edges -> the face field
        def pot(xa, xb, xc, fac):
            C3, C2, C1 = np.meshgrid(xc, xb, xa, indexing="ij")
            return (cf2 / k2) * np.sin(kx * C1 + ky * C2 + kz * C3) * fac

        a1 = pot(x1v, x2f, x3f, rby * kz - rbz * ky)
        a2 = pot(x1f, x2v, x3f, rbz * kx - rbx * kz)
        a3 = pot(x1f, x2f, x3v, rbx * ky - rby * kx)
        bfc["x1f"][gid] = rbx \
            + (a3[:, 1:, :] - a3[:, :-1, :]) / dx2 \
            - (a2[1:, :, :] - a2[:-1, :, :]) / dx3
        bfc["x2f"][gid] = rby \
            + (a1[1:, :, :] - a1[:-1, :, :]) / dx3 \
            - (a3[:, :, 1:] - a3[:, :, :-1]) / dx1
        bfc["x3f"][gid] = rbz \
            + (a2[:, :, 1:] - a2[:, :, :-1]) / dx1 \
            - (a1[:, 1:, :] - a1[:, :-1, :]) / dx2

    bt = {k_: to_device(phys, v) for k_, v in bfc.items()}
    bcc = phys.compute_bcc(bt)
    if eos.is_ideal:
        u[:, IEN] += 0.5 * host64(bcc[:, 0] ** 2 + bcc[:, 1] ** 2
                                  + bcc[:, 2] ** 2)
    w, ut, _ = phys.cons_to_prim(to_device(phys, u), bcc)
    _enroll_hist(phys, mesh, kx, ky, kz, qshear, omega0, is_mhd=True,
                 rbx=rbx, rby=rby)
    return phys.make_state(ut, w, bt, bcc=bcc)


def _enroll_hist(phys, mesh, kx, ky, kz, qshear, omega0, is_mhd,
                 rbx=0.0, rby=0.0):
    """The projection of the perturbation on the time-sheared wave mode
    (reference: ShwaveHistory, shwave.cpp:349-425), on the host."""
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    xs = np.empty((nmb, 1, mbi.nx3, mbi.nx2, mbi.nx1))
    ys = np.empty_like(xs)
    zs = np.empty_like(xs)
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[mbi.ks:mbi.ke + 1],
                                 x2v[mbi.js:mbi.je + 1],
                                 x1v[mbi.is_:mbi.ie + 1], indexing="ij")
        xs[gid, 0], ys[gid, 0], zs[gid, 0] = X1, X2, X3
    vol = (np.asarray(mesh.mb_size["dx1"])
           * np.asarray(mesh.mb_size["dx2"])
           * np.asarray(mesh.mb_size["dx3"])).reshape(-1, 1, 1, 1, 1)
    a = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
         slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))

    def hist(mesh_now, state):
        t = mesh_now.time
        kxt = kx + qshear * omega0 * t * ky
        csk = np.cos(kxt * xs + ky * ys + kz * zs)
        if is_mhd:
            by = host64(state["bcc"][a][:, 1:2])
            bg = rby - qshear * omega0 * t * rbx
            return ["dByc"], [(vol * 2.0 * (by - bg) * csk).sum()]
        wy = host64(state["w"][a][:, 2:3])
        return ["dVyc"], [(vol * 2.0 * wy * csk).sum()]

    phys.user_hist_func = hist
