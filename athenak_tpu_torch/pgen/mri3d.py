"""The 3-D MRI in the shearing box (Hawley, Gammie & Balbus 1995).

Counterpart of ``athenak_tpu/pgen/mri3d.py`` (reference:
src/pgen/tests/mri3d.cpp): an unstratified or stratified (isothermal)
box with three field geometries (``ifield`` 1: zero-net-flux
Bz sin(kx x); 2: uniform Bz; 3: uniform or Gaussian By within
|z| < zlimit), random perturbations of the conserved variables (numpy's
``default_rng(11)``, as in the JAX package), and the reference's
MRIHistory user history: the kinetic and magnetic energy components,
the mean field, the Reynolds stress dVxVy and the Maxwell stress dBxBy.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IM1, IM2, IM3

from . import host64, to_device


def init(pin, mesh, phys):
    if not getattr(phys, "is_mhd", False):
        raise ValueError("mri3d only works in mhd")
    if phys.psbox is None:
        raise ValueError("mri3d requires the <shearing_box> block")
    eos = phys.eos
    is_strat = pin.get_or_add_boolean("problem", "strat", False)
    if eos.is_ideal and is_strat:
        raise ValueError("stratified shearing box requires isothermal EOS")

    amp = pin.get_real("problem", "amp")
    beta = pin.get_real("problem", "beta")
    nwx = pin.get_or_add_integer("problem", "nwx", 1)
    ifield = pin.get_or_add_integer("problem", "ifield", 1)
    d0 = pin.get_or_add_real("problem", "dens", 1.0)
    omega0 = phys.psbox.omega0
    if eos.is_ideal:
        p0 = pin.get_real("problem", "pres")
        hs = math.sqrt(eos.gamma * p0 / d0) / omega0
    else:
        p0 = d0 * eos.iso_cs ** 2
        hs = eos.iso_cs / omega0
    binit = math.sqrt(2.0 * p0 / beta)

    ms = mesh.mesh_size
    kx = 2.0 * math.pi / (ms.x1max - ms.x1min) * nwx
    x3size = max(abs(ms.x3max), abs(ms.x3min))
    zlimit = pin.get_or_add_real("problem", "zlimit", x3size)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    gm1 = eos.gamma - 1.0 if eos.is_ideal else 0.0
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    rng = np.random.default_rng(11)

    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X1 = x1v[None, None, :] + 0.0 * x3v[:, None, None]
        X3 = 0.0 * x1v[None, None, :] + x3v[:, None, None] \
            + 0.0 * x2v[None, :, None]
        X1 = X1 + 0.0 * x2v[None, :, None]

        # the face field (reference: mri3d.cpp:146-176), constant along
        # each face direction, so one extra face layer keeps div B = 0
        if ifield == 1:
            bz = binit * np.sin(kx * X1[:1, act[1], act[2]])
            bfc["x3f"][gid][(slice(mbi.ks, mbi.ke + 2),) + act[1:]] = bz
        elif ifield == 2:
            bfc["x3f"][gid][(slice(mbi.ks, mbi.ke + 2),) + act[1:]] = binit
        elif ifield == 3:
            by0 = binit * np.exp(-X3 ** 2 / (2.0 * hs)) if is_strat \
                else binit + 0.0 * X3
            by0 = np.where(np.abs(X3) < zlimit, by0, 0.0)
            bfc["x2f"][gid][(act[0], slice(mbi.js, mbi.je + 2),
                             act[2])] = by0[act[0], :1, act[2]]
        else:
            raise ValueError(f"mri3d ifield={ifield} not in (1,2,3)")

        # the perturbations of the conserved variables (reference:
        # mri3d.cpp:184-223)
        rd = d0 * np.exp(-X3 ** 2 / (2.0 * hs)) if is_strat \
            else d0 + 0.0 * X3
        rd = rd[act]
        if not eos.is_ideal:
            rd = rd * (1.0 + amp * 2.0 * (rng.random(rd.shape) - 0.5))
        u[gid, IDN][act] = rd
        for comp in (IM1, IM2, IM3):
            u[gid, comp][act] = rd * amp * 2.0 * (rng.random(rd.shape)
                                                  - 0.5)
        if eos.is_ideal:
            rp = p0 * (1.0 + amp * 2.0 * (rng.random(rd.shape) - 0.5))
            b2f = bfc["x2f"][gid]
            b3f = bfc["x3f"][gid]
            by_c = 0.5 * (b2f[act[0], mbi.js:mbi.je + 1, act[2]]
                          + b2f[act[0], mbi.js + 1:mbi.je + 2, act[2]])
            bz_c = 0.5 * (b3f[mbi.ks:mbi.ke + 1][:, act[1], act[2]]
                          + b3f[mbi.ks + 1:mbi.ke + 2][:, act[1], act[2]])
            u[gid, IEN][act] = rp / gm1 + 0.5 * by_c ** 2 + 0.5 * bz_c ** 2

    bt = {k: to_device(phys, v) for k, v in bfc.items()}
    bcc = phys.compute_bcc(bt)
    w, ut, _ = phys.cons_to_prim(to_device(phys, u), bcc)
    _enroll_mri_history(phys, mesh)
    return phys.make_state(ut, w, bt, bcc=bcc)


def _enroll_mri_history(phys, mesh):
    """The volume-integrated energy components, mean field and stresses
    (reference: MRIHistory, mri3d.cpp:233-336), on the host in float64."""
    mbi = mesh.mb_indcs
    vol = (np.asarray(mesh.mb_size["dx1"])
           * np.asarray(mesh.mb_size["dx2"])
           * np.asarray(mesh.mb_size["dx3"])).reshape(-1, 1, 1, 1)
    a4 = (slice(None), slice(mbi.ks, mbi.ke + 1),
          slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))

    def hist(mesh_now, state):
        u = host64(state["u"])
        bcc = host64(state["bcc"])
        b1, b2, b3 = (host64(state["bfc"][c]) for c in ("x1f", "x2f", "x3f"))
        dens = u[:, IDN][a4]
        m1, m2, m3 = (u[:, c][a4] for c in (IM1, IM2, IM3))
        labels = ["1-KE", "2-KE", "3-KE", "1-ME", "2-ME", "3-ME",
                  "1-bcc", "2-bcc", "3-bcc", "dVxVy", "dBxBy"]
        ke = [float((vol * 0.5 * m ** 2 / dens).sum())
              for m in (m1, m2, m3)]
        me = [float((vol * 0.25 * (
            b1[:, a4[1], a4[2], mbi.is_ + 1:mbi.ie + 2] ** 2
            + b1[:, a4[1], a4[2], mbi.is_:mbi.ie + 1] ** 2)).sum()),
            float((vol * 0.25 * (
                b2[:, a4[1], mbi.js + 1:mbi.je + 2, a4[3]] ** 2
                + b2[:, a4[1], mbi.js:mbi.je + 1, a4[3]] ** 2)).sum()),
            float((vol * 0.25 * (
                b3[:, mbi.ks + 1:mbi.ke + 2, a4[2], a4[3]] ** 2
                + b3[:, mbi.ks:mbi.ke + 1, a4[2], a4[3]] ** 2)).sum())]
        bm = [float((vol * bcc[:, c][a4]).sum()) for c in range(3)]
        dvxvy = float((vol * m1 * m2 / dens).sum())
        dbxby = float(-(vol * bcc[:, 0][a4] * bcc[:, 1][a4]).sum())
        return labels, ke + me + bm + [dvxvy, dbxby]

    phys.user_hist_func = hist
