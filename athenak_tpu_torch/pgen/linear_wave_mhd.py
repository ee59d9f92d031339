"""MHD linear wave: initial condition and error file.

Counterpart of ``athenak_tpu/pgen/linear_wave_mhd.py`` (reference: the MHD
branch of src/pgen/tests/linear_wave.cpp): the eigensystem in primitives
(MHDEigensystemPrim, Athena 2008 appendix A; ideal or isothermal), the
face field from the curl of the vector potential on the staggered mesh
(div B = 0 to round-off), and the L1-error file with the cell-centred
field's errors.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVX, IVY, IVZ
from . import errors as err_mod
from . import state_from_prims, to_device
from .linear_wave import wave_geometry


def _mhd_eigensystem(d, v1, p, b1, b2, b3, x, y, eos):
    """Eigenvalues + right eigenvectors (columns) of the primitive-variable
    MHD system W=(d,vx,vy,vz,[P],By,Bz)
    (reference: linear_wave.cpp MHDEigensystemPrim)."""
    btsq = b2 * b2 + b3 * b3
    bt = math.sqrt(btsq)
    asq = eos.gamma * p / d if eos.is_ideal else eos.iso_cs ** 2
    if bt == 0.0:
        bet2, bet3 = 1.0, 0.0
    else:
        bet2, bet3 = b2 / bt, b3 / bt

    if eos.is_ideal:
        gm1 = eos.gamma - 1.0
        bt_starsq = (gm1 - (gm1 - 1.0) * y) * btsq
        vaxsq = b1 * b1 / d
        ct2 = bt_starsq / d
        tsum = vaxsq + ct2 + asq
        tdif = vaxsq + ct2 - asq
        cf2_cs2 = math.sqrt(tdif * tdif + 4.0 * asq * ct2)
        cfsq = 0.5 * (tsum + cf2_cs2)
        cf = math.sqrt(cfsq)
        cssq = asq * vaxsq / cfsq
        cs = math.sqrt(cssq)

        if cfsq - cssq == 0.0:
            alpha_f, alpha_s = 1.0, 0.0
        elif asq - cssq <= 0.0:
            alpha_f, alpha_s = 0.0, 1.0
        elif cfsq - asq <= 0.0:
            alpha_f, alpha_s = 1.0, 0.0
        else:
            alpha_f = math.sqrt((asq - cssq) / (cfsq - cssq))
            alpha_s = math.sqrt((cfsq - asq) / (cfsq - cssq))

        sqrtd = math.sqrt(d)
        s = -1.0 if b1 < 0.0 else 1.0
        a = math.sqrt(asq)
        qf = cf * alpha_f * s
        qs = cs * alpha_s * s
        af = a * alpha_f * sqrtd
        as_ = a * alpha_s * sqrtd
        vax = math.sqrt(vaxsq)

        ev = np.array([v1 - cf, v1 - vax, v1 - cs, v1, v1 + cs, v1 + vax,
                       v1 + cf])
        rem = np.zeros((7, 7))
        rem[0] = [d * alpha_f, 0.0, d * alpha_s, 1.0, d * alpha_s, 0.0,
                  d * alpha_f]
        rem[1] = [-cf * alpha_f, 0.0, -cs * alpha_s, 0.0, cs * alpha_s, 0.0,
                  cf * alpha_f]
        rem[2] = [qs * bet2, -bet3, -qf * bet2, 0.0, qf * bet2, bet3,
                  -qs * bet2]
        rem[3] = [qs * bet3, bet2, -qf * bet3, 0.0, qf * bet3, -bet2,
                  -qs * bet3]
        rem[4] = [d * asq * alpha_f, 0.0, d * asq * alpha_s, 0.0,
                  d * asq * alpha_s, 0.0, d * asq * alpha_f]
        rem[5] = [as_ * bet2, -bet3 * s * sqrtd, -af * bet2, 0.0,
                  -af * bet2, -bet3 * s * sqrtd, as_ * bet2]
        rem[6] = [as_ * bet3, bet2 * s * sqrtd, -af * bet3, 0.0,
                  -af * bet3, bet2 * s * sqrtd, as_ * bet3]
        return ev, rem

    # isothermal MHD (Athena 2008 appendix A, B39+)
    bt_starsq = btsq * y
    vaxsq = b1 * b1 / d
    ct2 = bt_starsq / d
    tsum = vaxsq + ct2 + asq
    tdif = vaxsq + ct2 - asq
    cf2_cs2 = math.sqrt(tdif * tdif + 4.0 * asq * ct2)
    cfsq = 0.5 * (tsum + cf2_cs2)
    cf = math.sqrt(cfsq)
    cssq = asq * vaxsq / cfsq
    cs = math.sqrt(cssq)
    if cfsq - cssq == 0.0:
        alpha_f, alpha_s = 1.0, 0.0
    elif asq - cssq <= 0.0:
        alpha_f, alpha_s = 0.0, 1.0
    elif cfsq - asq <= 0.0:
        alpha_f, alpha_s = 1.0, 0.0
    else:
        alpha_f = math.sqrt((asq - cssq) / (cfsq - cssq))
        alpha_s = math.sqrt((cfsq - asq) / (cfsq - cssq))
    sqrtd = math.sqrt(d)
    s = -1.0 if b1 < 0.0 else 1.0
    a = math.sqrt(asq)
    qf = cf * alpha_f * s
    qs = cs * alpha_s * s
    af = a * alpha_f * sqrtd
    as_ = a * alpha_s * sqrtd
    vax = math.sqrt(vaxsq)
    ev = np.array([v1 - cf, v1 - vax, v1 - cs, v1 + cs, v1 + vax, v1 + cf])
    rem = np.zeros((6, 6))
    rem[0] = [d * alpha_f, 0.0, d * alpha_s, d * alpha_s, 0.0, d * alpha_f]
    rem[1] = [-cf * alpha_f, 0.0, -cs * alpha_s, cs * alpha_s, 0.0,
              cf * alpha_f]
    rem[2] = [qs * bet2, -bet3, -qf * bet2, qf * bet2, bet3, -qs * bet2]
    rem[3] = [qs * bet3, bet2, -qf * bet3, qf * bet3, -bet2, -qs * bet3]
    rem[4] = [as_ * bet2, -bet3 * s * sqrtd, -af * bet2, -af * bet2,
              -bet3 * s * sqrtd, as_ * bet2]
    rem[5] = [as_ * bet3, bet2 * s * sqrtd, -af * bet3, -af * bet3,
              bet2 * s * sqrtd, as_ * bet3]
    return ev, rem


def _build_mhd(pin, mesh, phys, rescale_tlim: bool):
    """Host-side primitives + face field for the MHD linear wave."""
    eos = phys.eos
    cos_a2, sin_a2, cos_a3, sin_a3, lx, k_par = wave_geometry(pin, mesh)

    wave_flag = pin.get_integer("problem", "wave_flag")
    amp = pin.get_real("problem", "amp")
    d0 = pin.get_real("problem", "dens")
    p0 = pin.get_real("problem", "pgas")
    vx0 = pin.get_or_add_real("problem", "vx0", 0.0)
    bx0 = pin.get_or_add_real("problem", "bx0", 1.0)
    by0 = pin.get_or_add_real("problem", "by0", math.sqrt(2.0))
    bz0 = pin.get_or_add_real("problem", "bz0", 0.5)

    nmhd = phys.nmhd
    ev, rem = _mhd_eigensystem(d0, vx0, p0, bx0, by0, bz0, 0.0, 1.0, eos)
    dby = amp * rem[nmhd, wave_flag]
    dbz = amp * rem[nmhd + 1, wave_flag]

    if rescale_tlim:
        tlim = pin.get_real("time", "tlim")
        pin.set_real("time", "tlim", tlim * abs(lx / ev[wave_flag]))

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    gm1 = eos.gamma - 1.0

    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))

    # vector potential in the rotated frame (reference A1/A2/A3 functions):
    # Ay = bz0*x - (dbz/k) cos(kx);  Az = -by0*x + (dby/k) cos(kx) + bx0*y
    def pot(x1, x2, x3):
        x = x1 * cos_a2 * cos_a3 + x2 * cos_a2 * sin_a3 + x3 * sin_a2
        y = -x1 * sin_a3 + x2 * cos_a3
        Ay = bz0 * x - (dbz / k_par) * np.cos(k_par * x)
        Az = -by0 * x + (dby / k_par) * np.cos(k_par * x) + bx0 * y
        a1 = -Ay * sin_a3 - Az * sin_a2 * cos_a3
        a2 = Ay * cos_a3 - Az * sin_a2 * sin_a3
        a3 = Az * cos_a2
        return a1, a2, a3

    dx1, dx2, dx3 = (mesh.mesh_size.dx1, mesh.mesh_size.dx2,
                     mesh.mesh_size.dx3)
    one_d = mbi.nx2 == 1

    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        x1f, x2f, x3f = mesh.face_edges(gid)

        # --- primitives on active cells
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        xpar = cos_a2 * (X1 * cos_a3 + X2 * sin_a3) + X3 * sin_a2
        sn = np.sin(k_par * xpar)
        rho = d0 + amp * sn * rem[0, wave_flag]
        vx = vx0 + amp * sn * rem[1, wave_flag]
        vy = amp * sn * rem[2, wave_flag]
        vz = amp * sn * rem[3, wave_flag]
        w[gid, IDN][act] = rho
        w[gid, IVX][act] = (vx * cos_a2 * cos_a3 - vy * sin_a3
                            - vz * sin_a2 * cos_a3)
        w[gid, IVY][act] = (vx * cos_a2 * sin_a3 + vy * cos_a3
                            - vz * sin_a2 * sin_a3)
        w[gid, IVZ][act] = vx * sin_a2 + vz * cos_a2
        if eos.is_ideal:
            w[gid, IEN][act] = (p0 + amp * sn * rem[4, wave_flag]) / gm1

        if one_d:
            # B directly: bx = const, by/bz perturbed along x
            xc = x1v
            bfc["x1f"][gid, 0, 0, :] = bx0
            bfc["x2f"][gid, 0, :, :] = by0 + dby * np.sin(k_par * xc)
            bfc["x3f"][gid, :, 0, :] = bz0 + dbz * np.sin(k_par * xc)
            continue

        # --- multi-d: B = curl A on the staggered mesh (div B = 0 exactly).
        # A components live on their cell edges: A1 at (x1v, x2f, x3f),
        # A2 at (x1f, x2v, x3f), A3 at (x1f, x2f, x3v) — reference
        # linear_wave.cpp computes a1/a2/a3 on exactly these points.
        x3f_use = x3f if mbi.nx3 > 1 else np.array([x3v[0], x3v[0]])
        X3, X2, X1 = np.meshgrid(x3f_use, x2f, x1v, indexing="ij")
        a1 = pot(X1, X2, X3)[0]                      # [n3+1, n2+1, n1]
        X3, X2, X1 = np.meshgrid(x3f_use, x2v, x1f, indexing="ij")
        a2 = pot(X1, X2, X3)[1]                      # [n3+1, n2, n1+1]
        x3v_use = x3v if mbi.nx3 > 1 else x3v[:1]
        X3, X2, X1 = np.meshgrid(x3v_use, x2f, x1f, indexing="ij")
        a3 = pot(X1, X2, X3)[2]                      # [n3, n2+1, n1+1]

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

    return w, bfc


def init_mhd(pin, mesh, phys):
    w, bfc = _build_mhd(pin, mesh, phys, rescale_tlim=True)
    return state_from_prims(phys, w, bfc)


def final_mhd(pin, mesh, phys, state):
    """L1/Linf against the initial condition, with the cell-centred
    field's L1 errors (reference: pgen.cpp:799-813); returns
    (l1, linf)."""
    u = state["u"]
    w_ref, bfc_ref = _build_mhd(pin, mesh, phys, rescale_tlim=False)
    w_ref = to_device(phys, w_ref)
    bfc_ref = {k: to_device(phys, v) for k, v in bfc_ref.items()}
    bcc_ref = phys.compute_bcc(bfc_ref)
    u_ref = phys.prim_to_cons(w_ref, bcc_ref)

    nvars = phys.nmhd
    l1, linf = err_mod.compute_errors(mesh, u, u_ref, nvars)

    bcc = state["bcc"]
    mbi = mesh.mb_indcs
    sl = (slice(None), slice(None),
          slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
          slice(mbi.is_, mbi.ie + 1))
    diff = np.abs(err_mod.host(bcc[sl]) - err_mod.host(bcc_ref[sl]))
    ms = mesh.mesh_size
    vol_cell = ms.dx1 * ms.dx2 * ms.dx3
    vol = ((ms.x1max - ms.x1min) * (ms.x2max - ms.x2min)
           * (ms.x3max - ms.x3min))
    l1b = vol_cell * diff.sum(axis=(0, 2, 3, 4)) / vol
    linf = max(linf, vol_cell * diff.max() / vol)
    l1 = np.concatenate([l1, l1b])

    header = (["d", "M1", "M2", "M3"]
              + (["E"] if phys.eos.is_ideal else [])
              + ["B1", "B2", "B3"])
    err_mod.write_error_file(pin, mesh, l1, linf, header)
    return l1, linf
