"""The binary potential test: two uniform-density spheres and the
multigrid self-gravity, held against the analytic two-sphere potential.

Counterpart of ``athenak_tpu/pgen/binary_gravity.py`` (reference:
src/pgen/tests/binary_gravity.cpp): the sub-sampled spheres (10^3
sub-cells across the surface band), the total mass renormalised to
m1 + m2, and the ``final`` error report (BinaryGravityErrors: the
volume-weighted relative L2 and maximum errors of phi and of its
gradient).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..indices import IDN, IEN
from . import to_device

_FLOOR_DEN = 1.0e-300


def _params(pin):
    return dict(
        x1=pin.get_or_add_real("problem", "x1", 6.0 / 1024.0),
        y1=pin.get_or_add_real("problem", "y1", 0.0),
        z1=pin.get_or_add_real("problem", "z1", 0.0),
        x2=pin.get_or_add_real("problem", "x2", -12.0 / 1024.0),
        y2=pin.get_or_add_real("problem", "y2", 0.0),
        z2=pin.get_or_add_real("problem", "z2", 0.0),
        r=pin.get_or_add_real("problem", "radius", 6.0 / 1024.0),
        m1=pin.get_or_add_real("problem", "m1", 2.0),
        m2=pin.get_or_add_real("problem", "m2", 1.0),
    )


def _sphere_rho(X1, X2, X3, cx, cy, cz, rad, den, dx, xf, yf, zf):
    """One sphere's density, sub-sampled 10^3 across the surface band
    (binary_gravity.cpp:100-158)."""
    dd = 0.1 * dx
    dv = 1.0e-3
    dr = 0.6 * math.sqrt(3.0) * dx
    rr = np.sqrt((X1 - cx) ** 2 + (X2 - cy) ** 2 + (X3 - cz) ** 2)
    rho = np.zeros_like(X1)
    rho[rr < rad - dr] = den
    band = (rr < rad + dr) & (rr >= rad - dr)
    if band.any():
        off = (np.arange(10) + 0.5) * dd
        XX = xf[band][:, None] + off[None, :]
        YY = yf[band][:, None] + off[None, :]
        ZZ = zf[band][:, None] + off[None, :]
        r2 = ((XX[:, None, None, :] - cx) ** 2
              + (YY[:, None, :, None] - cy) ** 2
              + (ZZ[:, :, None, None] - cz) ** 2)
        rho[band] = dv * den * (r2 < rad * rad).sum(axis=(1, 2, 3))
    return rho


def init(pin, mesh, phys):
    p = _params(pin)
    eos = phys.eos
    den1 = p["m1"] / ((4.0 * math.pi / 3.0) * p["r"] ** 3)
    den2 = p["m2"] / ((4.0 * math.pi / 3.0) * p["r"] ** 3)
    four_pi_G = pin.get_or_add_real("problem", "four_pi_G", 1.0)
    pin.set_real("gravity", "four_pi_G", four_pi_G)
    if getattr(phys, "pgrav", None) is not None:
        phys.pgrav.four_pi_G = four_pi_G

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))
    total_mass = 0.0
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        x1f, x2f, x3f = mesh.face_edges(gid)
        dx = float(mesh.mb_size["dx1"][gid])
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        ZF, YF, XF = np.meshgrid(x3f[mbi.ks:mbi.ke + 1],
                                 x2f[mbi.js:mbi.je + 1],
                                 x1f[mbi.is_:mbi.is_ + mbi.nx1],
                                 indexing="ij")
        r1 = _sphere_rho(X1, X2, X3, p["x1"], p["y1"], p["z1"], p["r"],
                         den1, dx, XF, YF, ZF)
        r2 = _sphere_rho(X1, X2, X3, p["x2"], p["y2"], p["z2"], p["r"],
                         den2, dx, XF, YF, ZF)
        rho = np.maximum(np.full(X1.shape, _FLOOR_DEN), r1 + r2)
        u[gid, IDN][act] = rho
        if eos.is_ideal:
            u[gid, IEN][act] = rho
        vol = float(mesh.mb_size["dx1"][gid] * mesh.mb_size["dx2"][gid]
                    * mesh.mb_size["dx3"][gid])
        total_mass += rho.sum() * vol
    # the discrete mass renormalised to m1 + m2 (binary_gravity.cpp:169-205)
    fac = (p["m1"] + p["m2"]) / total_mass if total_mass > 0.0 else 1.0
    u[:, IDN] *= fac
    if eos.is_ideal:
        u[:, IEN] *= fac

    ut = to_device(phys, u)
    if getattr(phys, "is_mhd", False):
        bfc = {k: torch.zeros(s, dtype=phys.dtype, device=phys.device)
               for k, s in phys.fc_shapes.items()}
        bcc = phys.compute_bcc(bfc)
        w, ut, _ = phys.cons_to_prim(ut, bcc)
        return phys.make_state(ut, w, bfc, bcc=bcc)
    w, ut, _ = phys.cons_to_prim(ut)
    return phys.make_state(ut, w)


def final(pin, mesh, phys, state, phi=None):
    """BinaryGravityErrors (binary_gravity.cpp:240-385): the relative L2
    and maximum errors of phi and of the acceleration against the
    analytic two-sphere solution, from a fresh solve on the final state
    (or the interior-valid block potential ``phi``).  Prints and returns
    them; None without gravity."""
    pgrav = getattr(phys, "pgrav", None)
    if pgrav is None:
        return None
    p = _params(pin)
    G = pin.get_or_add_real("gravity", "four_pi_G", 1.0) / (4.0 * math.pi)
    den1 = p["m1"] / ((4.0 * math.pi / 3.0) * p["r"] ** 3)
    den2 = p["m2"] / ((4.0 * math.pi / 3.0) * p["r"] ** 3)
    if phi is None:
        phi = pgrav.solve(state["u"], phys.bvals)
    phi = phys.bvals.fill_ghosts(phi.clone())[:, 0].to(
        device="cpu", dtype=torch.float64).numpy()
    mbi = mesh.mb_indcs
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))
    pot_l1 = acc_l1 = 0.0
    pot_max = acc_max = 0.0
    for gid in range(mesh.nmb_total):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        dx = float(mesh.mb_size["dx1"][gid])
        dy = float(mesh.mb_size["dx2"][gid])
        dz = float(mesh.mb_size["dx3"][gid])
        vol = dx * dy * dz

        def single(cx, cy, cz, m, den):
            rr = np.sqrt((X1 - cx) ** 2 + (X2 - cy) ** 2 + (X3 - cz) ** 2)
            out_ = rr > p["r"]
            pot = np.where(out_, -G * m / np.maximum(rr, 1e-300),
                           -G * math.pi * 2.0 / 3.0 * den
                           * (3.0 * p["r"] ** 2 - rr ** 2))
            f = np.where(out_, -G * m / np.maximum(rr, 1e-300) ** 3,
                         -G * math.pi * 4.0 / 3.0 * den)
            return pot, f * (X1 - cx), f * (X2 - cy), f * (X3 - cz)

        p1, ax1, ay1, az1 = single(p["x1"], p["y1"], p["z1"], p["m1"], den1)
        p2, ax2, ay2, az2 = single(p["x2"], p["y2"], p["z2"], p["m2"], den2)
        pot0 = p1 + p2
        ax0, ay0, az0 = ax1 + ax2, ay1 + ay2, az1 + az2
        ph = phi[gid]
        ax_n = -(ph[act[0], act[1], mbi.is_ + 1:mbi.ie + 2]
                 - ph[act[0], act[1], mbi.is_ - 1:mbi.ie]) / (2.0 * dx)
        ay_n = -(ph[act[0], mbi.js + 1:mbi.je + 2, act[2]]
                 - ph[act[0], mbi.js - 1:mbi.je, act[2]]) / (2.0 * dy)
        az_n = -(ph[mbi.ks + 1:mbi.ke + 2, act[1], act[2]]
                 - ph[mbi.ks - 1:mbi.ke, act[1], act[2]]) / (2.0 * dz)
        perr = np.abs((pot0 - ph[act]) / pot0)
        a2 = ax0 ** 2 + ay0 ** 2 + az0 ** 2
        aerr = np.where(a2 > 0.0,
                        np.sqrt(((ax_n - ax0) ** 2 + (ay_n - ay0) ** 2
                                 + (az_n - az0) ** 2)
                                / np.maximum(a2, 1e-300)), 0.0)
        pot_l1 += float((perr * vol).sum())
        acc_l1 += float((aerr * vol).sum())
        pot_max = max(pot_max, float(perr.max()))
        acc_max = max(acc_max, float(aerr.max()))
    ms = mesh.mesh_size
    tvol = ((ms.x1max - ms.x1min) * (ms.x2max - ms.x2min)
            * (ms.x3max - ms.x3min))
    pot_l2 = math.sqrt(pot_l1 / tvol)
    acc_l2 = math.sqrt(acc_l1 / tvol)
    print("=====================================================")
    print(f"Potential    L2       : {pot_l2:.15e}")
    print(f"Acceleration L2       : {acc_l2:.15e}")
    print(f"Max Potential Error    : {pot_max:.15e}")
    print(f"Max Acceleration Error : {acc_max:.15e}")
    print("=====================================================")
    return {"pot_l2": pot_l2, "acc_l2": acc_l2,
            "pot_max": pot_max, "acc_max": acc_max}
