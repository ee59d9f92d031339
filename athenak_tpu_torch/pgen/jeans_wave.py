"""The Jeans wave and instability with self-gravity.

Counterpart of ``athenak_tpu/pgen/jeans_wave.py`` (reference:
src/pgen/tests/jeans_wave.cpp): a sinusoidal density perturbation along
the grid diagonal with the dispersion relation omega^2 = k^2 cs^2
(1 - n_jeans^2), four_pi_G set from problem/n_jeans, the Jeans-length
refinement criterion, and the ``final`` hook that projects the density
on the initial sin(kx) mode and prints the measured growth rate or
frequency.  Registered as ``jeans`` and ``gravity``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..comm import local_blocks
from ..indices import IDN, IEN, IVX, IVY, IVZ
from . import to_device

# the parameters init shares with the criterion and final (the
# reference's file-scope variables)
_P = {}


def init(pin, mesh, phys):
    use_mhd = getattr(phys, "is_mhd", False)
    eos = phys.eos
    four_pi_G = pin.get_or_add_real("gravity", "four_pi_G", 1.0)
    rho0 = pin.get_or_add_real("problem", "rho0", 1.0)
    n_jeans = pin.get_or_add_real("problem", "n_jeans", -1.0)
    amp = pin.get_or_add_real("problem", "amp", 1.0e-6)
    v0 = pin.get_or_add_real("problem", "v0", 0.0)
    if eos.is_ideal:
        p0 = pin.get_or_add_real("problem", "p0", 1.0)
        cs = math.sqrt(eos.gamma * p0 / rho0)
    else:
        p0 = None
        cs = eos.iso_cs

    ms = mesh.mesh_size
    lx1 = ms.x1max - ms.x1min
    lx2 = ms.x2max - ms.x2min
    lx3 = ms.x3max - ms.x3min
    ang_3 = math.atan(lx1 / lx2)
    sin_a3, cos_a3 = math.sin(ang_3), math.cos(ang_3)
    ang_2 = math.atan(0.5 * (lx1 * cos_a3 + lx2 * sin_a3) / lx3)
    sin_a2, cos_a2 = math.sin(ang_2), math.cos(ang_2)
    lam = min(lx1 * cos_a2 * cos_a3, lx2 * cos_a2 * sin_a3, lx3 * sin_a2)
    lam_jeans = lam / n_jeans if n_jeans > 0.0 else lam
    if n_jeans > 0.0:
        # k_J = n_jeans k through the effective G (jeans_wave.cpp:131-142)
        G = math.pi * cs * cs / (rho0 * lam_jeans * lam_jeans)
        four_pi_G = 4.0 * math.pi * G
        pin.set_real("gravity", "four_pi_G", four_pi_G)
        if getattr(phys, "pgrav", None) is not None:
            phys.pgrav.four_pi_G = four_pi_G
    k_wave = 2.0 * math.pi / lam
    omega2 = (k_wave * cs) ** 2 * (1.0 - n_jeans ** 2)
    omega = math.sqrt(abs(omega2))
    _P.update(rho0=rho0, amp=amp, k_wave=k_wave, omega=omega,
              n_jeans=n_jeans, cos_a2=cos_a2, cos_a3=cos_a3,
              sin_a2=sin_a2, sin_a3=sin_a3, v0=v0, cs=cs,
              four_pi_G=four_pi_G,
              njeans_amr=pin.get_or_add_real("problem", "njeans_amr", 16.0),
              njeans_deref=pin.get_or_add_real("problem",
                                               "njeans_derefine", 2.5))

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    u = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))
    is_unstable = n_jeans > 1.0
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        x = cos_a2 * (X1 * cos_a3 + X2 * sin_a3) + X3 * sin_a2
        sn = np.sin(k_wave * x)
        csx = np.cos(k_wave * x)
        M = (rho0 * (omega / k_wave) * amp * csx) if is_unstable else 0.0
        dens = rho0 * (1.0 + amp * sn + amp * amp * np.sin(X1 * k_wave))
        u[gid, IDN][act] = dens
        u[gid, IVX][act] = M * cos_a3 * cos_a2 + dens * v0 * cos_a3 * cos_a2
        u[gid, IVY][act] = M * sin_a3 * cos_a2 + dens * v0 * sin_a3 * cos_a2
        u[gid, IVZ][act] = M * sin_a2 + dens * v0 * sin_a2
        if eos.is_ideal:
            en = p0 / (eos.gamma - 1.0) * (1.0 + eos.gamma * amp * sn)
            en = en + 0.5 * (u[gid, IVX][act] ** 2 + u[gid, IVY][act] ** 2
                             + u[gid, IVZ][act] ** 2) / dens
            u[gid, IEN][act] = en

    phys.user_refine_func = _jeans_refinement
    if use_mhd:
        b0 = pin.get_or_add_real("problem", "b0", 0.0)
        bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
        bfc["x1f"][:] = b0
        if eos.is_ideal:
            u[:, IEN] += 0.5 * b0 * b0
        bfct = {k: to_device(phys, v) for k, v in bfc.items()}
        bcc = phys.compute_bcc(bfct)
        w, ut, _ = phys.cons_to_prim(to_device(phys, u), bcc)
        return phys.make_state(ut, w, bfct, bcc=bcc)
    w, ut, _ = phys.cons_to_prim(to_device(phys, u))
    return phys.make_state(ut, w)


def _jeans_refinement(state, mesh):
    """nJ = 2 pi cs / (dx sqrt(4 pi G rho_max)) a block: refine below
    problem/njeans_amr, derefine above njeans_amr * njeans_derefine
    (jeans_wave.cpp JeansWaveRefinement).  The flags of the state's
    blocks (one rank's rows under ranks: the cell sizes are read through
    ``local_blocks``)."""
    mbi = mesh.mb_indcs
    rho = state["u"][:, IDN, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                     mbi.is_:mbi.ie + 1]
    rho_max = rho.amax(dim=(1, 2, 3)).cpu().numpy()
    dx = np.asarray(local_blocks(mesh.mb_size["dx1"]))
    nj = 2.0 * math.pi * _P["cs"] / (dx * np.sqrt(_P["four_pi_G"]
                                                  * rho_max))
    flags = np.zeros(rho.shape[0], dtype=np.int64)
    flags[nj < _P["njeans_amr"]] = 1
    flags[nj > _P["njeans_amr"] * _P["njeans_deref"]] = -1
    return flags


def final(pin, mesh, phys, state):
    """Project the density perturbation on sin(kx) and print the
    measured against the analytic omega (jeans_wave.cpp
    JeansWaveErrors); returns them."""
    p = _P
    mbi = mesh.mb_indcs
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.ie + 1))
    t = mesh.time
    sin_proj = 0.0
    rho = state["u"][:, IDN].to(device="cpu", dtype=torch.float64).numpy()
    for gid in range(mesh.nmb_total):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        x = (p["cos_a2"] * (X1 * p["cos_a3"] + X2 * p["sin_a3"])
             + X3 * p["sin_a2"])
        vol = float(mesh.mb_size["dx1"][gid] * mesh.mb_size["dx2"][gid]
                    * mesh.mb_size["dx3"][gid])
        sin_proj += float(np.sum((rho[gid][act] / p["rho0"] - 1.0)
                                 * np.sin(p["k_wave"]
                                          * (x - p["v0"] * t)))) * vol
    ms = mesh.mesh_size
    tvol = ((ms.x1max - ms.x1min) * (ms.x2max - ms.x2min)
            * (ms.x3max - ms.x3min))
    a_sin = 2.0 * sin_proj / tvol
    if p["n_jeans"] > 1.0:
        omega_measured = math.log(abs(a_sin) / p["amp"]) / t
    else:
        clamped = max(-1.0, min(1.0, a_sin / p["amp"]))
        omega_measured = math.acos(clamped) / t
    print("=====================================================")
    print(f"Jeans wave mode amplitude  : {a_sin:.15e}")
    print(f"Jeans wave growth (A/amp)  : {a_sin / p['amp']:.15e}")
    print(f"Jeans wave omega measured  : {omega_measured:.15e}")
    print(f"Jeans wave omega analytical: {p['omega']:.15e}")
    print("=====================================================")
    return {"omega_measured": omega_measured, "omega": p["omega"],
            "a_sin": a_sin}
