"""The radiation-hydro linear wave (a damped radiation-acoustic
eigenmode).

Counterpart of ``athenak_tpu/pgen/rad_linear_wave.py`` (reference:
src/pgen/tests/rad_linear_wave.cpp): the eigensystem (the complex
frequency and amplitudes) comes from the deck; the intensities are made
from the fluid-frame moments with the reference's linear closure; at the
end the errors against the analytically damped solution go to the error
file.  ``<time>/tlim`` counts damping times.  The state is built in
float64 on the run's device and kept at its dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..indices import IDN, IEN, IVX, IVY, IVZ
from . import errors as err_mod
from .rad_beam import cell_coords

_EIG_KEYS = [
    ("omega_real", True), ("omega_imag", True), ("rho", True),
    ("pgas", True), ("ux", False), ("uy", False), ("uz", False),
    ("erad", True), ("fxrad", False), ("fyrad", False), ("fzrad", False),
    ("delta", True), ("drho_real", True), ("drho_imag", True),
    ("dpgas_real", True), ("dpgas_imag", True),
    ("dux_real", True), ("dux_imag", True),
    ("duy_real", False), ("duy_imag", False),
    ("duz_real", False), ("duz_imag", False),
    ("derad_real", True), ("derad_imag", True),
    ("dfxrad_real", True), ("dfxrad_imag", True),
    ("dfyrad_real", False), ("dfyrad_imag", False),
    ("dfzrad_real", False), ("dfzrad_imag", False)]


def _read_eig(pin):
    return {key: pin.get_real("problem", key) if required
            else pin.get_or_add_real("problem", key, 0.0)
            for key, required in _EIG_KEYS}


def _wave_geometry(pin, mesh):
    along_x1 = pin.get_or_add_boolean("problem", "along_x1", False)
    ms = mesh.mesh_size
    x1s, x2s, x3s = (ms.x1max - ms.x1min, ms.x2max - ms.x2min,
                     ms.x3max - ms.x3min)
    cos_a3, sin_a3, cos_a2, sin_a2 = 1.0, 0.0, 1.0, 0.0
    if mesh.multi_d and not along_x1:
        a3 = math.atan(x1s / x2s)
        sin_a3, cos_a3 = math.sin(a3), math.cos(a3)
    if mesh.three_d and not along_x1:
        a2 = math.atan(0.5 * (x1s * cos_a3 + x2s * sin_a3) / x3s)
        sin_a2, cos_a2 = math.sin(a2), math.cos(a2)
    lam = float(np.finfo(np.float32).max)
    if cos_a2 * cos_a3 > 0.0:
        lam = min(lam, x1s * cos_a2 * cos_a3)
    if cos_a2 * sin_a3 > 0.0:
        lam = min(lam, x2s * cos_a2 * sin_a3)
    if sin_a2 > 0.0:
        lam = min(lam, x3s * sin_a2)
    return cos_a2, sin_a2, cos_a3, sin_a3, 2.0 * math.pi / lam


def _fluid_w(pin, mesh, phys, eig, tf):
    """The primitives of the damped eigenmode at time tf (float64)."""
    cos_a2, sin_a2, cos_a3, sin_a3, k_par = _wave_geometry(pin, mesh)
    X, Y, Z = cell_coords(phys.rad)
    x = cos_a2 * (X * cos_a3 + Y * sin_a3) + Z * sin_a2
    sn = torch.sin(eig["omega_real"] * tf - k_par * x)
    cn = torch.cos(eig["omega_real"] * tf - k_par * x)
    d = eig["delta"] * math.exp(eig["omega_imag"] * tf)
    rho = eig["rho"] + d * (eig["drho_real"] * cn + eig["drho_imag"] * sn)
    pg = eig["pgas"] + d * (eig["dpgas_real"] * cn
                            + eig["dpgas_imag"] * sn)
    ux = eig["ux"] + d * (eig["dux_real"] * cn + eig["dux_imag"] * sn)
    uy = eig["uy"] + d * (eig["duy_real"] * cn + eig["duy_imag"] * sn)
    uz = eig["uz"] + d * (eig["duz_real"] * cn + eig["duz_imag"] * sn)
    w = torch.zeros(phys.shape, dtype=torch.float64, device=phys.device)
    w[:, IDN] = rho
    w[:, IVX] = ux * cos_a2 * cos_a3 - uy * sin_a3 - uz * sin_a2 * cos_a3
    w[:, IVY] = ux * cos_a2 * sin_a3 + uy * cos_a3 - uz * sin_a2 * sin_a3
    w[:, IVZ] = ux * sin_a2 + uz * cos_a2
    w[:, IEN] = pg / (phys.eos.gamma - 1.0)
    return w


def _boost(lmb, r):
    return [[sum(lmb[a][mu] * lmb[b][nu] * r[mu][nu]
                 for mu in range(4) for nu in range(4))
             for b in range(4)] for a in range(4)]


def _intensities(pin, mesh, phys, eig):
    """i0 from the fluid-frame moments with the reference's linear
    closure (reference: rad_linear_wave.cpp:250-485), float64."""
    rad = phys.rad
    cos_a2, sin_a2, cos_a3, sin_a3, k_par = _wave_geometry(pin, mesh)
    X, Y, Z = cell_coords(rad)
    x = cos_a2 * (X * cos_a3 + Y * sin_a3) + Z * sin_a2
    sn, cn = torch.sin(k_par * x), torch.cos(k_par * x)
    d = eig["delta"]

    uw = [None] * 4
    uw[1] = eig["ux"] + d * (eig["dux_real"] * cn - eig["dux_imag"] * sn)
    uw[2] = eig["uy"] + d * (eig["duy_real"] * cn - eig["duy_imag"] * sn)
    uw[3] = eig["uz"] + d * (eig["duz_real"] * cn - eig["duz_imag"] * sn)
    uw[0] = torch.sqrt(1.0 + uw[1] ** 2 + uw[2] ** 2 + uw[3] ** 2)
    u = [uw[0],
         uw[1] * cos_a2 * cos_a3 - uw[2] * sin_a3 - uw[3] * sin_a2 * cos_a3,
         uw[1] * cos_a2 * sin_a3 + uw[2] * cos_a3 - uw[3] * sin_a2 * sin_a3,
         uw[1] * sin_a2 + uw[3] * cos_a2]

    # the fluid-frame (wave-aligned) moments with the Eddington closure
    rf = [[None] * 4 for _ in range(4)]
    rf[0][0] = eig["erad"] + d * (eig["derad_real"] * cn
                                  - eig["derad_imag"] * sn)
    for c, key in ((1, "x"), (2, "y"), (3, "z")):
        rf[0][c] = eig[f"f{key}rad"] + d * (eig[f"df{key}rad_real"] * cn
                                            - eig[f"df{key}rad_imag"] * sn)
    third = rf[0][0] / 3.0
    for a in range(1, 4):
        for b in range(1, 4):
            rf[a][b] = third if a == b else 0.0 * third
        rf[a][0] = rf[0][a]

    def lorentz(uvec, sign):
        lam = [[None] * 4 for _ in range(4)]
        lam[0][0] = uvec[0]
        for a in range(1, 4):
            lam[0][a] = lam[a][0] = sign * uvec[a]
            for b in range(1, 4):
                lam[a][b] = (1.0 if a == b else 0.0) \
                    + uvec[a] * uvec[b] / (1.0 + uvec[0])
        return lam

    # boost in the wave frame, then rotate the tensor's indices to the
    # coordinate axes
    r_wave = _boost(lorentz(uw, 1.0), rf)
    rot = [[cos_a2 * cos_a3, -sin_a3, -sin_a2 * cos_a3],
           [cos_a2 * sin_a3, cos_a3, -sin_a2 * sin_a3],
           [sin_a2, 0.0, cos_a2]]
    R = [[None] * 4 for _ in range(4)]
    R[0][0] = r_wave[0][0]
    for i in range(3):
        R[0][i + 1] = sum(rot[i][j] * r_wave[0][j + 1] for j in range(3))
        R[i + 1][0] = R[0][i + 1]
        for j in range(3):
            R[i + 1][j + 1] = sum(rot[i][p] * rot[j][q]
                                  * r_wave[p + 1][q + 1]
                                  for p in range(3) for q in range(3))
    # coordinate frame -> fluid frame
    rfl = _boost(lorentz(u, -1.0), R)

    ee = rfl[0][0]
    ffv = [rfl[0][1], rfl[0][2], rfl[0][3]]
    ff = torch.sqrt(ffv[0] ** 2 + ffv[1] ** 2 + ffv[2] ** 2)
    f_f = ff / ee
    fdir = [torch.where(ff > 0, c / torch.clamp(ff, min=1e-300), 0.0)
            for c in ffv]

    # the fluid velocity in the tetrad frame (the normal and coordinate
    # frames coincide in these tests' flat metric)
    f64 = torch.float64
    n0, n_0, _, n2t = rad.tet_quantities()
    comps = (u[0], u[1], u[2], u[3])
    ut = [sum(n2t[a][nu].to(f64) * comps[nu] for nu in range(4))
          for a in range(4)]
    nh = rad.nh4
    i0 = torch.zeros(rad.shape, dtype=f64, device=rad.device)
    n00 = n0[:, 0].to(f64)
    for n in range(rad.nangles):
        un_t = ut[1] * nh[n, 1] + ut[2] * nh[n, 2] + ut[3] * nh[n, 3]
        n0_f = ut[0] * nh[n, 0] - un_t
        nf = [(-ut[c] * nh[n, 0] + ut[c] / (ut[0] + 1.0) * un_t
               + nh[n, c]) for c in (1, 2, 3)]
        fn_f = sum(fdir[c] * nf[c] for c in range(3))
        ii_f = torch.where(
            f_f <= 1.0 / 3.0,
            ee / (4.0 * math.pi) * (1.0 + 3.0 * f_f * fn_f),
            ee / (9.0 * math.pi) * (fn_f - 3.0 * f_f + 2.0)
            / torch.clamp((1.0 - f_f) ** 2, min=1e-300))
        i0[:, n] = n00 * n_0[:, n].to(f64) * ii_f / n0_f ** 4
    return i0


def init(pin, mesh, phys):
    eig = _read_eig(pin)
    # tlim counts damping times
    tlim = pin.get_real("time", "tlim")
    pin.set_real("time", "tlim",
                 tlim * math.log(2.0) / abs(eig["omega_imag"]))
    w = _fluid_w(pin, mesh, phys, eig, 0.0).to(phys.dtype)
    i0 = _intensities(pin, mesh, phys, eig).to(phys.dtype)
    return phys.make_state(phys.prim_to_cons(w), w, i0)


def final(pin, mesh, phys, state):
    """The errors against the analytically damped solution at tf."""
    eig = _read_eig(pin)
    w_ref = _fluid_w(pin, mesh, phys, eig, mesh.time).to(state["u"].dtype)
    u_ref = phys.prim_to_cons(w_ref)
    l1, linf = err_mod.compute_errors(mesh, state["u"], u_ref, 5)
    err_mod.write_error_file(pin, mesh, l1, linf,
                             ["d", "M1", "M2", "M3", "E"])
    return l1, linf
