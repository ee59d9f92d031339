"""Linear wave (hydro; the MHD branch is in ``linear_wave_mhd.py``).

Counterpart of ``athenak_tpu/pgen/linear_wave.py`` (reference:
src/pgen/tests/linear_wave.cpp): the eigensystem in primitive variables
(Athena 2008 ApJS 178, 137, appendix B), the automatic diagonal
wavevector, ``time/tlim`` read as a number of wave periods, and at the
end of the run the L1-error file against the initial condition.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVX, IVY, IVZ
from . import errors as err_mod
from . import state_from_prims, to_device


def _hydro_eigensystem(d, v1, p, eos):
    """Eigenvalues and right eigenvectors (columns) in primitives
    (reference: linear_wave.cpp HydroEigensystemPrim)."""
    if eos.is_ideal:
        a = math.sqrt(eos.gamma * p / d)
        ev = np.array([v1 - a, v1, v1, v1, v1 + a])
        rem = np.zeros((5, 5))
        rem[:, 0] = [1.0, -a / d, 0.0, 0.0, a * a]
        rem[:, 1] = [1.0, 0.0, 0.0, 0.0, 0.0]
        rem[:, 2] = [0.0, 0.0, 1.0, 0.0, 0.0]
        rem[:, 3] = [0.0, 0.0, 0.0, 1.0, 0.0]
        rem[:, 4] = [1.0, a / d, 0.0, 0.0, a * a]
        return ev, rem
    cs = eos.iso_cs
    ev = np.array([v1 - cs, v1, v1, v1 + cs])
    rem = np.zeros((4, 4))
    rem[:, 0] = [1.0, -cs / d, 0.0, 0.0]
    rem[:, 1] = [0.0, 0.0, 1.0, 0.0]
    rem[:, 2] = [0.0, 0.0, 0.0, 1.0]
    rem[:, 3] = [1.0, cs / d, 0.0, 0.0]
    return ev, rem


def wave_geometry(pin, mesh):
    """The wavevector's angles and the parallel wavelength (reference
    logic): (cos_a2, sin_a2, cos_a3, sin_a3, lx, k_par)."""
    along_x1 = pin.get_or_add_boolean("problem", "along_x1", False)
    along_x2 = pin.get_or_add_boolean("problem", "along_x2", False)
    along_x3 = pin.get_or_add_boolean("problem", "along_x3", False)

    ms = mesh.mesh_size
    x1size = ms.x1max - ms.x1min
    x2size = ms.x2max - ms.x2min
    x3size = ms.x3max - ms.x3min

    cos_a3, sin_a3, cos_a2, sin_a2 = 1.0, 0.0, 1.0, 0.0
    if mesh.multi_d and not along_x1:
        ang_3 = math.atan(x1size / x2size)
        sin_a3, cos_a3 = math.sin(ang_3), math.cos(ang_3)
    if mesh.three_d and not along_x1:
        ang_2 = math.atan(0.5 * (x1size * cos_a3 + x2size * sin_a3)
                          / x3size)
        sin_a2, cos_a2 = math.sin(ang_2), math.cos(ang_2)
    if along_x2:
        cos_a3, sin_a3, cos_a2, sin_a2 = 0.0, 1.0, 1.0, 0.0
    if along_x3:
        cos_a3, sin_a3, cos_a2, sin_a2 = 0.0, 1.0, 0.0, 1.0

    lx = float(np.finfo(np.float32).max)
    if cos_a2 * cos_a3 > 0.0:
        lx = min(lx, x1size * cos_a2 * cos_a3)
    if cos_a2 * sin_a3 > 0.0:
        lx = min(lx, x2size * cos_a2 * sin_a3)
    if sin_a2 > 0.0:
        lx = min(lx, x3size * sin_a2)
    return cos_a2, sin_a2, cos_a3, sin_a3, lx, 2.0 * math.pi / lx


def _build_w(pin, mesh, phys, rescale_tlim: bool):
    """Host primitives of the hydro linear wave."""
    eos = phys.eos
    cos_a2, sin_a2, cos_a3, sin_a3, lx, k_par = wave_geometry(pin, mesh)
    wave_flag = pin.get_integer("problem", "wave_flag")
    amp = pin.get_real("problem", "amp")
    d0 = pin.get_real("problem", "dens")
    p0 = pin.get_real("problem", "pgas")
    vx0 = pin.get_or_add_real("problem", "vx0", 0.0)
    ev, rem = _hydro_eigensystem(d0, vx0, p0, eos)
    if rescale_tlim:
        tlim = pin.get_real("time", "tlim")
        pin.set_real("time", "tlim", tlim * abs(lx / ev[wave_flag]))

    mbi = mesh.mb_indcs
    w = np.zeros((mesh.nmb_total, phys.nvar, mbi.ncells3, mbi.ncells2,
                  mbi.ncells1))
    gm1 = eos.gamma - 1.0
    a = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
         slice(mbi.is_, mbi.ie + 1))
    for gid in range(mesh.nmb_total):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[mbi.ks:mbi.ke + 1],
                                 x2v[mbi.js:mbi.je + 1],
                                 x1v[mbi.is_:mbi.ie + 1], indexing="ij")
        x = cos_a2 * (X1 * cos_a3 + X2 * sin_a3) + X3 * sin_a2
        sn = np.sin(k_par * x)
        rho = d0 + amp * sn * rem[0, wave_flag]
        vx = vx0 + amp * sn * rem[1, wave_flag]
        vy = amp * sn * rem[2, wave_flag]
        vz = amp * sn * rem[3, wave_flag]
        w[gid, IDN][a] = rho
        w[gid, IVX][a] = (vx * cos_a2 * cos_a3 - vy * sin_a3
                          - vz * sin_a2 * cos_a3)
        w[gid, IVY][a] = (vx * cos_a2 * sin_a3 + vy * cos_a3
                          - vz * sin_a2 * sin_a3)
        w[gid, IVZ][a] = vx * sin_a2 + vz * cos_a2
        if eos.is_ideal:
            w[gid, IEN][a] = (p0 + amp * sn * rem[4, wave_flag]) / gm1
    return w


def init(pin, mesh, phys):
    if getattr(phys, "is_mhd", False):
        from .linear_wave_mhd import init_mhd
        return init_mhd(pin, mesh, phys)
    return state_from_prims(phys, _build_w(pin, mesh, phys,
                                           rescale_tlim=True))


def final(pin, mesh, phys, state):
    """The analytic solution (the initial condition after whole periods)
    and the L1-error file (reference: LinearWaveErrors); returns
    (l1, linf)."""
    if getattr(phys, "is_mhd", False):
        from .linear_wave_mhd import final_mhd
        return final_mhd(pin, mesh, phys, state)
    w_ref = to_device(phys, _build_w(pin, mesh, phys, rescale_tlim=False))
    u_ref = phys.prim_to_cons(w_ref)
    l1, linf = err_mod.compute_errors(mesh, state["u"], u_ref, phys.nhydro)
    header = ["d", "M1", "M2", "M3"] + (["E"] if phys.eos.is_ideal else [])
    err_mod.write_error_file(pin, mesh, l1, linf, header)
    return l1, linf
