"""Explicit diffusion: viscosity, thermal conduction, Ohmic and
ambipolar resistivity.

Counterpart of ``athenak_tpu/diffusion.py`` (reference:
src/diffusion/viscosity.cpp:30-251, conduction.cpp:65-379,
resistivity.cpp:28-364, ambipolar.cpp, current_density.hpp).  Every
operator is a whole-array roll stencil in torch ops on the cell-indexed
layout of the fluxes and EMFs (entry i is the lower face or edge of cell
i); the diffusive fluxes are added into the Godunov fluxes and the
resistive EMFs into the corner EMFs, so the RK and CT updates apply them
as they are.  The wrap of a roll lands in ghost cells, which the fill
rewrites.  The cell sizes are scalars on one level and per-block
[nmb, 1, 1, 1] tensors on a refined mesh (the physics' ``dxs``); the
explicit time-step limits take the finest spacing.  No kernel: the JAX
package computes these in jnp ops outside its Pallas kernels, and a
deck with any of them closes the stage kernels A, C and E (and D with
resistivity, whose EMFs D has no room for).
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import LocalAttr
from .indices import IDN, IEN, IVX, IVY, IVZ

_HUGE = float(np.finfo(np.float32).max)

# axes of the 4-D per-channel arrays [nmb, n3, n2, n1]
_KA, _JA, _IA = 1, 2, 3
_AX4 = {"x1": _IA, "x2": _JA, "x3": _KA}


def _m1(a, ax):
    """a at index - 1 (circular; the wrap lands in ghosts)."""
    return torch.roll(a, 1, dims=ax)


def _p1(a, ax):
    return torch.roll(a, -1, dims=ax)


def _dt_fac(ndim: int) -> float:
    """The explicit diffusion CFL prefactor (reference:
    viscosity.cpp:234-240)."""
    return {1: 0.5, 2: 0.25, 3: 1.0 / 6.0}[ndim]


def _dx_min(mesh, name: str) -> float:
    """The finest spacing along an axis."""
    if mesh.multilevel:
        return float(np.min(mesh.mb_size[f"d{name}"]))
    return getattr(mesh.mesh_size, f"d{name}")


def _dt_limit(mesh, ndim: int, coef: float) -> float:
    """min over the active axes of fac dx_min^2 / coef, in float64."""
    fac = _dt_fac(ndim)
    dt = fac * _dx_min(mesh, "x1") ** 2 / coef
    if ndim > 1:
        dt = min(dt, fac * _dx_min(mesh, "x2") ** 2 / coef)
    if ndim > 2:
        dt = min(dt, fac * _dx_min(mesh, "x3") ** 2 / coef)
    return dt


class _LocalDx:
    """The physics' cell sizes as the running cycle's rows."""

    dxs = LocalAttr()


def _scalar(v, like):
    """A host number as a 0-d tensor beside ``like``, filled in on the
    device (no host copy, which a CUDA graph of the cycle cannot hold)."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


class Viscosity(_LocalDx):
    """Isotropic shear viscosity (reference:
    src/diffusion/viscosity.cpp)."""

    def __init__(self, block: str, pin, mesh, eos, dxs) -> None:
        self.mesh = mesh
        self.eos = eos
        self.dxs = dxs
        self.nu_iso = pin.get_or_add_real(block, "nu_iso", 0.0)
        self.nu_aniso = pin.get_or_add_real(block, "nu_aniso", 0.0)

    def add_viscous_flux(self, w, flx, dirs):
        """The fluxes plus the viscous momentum and energy fluxes
        (reference: viscosity.cpp:64-214): normal derivatives are
        two-point face differences, transverse ones the mean of the two
        adjacent cells' central differences.  ``dirs`` is the physics'
        (name, axis, ivx, dx) list."""
        if self.nu_iso == 0.0:
            return flx
        nu = self.nu_iso
        active = {name for name, *_ in dirs}
        vel = {"x1": w[:, IVX], "x2": w[:, IVY], "x3": w[:, IVZ]}
        iv = {"x1": IVX, "x2": IVY, "x3": IVZ}
        dxs = self.dxs
        dens = w[:, IDN]
        out = dict(flx)
        for n in active:
            a_n = _AX4[n]
            dn = dxs[n]
            trans = [t for t in ("x1", "x2", "x3") if t != n and t in active]

            def face_avg_ddt(comp, t):
                """d(comp)/d(t) at the n-face: the mean of the central
                differences of the two cells sharing the face."""
                a_t = _AX4[t]
                c = vel[comp]
                cm = _m1(c, a_n)
                return ((_p1(c, a_t) + _p1(cm, a_t))
                        - (_m1(c, a_t) + _m1(cm, a_t))) / (4.0 * dxs[t])

            # tau_nn = 4/3 dvn/dn - 2/3 sum_t dvt/dt; tau_tn = dvt/dn + dvn/dt
            f = {n: 4.0 * (vel[n] - _m1(vel[n], a_n)) / (3.0 * dn)}
            for t in trans:
                f[n] = f[n] - (2.0 / 3.0) * face_avg_ddt(t, t)
                f[t] = (vel[t] - _m1(vel[t], a_n)) / dn + face_avg_ddt(n, t)
            # components with no active transverse axis diffuse along n
            for t in ("x1", "x2", "x3"):
                if t not in f:
                    f[t] = (vel[t] - _m1(vel[t], a_n)) / dn
            nud = 0.5 * nu * (dens + _m1(dens, a_n))
            fl = out[n].clone()
            for comp in ("x1", "x2", "x3"):
                fl[:, iv[comp]] += -nud * f[comp]
            if self.eos.is_ideal:
                en = None
                for comp in ("x1", "x2", "x3"):
                    term = (_m1(vel[comp], a_n) + vel[comp]) * f[comp]
                    en = term if en is None else en + term
                fl[:, IEN] += -0.5 * nud * en
            out[n] = fl
        return out

    def new_dt(self, ndim: int, like):
        """fac dx^2 / nu_iso, as a 0-d tensor like ``like``."""
        if self.nu_iso == 0.0:
            return _scalar(_HUGE, like)
        return _scalar(_dt_limit(self.mesh, ndim, self.nu_iso), like)


class Conduction(_LocalDx):
    """Isotropic thermal conduction, q = -alpha rho dT/dx (reference:
    src/diffusion/conduction.cpp:65-152); alpha is a diffusivity, the
    conductivity kappa = rho alpha.  Spitzer conduction is commented out
    in the reference and raises, as in the JAX package."""

    def __init__(self, block: str, pin, mesh, eos, dxs) -> None:
        self.mesh = mesh
        self.eos = eos
        self.dxs = dxs
        if not eos.is_ideal:
            raise ValueError("thermal conduction requires ideal gas EOS")
        self.alpha_iso = pin.get_or_add_real(block, "alpha_iso", 0.0)
        self.alpha_aniso = pin.get_or_add_real(block, "alpha_aniso", 0.0)
        if pin.get_or_add_boolean(block, "alpha_spitzer", False):
            raise NotImplementedError(
                "Spitzer conduction is disabled in the reference snapshot "
                "(reference: conduction.cpp:168-230 commented out)")

    def add_heat_flux(self, w, flx, dirs):
        if self.alpha_iso == 0.0:
            return flx
        gm1 = self.eos.gamma - 1.0
        temp = w[:, IEN] / w[:, IDN]
        dens = w[:, IDN]
        out = dict(flx)
        for name, _axis, _ivx, _dx in dirs:
            a = _AX4[name]
            dtempdx = (temp - _m1(temp, a)) * gm1 / self.dxs[name]
            densf = 0.5 * (dens + _m1(dens, a))
            fl = out[name].clone()
            fl[:, IEN] += -self.alpha_iso * densf * dtempdx
            out[name] = fl
        return out

    def new_dt(self, ndim: int, like):
        if self.alpha_iso == 0.0:
            return _scalar(_HUGE, like)
        return _scalar(_dt_limit(self.mesh, ndim, self.alpha_iso), like)


def _faces(bfc):
    """The face fields at cell index (entry i is the lower face)."""
    return (bfc["x1f"][..., :-1], bfc["x2f"][..., :-1, :],
            bfc["x3f"][:, :-1, :, :])


class Resistivity(_LocalDx):
    """Ohmic resistivity and ambipolar diffusion with constant
    coefficients (reference: src/diffusion/resistivity.cpp,
    ambipolar.cpp)."""

    def __init__(self, pin, mesh, eos, dxs) -> None:
        self.mesh = mesh
        self.eos = eos
        self.dxs = dxs
        self.eta_ohm = pin.get_or_add_real("mhd", "eta_ohm", 0.0)
        self.eta_ad = pin.get_or_add_real("mhd", "eta_ad", 0.0)

    def edge_currents(self, bfc, ndim: int):
        """The edge-centred current density from the curl of the face
        field (reference: src/diffusion/current_density.hpp); entry
        (k, j, i) is the edge at the lower corner of cell (k, j, i)."""
        dxs = self.dxs
        b1, b2, b3 = _faces(bfc)
        # J1 = dB3/dx2 - dB2/dx3 at (i, j-1/2, k-1/2)
        j1 = torch.zeros_like(b1)
        if ndim > 1:
            j1 = j1 + (b3 - _m1(b3, _JA)) / dxs["x2"]
        if ndim > 2:
            j1 = j1 - (b2 - _m1(b2, _KA)) / dxs["x3"]
        # J2 = dB1/dx3 - dB3/dx1 at (i-1/2, j, k-1/2)
        j2 = -(b3 - _m1(b3, _IA)) / dxs["x1"]
        if ndim > 2:
            j2 = j2 + (b1 - _m1(b1, _KA)) / dxs["x3"]
        # J3 = dB2/dx1 - dB1/dx2 at (i-1/2, j-1/2, k)
        j3 = (b2 - _m1(b2, _IA)) / dxs["x1"]
        if ndim > 1:
            j3 = j3 - (b1 - _m1(b1, _JA)) / dxs["x2"]
        return j1, j2, j3

    def add_resistive_emf(self, bfc, bcc, e1, e2, e3, ndim: int):
        """E + eta_ohm J + eta_ad [B^2 J - (J.B) B] at the cell edges
        (reference: resistivity.cpp:80-184, ambipolar.cpp:57-235)."""
        if self.eta_ohm == 0.0 and self.eta_ad == 0.0:
            return e1, e2, e3
        j1, j2, j3 = self.edge_currents(bfc, ndim)
        if self.eta_ohm != 0.0:
            e1 = e1 + self.eta_ohm * j1
            e2 = e2 + self.eta_ohm * j2
            e3 = e3 + self.eta_ohm * j3
        if self.eta_ad == 0.0:
            return e1, e2, e3
        eta = self.eta_ad
        b1, b2, b3 = _faces(bfc)
        bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]

        def avg4(a, axa, axb):
            return 0.25 * (a + _m1(a, axa) + _m1(a, axb)
                           + _m1(_m1(a, axa), axb))

        def edge_avg4(j, axa, axb):
            """An edge-centred J averaged onto another edge (reference:
            ambipolar.cpp:178-185)."""
            return 0.25 * (j + _p1(j, axa) + _m1(j, axb)
                           + _p1(_m1(j, axb), axa))

        # e1 edges (i, j-1/2, k-1/2)
        intj2 = edge_avg4(j2, _IA, _JA)
        intj3 = edge_avg4(j3, _IA, _KA)
        ibx = avg4(bx, _JA, _KA)
        iby = 0.5 * (b2 + _m1(b2, _KA))
        ibz = 0.5 * (b3 + _m1(b3, _JA))
        bsq = ibx * ibx + iby * iby + ibz * ibz
        jdb = j1 * ibx + intj2 * iby + intj3 * ibz
        e1 = e1 + eta * (bsq * j1 - jdb * ibx)
        # e2 edges (i-1/2, j, k-1/2)
        intj1 = edge_avg4(j1, _JA, _IA)
        intj3 = edge_avg4(j3, _JA, _KA)
        ibx2 = 0.5 * (b1 + _m1(b1, _KA))
        iby2 = avg4(by, _IA, _KA)
        ibz2 = 0.5 * (b3 + _m1(b3, _IA))
        bsq = ibx2 * ibx2 + iby2 * iby2 + ibz2 * ibz2
        jdb = intj1 * ibx2 + j2 * iby2 + intj3 * ibz2
        e2 = e2 + eta * (bsq * j2 - jdb * iby2)
        # e3 edges (i-1/2, j-1/2, k)
        intj1 = edge_avg4(j1, _KA, _IA)
        intj2 = edge_avg4(j2, _KA, _JA)
        ibx3 = 0.5 * (b1 + _m1(b1, _JA))
        iby3 = 0.5 * (b2 + _m1(b2, _IA))
        ibz3 = avg4(bz, _IA, _JA)
        bsq = ibx3 * ibx3 + iby3 * iby3 + ibz3 * ibz3
        jdb = intj1 * ibx3 + intj2 * iby3 + j3 * ibz3
        e3 = e3 + eta * (bsq * j3 - jdb * ibz3)
        return e1, e2, e3

    def add_resistive_flux(self, bfc, bcc, flx, dirs, ndim: int):
        """The Poynting energy flux of the resistive EMFs, F = (eta J) x B
        (reference: resistivity.cpp:191-280, ambipolar.cpp:248-330): the
        edge EMFs averaged to the faces and crossed with the face field."""
        if (self.eta_ohm == 0.0 and self.eta_ad == 0.0) \
                or not self.eos.is_ideal:
            return flx
        j1, j2, j3 = self.edge_currents(bfc, ndim)
        b1, b2, b3 = _faces(bfc)
        if self.eta_ohm != 0.0:
            re1, re2, re3 = (self.eta_ohm * j1, self.eta_ohm * j2,
                             self.eta_ohm * j3)
        else:
            z = torch.zeros_like(j1)
            re1, re2, re3 = z, z, z
        if self.eta_ad != 0.0:
            # B^2 at the edges by the EMF's interpolation (reference:
            # ambipolar.cpp:243-246)
            bsq_c = bcc[:, 0] ** 2 + bcc[:, 1] ** 2 + bcc[:, 2] ** 2

            def to_edge(axa, axb):
                return 0.25 * (bsq_c + _m1(bsq_c, axa) + _m1(bsq_c, axb)
                               + _m1(_m1(bsq_c, axa), axb))

            re1 = re1 + self.eta_ad * to_edge(_JA, _KA) * j1
            re2 = re2 + self.eta_ad * to_edge(_KA, _IA) * j2
            re3 = re3 + self.eta_ad * to_edge(_IA, _JA) * j3

        def face_avg(re, b, ax_e, ax_b):
            """0.5 (re (b + b[-1 along ax_b]) + re[+1 along ax_e] (...))."""
            bp = _p1(b, ax_e)
            return 0.5 * (re * (b + _m1(b, ax_b))
                          + _p1(re, ax_e) * (bp + _m1(bp, ax_b)))

        out = dict(flx)
        active = {name for name, *_ in dirs}
        # x1 faces: F1 = E2 B3 - E3 B2
        e2f = face_avg(re2, b3, _KA, _IA)
        e3f = face_avg(re3, b2, _JA, _IA)
        fl = out["x1"].clone()
        fl[:, IEN] += 0.5 * (e2f - e3f)
        out["x1"] = fl
        if "x2" in active:
            e3f = face_avg(re3, b1, _IA, _JA)
            e1f = face_avg(re1, b3, _KA, _JA)
            fl = out["x2"].clone()
            fl[:, IEN] += 0.5 * (e3f - e1f)
            out["x2"] = fl
        if "x3" in active:
            e1f = face_avg(re1, b2, _JA, _KA)
            e2f = face_avg(re2, b1, _IA, _KA)
            fl = out["x3"].clone()
            fl[:, IEN] += 0.5 * (e1f - e2f)
            out["x3"] = fl
        return out

    def new_dt(self, bcc, ndim: int, like):
        """dt <= fac dx^2 / (eta_ohm + eta_ad B^2) over the interior
        (reference: resistivity.cpp:283-364)."""
        if self.eta_ohm == 0.0 and self.eta_ad == 0.0:
            return _scalar(_HUGE, like)
        fac = _dt_fac(ndim)
        dx2min = _dx_min(self.mesh, "x1") ** 2
        if ndim > 1:
            dx2min = min(dx2min, _dx_min(self.mesh, "x2") ** 2)
        if ndim > 2:
            dx2min = min(dx2min, _dx_min(self.mesh, "x3") ** 2)
        if self.eta_ad == 0.0:
            return _scalar(fac * dx2min / self.eta_ohm, like)
        mbi = self.mesh.mb_indcs
        ba = bcc[:, :, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                 mbi.is_:mbi.ie + 1]
        bsq = ba[:, 0] ** 2 + ba[:, 1] ** 2 + ba[:, 2] ** 2
        eta_tot = self.eta_ohm + self.eta_ad * bsq
        return torch.min(fac * dx2min / torch.clamp(eta_tot, min=1e-300)) \
            .to(like.dtype)
