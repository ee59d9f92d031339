"""Physics source terms for the hydro and MHD equations.

Counterpart of ``athenak_tpu/srcterms.py`` (reference:
src/srcterms/srcterms.cpp:37-306, srcterms_newdt.cpp:25-111): constant
acceleration, optically thin ISM cooling (the SPEX curve of Schure et al.
2009 with the Koyama & Inutsuka 2002 low-T branch and the CGOLS high-T
fit) and relativistic cooling, each a pointwise update of the whole
array in torch ops after the RK update, and the self-gravity sources
from the potential of the stage (Mullen, Hanawa & Gammie 2020).  Each
fluid owns its instance (input blocks ``<hydro_srcterms>`` /
``<mhd_srcterms>``).
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import local_tree
from .indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ
from .units import ATOMIC_MASS_UNIT_CGS, Units

_TINY = float(np.finfo(np.float32).tiny)
_HUGE = float(np.finfo(np.float32).max)

# log10(Lambda) SPEX cooling table, 4.12 <= log10(T) <= 8.16 in steps of
# 0.04 dex (Schure et al. 2009, Table 2; the values the reference
# tabulates in src/srcterms/ismcooling.hpp:21-34)
_SPEX_LOG_LAMBDA = np.array([
    -22.5977, -21.9689, -21.5972, -21.4615, -21.4789, -21.5497, -21.6211,
    -21.6595, -21.6426, -21.5688, -21.4771, -21.3755, -21.2693, -21.1644,
    -21.0658, -20.9778, -20.8986, -20.8281, -20.7700, -20.7223, -20.6888,
    -20.6739, -20.6815, -20.7051, -20.7229, -20.7208, -20.7058, -20.6896,
    -20.6797, -20.6749, -20.6709, -20.6748, -20.7089, -20.8031, -20.9647,
    -21.1482, -21.2932, -21.3767, -21.4129, -21.4291, -21.4538, -21.5055,
    -21.5740, -21.6300, -21.6615, -21.6766, -21.6886, -21.7073, -21.7304,
    -21.7491, -21.7607, -21.7701, -21.7877, -21.8243, -21.8875, -21.9738,
    -22.0671, -22.1537, -22.2265, -22.2821, -22.3213, -22.3462, -22.3587,
    -22.3622, -22.3590, -22.3512, -22.3420, -22.3342, -22.3312, -22.3346,
    -22.3445, -22.3595, -22.3780, -22.4007, -22.4289, -22.4625, -22.4995,
    -22.5353, -22.5659, -22.5895, -22.6059, -22.6161, -22.6208, -22.6213,
    -22.6184, -22.6126, -22.6045, -22.5945, -22.5831, -22.5707, -22.5573,
    -22.5434, -22.5287, -22.5140, -22.4992, -22.4844, -22.4695, -22.4543,
    -22.4392, -22.4237, -22.4087, -22.3928], dtype=np.float64)


def ism_cool_fn(temp):
    """ISM cooling rate Lambda(T) in cgs, elementwise (reference:
    src/srcterms/ismcooling.hpp:36-56):

      log T <= 4.2           Koyama & Inutsuka (2002) fit
      4.2 < log T <= 8.15    the SPEX table, linear in log T at 0.04 dex
      log T > 8.15           the CGOLS power-law fit
    """
    temp = torch.clamp(temp, min=_TINY)
    logt = torch.log10(temp)
    low = (2.0e-19 * torch.exp(-1.184e5 / (temp + 1.0e3))
           + 2.8e-28 * torch.sqrt(temp)
           * torch.exp(-92.0 / torch.clamp(temp, min=_TINY)))
    high = 10.0 ** (0.45 * logt - 26.065)

    # int32 truncation toward zero, as the JAX astype
    idx = torch.clamp((25.0 * logt).to(torch.int32) - 103, 0, 100).long()
    x0 = 4.12 + 0.04 * idx.to(temp.dtype)
    dx = logt - x0
    tab = torch.as_tensor(_SPEX_LOG_LAMBDA, dtype=temp.dtype,
                          device=temp.device)
    logcool = (tab[idx + 1] * dx - tab[idx] * (dx - 0.04)) * 25.0
    mid = 10.0 ** logcool
    return torch.where(logt <= 4.2, low,
                       torch.where(logt > 8.15, high, mid))


class SourceTerms:
    """The source terms a ``<*_srcterms>`` block switches on."""

    def __init__(self, block: str, pin, mesh, eos) -> None:
        self.mesh = mesh
        self.eos = eos
        self.const_accel = pin.get_or_add_boolean(block, "const_accel", False)
        self.ism_cooling = pin.get_or_add_boolean(block, "ism_cooling", False)
        self.rel_cooling = pin.get_or_add_boolean(block, "rel_cooling", False)
        self.self_gravity = pin.get_or_add_boolean(block, "self_gravity",
                                                   False)
        if self.const_accel:
            self.const_accel_val = pin.get_real(block, "const_accel_val")
            self.const_accel_dir = pin.get_integer(block, "const_accel_dir")
            if not 1 <= self.const_accel_dir <= 3:
                raise ValueError("const_accel_dir must be 1, 2, or 3")
        if self.ism_cooling or self.rel_cooling:
            self.units = Units(pin)
        if self.ism_cooling:
            self.hrate = pin.get_real(block, "hrate")
        if self.rel_cooling:
            self.crate_rel = pin.get_real(block, "crate_rel")
            self.cpower_rel = pin.get_or_add_real(block, "cpower_rel", 1.0)
        self.any_enabled = (self.const_accel or self.ism_cooling
                            or self.rel_cooling or self.self_gravity)

    def _cooling_units(self):
        u = self.units
        n_unit = u.density_cgs / u.mu / ATOMIC_MASS_UNIT_CGS
        cooling_unit = u.pressure_cgs / u.time_cgs / n_unit / n_unit
        heating_unit = u.pressure_cgs / u.time_cgs / n_unit
        return u.temperature_cgs, cooling_unit, heating_unit

    def apply(self, u, w, beta_dt, flx=None, phi=None):
        """``u`` plus every enabled source from the primitives ``w``
        (reference: SourceTerms::ApplySrcTerms, srcterms.cpp:93-101),
        ghost zones too (the fill overwrites them right after); the
        self-gravity sources read the stage's fluxes ``flx`` and
        potential ``phi``."""
        u = u.clone()
        if self.const_accel:
            d = self.const_accel_dir   # 1, 2, 3 -> IM1, IM2, IM3
            src = beta_dt * self.const_accel_val * w[:, IDN]
            u[:, d] += src
            if self.eos.is_ideal:
                u[:, IEN] += src * w[:, d]
        if self.ism_cooling:
            gm1 = self.eos.gamma - 1.0
            temp_unit, cooling_unit, heating_unit = self._cooling_units()
            temp = temp_unit * w[:, IEN] / w[:, IDN] * gm1
            lam = ism_cool_fn(temp) / cooling_unit
            gam_heat = self.hrate / heating_unit
            u[:, IEN] += -beta_dt * w[:, IDN] * (w[:, IDN] * lam - gam_heat)
        if self.rel_cooling:
            gm1 = self.eos.gamma - 1.0
            temp = w[:, IEN] / w[:, IDN] * gm1
            ux, uy, uz = w[:, IVX], w[:, IVY], w[:, IVZ]
            ut = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
            cool = (temp * self.crate_rel) ** self.cpower_rel
            fac = beta_dt * w[:, IDN] * cool
            u[:, IEN] += -fac * ut
            u[:, IM1] += -fac * ux
            u[:, IM2] += -fac * uy
            u[:, IM3] += -fac * uz
        if self.self_gravity and phi is not None:
            u = self._self_gravity(u, w, beta_dt, flx, phi)
        return u

    def _self_gravity(self, u, w, beta_dt, flx, phi):
        """The momentum source and the energy source from the Godunov
        mass fluxes (Mullen, Hanawa & Gammie 2020; reference:
        srcterms.cpp:215-306); ``phi`` [nmb, 1, n3, n2, n1] with its
        ghosts filled."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        p = phi[:, 0]
        if mesh.multilevel:
            # per-block cell sizes, made once a dtype and device, read as
            # the running cycle's rows (JAX srcterms.py:162-166)
            key = (p.dtype, str(p.device))
            tabs = self.__dict__.setdefault("_dx_tabs", {})
            if key not in tabs:
                tabs[key] = tuple(torch.as_tensor(
                    np.asarray(mesh.mb_size[n]).reshape(-1, 1, 1, 1),
                    dtype=p.dtype, device=p.device)
                    for n in ("dx1", "dx2", "dx3"))
            dx1, dx2, dx3 = local_tree(tabs[key])
        else:
            ms = mesh.mesh_size
            dx1, dx2, dx3 = ms.dx1, ms.dx2, ms.dx3
        dirs = [(3, dx1, "x1", IM1)]
        if mbi.nx2 > 1:
            dirs.append((2, dx2, "x2", IM2))
        if mbi.nx3 > 1:
            dirs.append((1, dx3, "x3", IM3))
        for a, dx, name, imom in dirs:
            dpl = -(p - torch.roll(p, 1, dims=a))       # phi(i) - phi(i-1)
            dpr = -(torch.roll(p, -1, dims=a) - p)      # phi(i+1) - phi(i)
            hdtodx = 0.5 * beta_dt / dx
            u[:, imom] += hdtodx * w[:, IDN] * (dpl + dpr)
            if self.eos.is_ideal and flx is not None:
                f = flx[name][:, IDN]
                fp = torch.roll(f, -1, dims=a)
                u[:, IEN] += hdtodx * (f * dpl + fp * dpr)
        return u

    def new_dt(self, w):
        """The cooling time limit over the interior (reference:
        srcterms_newdt.cpp:25-111); float32's largest value when no
        cooling is on (filled in on the device: no host copy, which a
        CUDA graph of the cycle could not hold)."""
        dt = torch.full((), _HUGE, dtype=w.dtype, device=w.device)
        if not (self.ism_cooling or self.rel_cooling):
            return dt
        mbi = self.mesh.mb_indcs
        wa = w[:, :, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
               mbi.is_:mbi.ie + 1]
        gm1 = self.eos.gamma - 1.0
        if self.ism_cooling:
            temp_unit, cooling_unit, heating_unit = self._cooling_units()
            temp = temp_unit * wa[:, IEN] / wa[:, IDN] * gm1
            lam = ism_cool_fn(temp) / cooling_unit
            gam_heat = self.hrate / heating_unit
            ch = _TINY + torch.abs(wa[:, IDN] * (wa[:, IDN] * lam
                                                 - gam_heat))
            dt = torch.minimum(dt, torch.min(wa[:, IEN] / ch))
        if self.rel_cooling:
            temp = wa[:, IEN] / wa[:, IDN] * gm1
            ux, uy, uz = wa[:, IVX], wa[:, IVY], wa[:, IVZ]
            ut = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
            ch = _TINY + torch.abs(
                wa[:, IDN] * ut * (temp * self.crate_rel) ** self.cpower_rel)
            dt = torch.minimum(dt, torch.min(wa[:, IEN] / ch))
        return dt
