"""Equations of state for Newtonian hydro and MHD, ideal or isothermal:
conserved <-> primitive.

Counterpart of ``athenak_tpu/ops/eos.py`` (reference:
src/eos/ideal_c2p_hyd.hpp:22-83, src/eos/ideal_c2p_mhd.hpp:21-67,
src/eos/eos.hpp:27-190), on torch tensors laid out
``[..., nvar, n3, n2, n1]``.  The floor cascade (density -> energy ->
temperature -> entropy) and the correction of the conserved energy when
a floor fires are the same; the floor-hit counts come back as 0-d
integer tensors under the JAX package's names, so callers can
accumulate event counters.  The isothermal gas has four fluid channels
(no energy); channels beyond the fluid ones are passive scalars, stored
conserved as d*s, floored at zero.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ

# floors default to the float32 ``tiny`` even in double precision,
# exactly as the JAX package does
_TINY32 = float(np.finfo(np.float32).tiny)
_MAX32 = float(np.finfo(np.float32).max)


@dataclass(frozen=True)
class EOSData:
    """Static EOS parameters (reference: ``EOS_Data``, src/eos/eos.hpp)."""
    gamma: float = 5.0 / 3.0
    iso_cs: float = 1.0
    is_ideal: bool = True
    dfloor: float = _TINY32
    pfloor: float = _TINY32
    tfloor: float = _TINY32
    sfloor: float = _TINY32
    gamma_max: float = _MAX32
    sigma_max: float = _MAX32

    @classmethod
    def from_input(cls, pin, block: str) -> "EOSData":
        eos_type = pin.get_string(block, "eos")
        if eos_type not in ("ideal", "isothermal"):
            raise ValueError(f"<{block}>/eos = '{eos_type}' not supported")
        return cls(
            gamma=pin.get_or_add_real(block, "gamma", 5.0 / 3.0),
            iso_cs=pin.get_or_add_real(block, "iso_sound_speed", 1.0),
            is_ideal=(eos_type == "ideal"),
            dfloor=pin.get_or_add_real(block, "dfloor", _TINY32),
            pfloor=pin.get_or_add_real(block, "pfloor", _TINY32),
            tfloor=pin.get_or_add_real(block, "tfloor", _TINY32),
            sfloor=pin.get_or_add_real(block, "sfloor", _TINY32),
            gamma_max=pin.get_or_add_real(block, "gamma_max", _MAX32),
            sigma_max=pin.get_or_add_real(block, "sigma_max", _MAX32),
        )

    @property
    def efloor(self) -> float:
        """Internal-energy floor pfloor / (gamma - 1)."""
        return self.pfloor / (self.gamma - 1.0)

    @property
    def nfluid(self) -> int:
        """Fluid channels: 5 for the ideal gas, 4 (no energy) isothermal."""
        return 5 if self.is_ideal else 4

    def pressure(self, eint):
        """p = (gamma-1) e (reference IdealGasPressure)."""
        return (self.gamma - 1.0) * eint

    def hydro_sound_speed(self, d, p):
        """Adiabatic sound speed sqrt(gamma p / d)."""
        return torch.sqrt(self.gamma * p / d)

    def mhd_fast_speed(self, d, p, bx, by, bz):
        """Fast magnetosonic speed (reference IdealMHDFastSpeed)."""
        asq = self.gamma * p if self.is_ideal else (self.iso_cs ** 2) * d
        ct2 = by * by + bz * bz
        qsq = bx * bx + ct2 + asq
        tmp = bx * bx + ct2 - asq
        return torch.sqrt(
            0.5 * (qsq + torch.sqrt(tmp * tmp + 4.0 * asq * ct2)) / d)


def _scalars(u, d, di, nfluid: int):
    """Passive scalars beyond the ``nfluid`` channels of ``u``: the
    conserved d*s floored at zero and the primitive s; empty lists when
    there are none."""
    if u.shape[-4] <= nfluid:
        return [], []
    s = torch.clamp(u[..., nfluid:, :, :, :], min=0.0)
    return [s * di.unsqueeze(-4)], [s]


def cons_to_prim_hydro(u, eos: EOSData):
    """Newtonian hydro c2p over ``u [..., nvar, n3, n2, n1]``.

    Returns ``(w, u_fixed, counters)``: primitives (IEN holds the internal
    energy), the conserved state with the floor corrections folded back,
    and the floor-hit counts over the whole array."""
    d = u[..., IDN, :, :, :]
    mx = u[..., IM1, :, :, :]
    my = u[..., IM2, :, :, :]
    mz = u[..., IM3, :, :, :]

    dfloor_used = d < eos.dfloor
    d = torch.clamp(d, min=eos.dfloor)
    di = 1.0 / d
    vx, vy, vz = di * mx, di * my, di * mz
    counters = {"neos_dfloor": dfloor_used.sum()}
    ws, us = _scalars(u, d, di, eos.nfluid)

    if not eos.is_ideal:
        w = torch.stack([d, vx, vy, vz], dim=-4)
        u_fixed = torch.stack([d, mx, my, mz], dim=-4)
        if ws:
            w = torch.cat([w] + ws, dim=-4)
            u_fixed = torch.cat([u_fixed] + us, dim=-4)
        return w, u_fixed, counters

    gm1 = eos.gamma - 1.0
    efloor = eos.pfloor / gm1
    etot = u[..., IEN, :, :, :]
    e_k = 0.5 * di * (mx * mx + my * my + mz * mz)
    e = etot - e_k

    efloor_used = e < efloor
    e = torch.clamp(e, min=efloor)
    tfloor_used = gm1 * e * di < eos.tfloor
    e = torch.where(tfloor_used, d * eos.tfloor / gm1, e)
    spe_over_eps = gm1 / torch.pow(d, gm1)
    sfloor_used = spe_over_eps * e * di <= eos.sfloor
    e = torch.where(sfloor_used, d * eos.sfloor / spe_over_eps, e)

    etot_fixed = torch.where(efloor_used | tfloor_used | sfloor_used,
                             e + e_k, etot)
    w = torch.stack([d, vx, vy, vz, e], dim=-4)
    u_fixed = torch.stack([d, mx, my, mz, etot_fixed], dim=-4)
    if ws:
        w = torch.cat([w] + ws, dim=-4)
        u_fixed = torch.cat([u_fixed] + us, dim=-4)
    counters["neos_efloor"] = (efloor_used | sfloor_used).sum()
    counters["neos_tfloor"] = tfloor_used.sum()
    return w, u_fixed, counters


def prim_to_cons_hydro(w, eos: EOSData):
    """Newtonian hydro p2c (reference SingleP2C_IdealHyd)."""
    d = w[..., IDN, :, :, :]
    vx = w[..., IVX, :, :, :]
    vy = w[..., IVY, :, :, :]
    vz = w[..., IVZ, :, :, :]
    chans = [d, d * vx, d * vy, d * vz]
    if eos.is_ideal:
        e = w[..., IEN, :, :, :]
        chans.append(e + 0.5 * d * (vx * vx + vy * vy + vz * vz))
    u = torch.stack(chans, dim=-4)
    if w.shape[-4] > eos.nfluid:
        u = torch.cat([u, w[..., eos.nfluid:, :, :, :] * d.unsqueeze(-4)],
                      dim=-4)
    return u


def cons_to_prim_mhd(u, bcc, eos: EOSData, interior=None):
    """Newtonian MHD c2p over ``u [..., nvar, n3, n2, n1]`` with the
    cell-centred field ``bcc [..., 3, n3, n2, n1]``.

    Returns ``(w, u_fixed, counters)``: primitives (IEN holds the internal
    energy), the conserved state with the floor corrections folded back,
    and the floor-hit counts.  The counts cover the whole array unless a
    boolean ``interior`` mask (broadcastable to one channel) restricts
    them, as the stage kernel does.
    """
    d = u[..., IDN, :, :, :]
    mx = u[..., IM1, :, :, :]
    my = u[..., IM2, :, :, :]
    mz = u[..., IM3, :, :, :]
    bx = bcc[..., 0, :, :, :]
    by = bcc[..., 1, :, :, :]
    bz = bcc[..., 2, :, :, :]

    b2 = bx * bx + by * by + bz * bz
    dfl = torch.clamp(b2 / eos.sigma_max, min=eos.dfloor)
    dfloor_used = d < dfl
    d = torch.maximum(d, dfl)

    di = 1.0 / d
    vx, vy, vz = di * mx, di * my, di * mz
    ws, us = _scalars(u, d, di, eos.nfluid)

    def count(mask):
        if interior is not None:
            mask = mask & interior
        return mask.sum()

    if not eos.is_ideal:
        w = torch.stack([d, vx, vy, vz], dim=-4)
        u_fixed = torch.stack([d, mx, my, mz], dim=-4)
        if ws:
            w = torch.cat([w] + ws, dim=-4)
            u_fixed = torch.cat([u_fixed] + us, dim=-4)
        return w, u_fixed, {"neos_dfloor": count(dfloor_used)}

    etot = u[..., IEN, :, :, :]
    gm1 = eos.gamma - 1.0
    efloor = eos.pfloor / gm1
    e_k = 0.5 * di * (mx * mx + my * my + mz * mz)
    e_m = 0.5 * b2
    e = etot - e_k - e_m

    efloor_used = e < efloor
    e = torch.clamp(e, min=efloor)
    tfloor_used = gm1 * e * di < eos.tfloor
    e = torch.where(tfloor_used, d * eos.tfloor / gm1, e)
    spe_over_eps = gm1 / torch.pow(d, gm1)
    sfloor_used = spe_over_eps * e * di <= eos.sfloor
    e = torch.where(sfloor_used, d * eos.sfloor / spe_over_eps, e)

    etot_fixed = torch.where(efloor_used | tfloor_used | sfloor_used,
                             e + e_k + e_m, etot)
    w = torch.stack([d, vx, vy, vz, e], dim=-4)
    u_fixed = torch.stack([d, mx, my, mz, etot_fixed], dim=-4)
    if ws:
        w = torch.cat([w] + ws, dim=-4)
        u_fixed = torch.cat([u_fixed] + us, dim=-4)

    counters = {"neos_dfloor": count(dfloor_used),
                "neos_efloor": count(efloor_used | sfloor_used),
                "neos_tfloor": count(tfloor_used)}
    return w, u_fixed, counters


def prim_to_cons_mhd(w, bcc, eos: EOSData):
    """Newtonian MHD p2c (reference SingleP2C_IdealMHD)."""
    d = w[..., IDN, :, :, :]
    vx = w[..., IVX, :, :, :]
    vy = w[..., IVY, :, :, :]
    vz = w[..., IVZ, :, :, :]
    chans = [d, d * vx, d * vy, d * vz]
    if eos.is_ideal:
        e = w[..., IEN, :, :, :]
        b2 = (bcc[..., 0, :, :, :] ** 2 + bcc[..., 1, :, :, :] ** 2
              + bcc[..., 2, :, :, :] ** 2)
        chans.append(e + 0.5 * (d * (vx * vx + vy * vy + vz * vz) + b2))
    u = torch.stack(chans, dim=-4)
    if w.shape[-4] > eos.nfluid:
        u = torch.cat([u, w[..., eos.nfluid:, :, :, :] * d.unsqueeze(-4)],
                      dim=-4)
    return u
