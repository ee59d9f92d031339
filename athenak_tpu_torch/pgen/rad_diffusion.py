"""Relativistic radiation diffusion of a Gaussian pulse in moving gas.

Counterpart of ``athenak_tpu/pgen/rad_diffusion.py`` (reference:
src/pgen/radiation/rad_diffusion.cpp): a scattering-dominated (kappa_s)
Gaussian pulse of radiation energy advected at v1.  The analytic
comoving solution fixes (er, fr) at coordinate time 0, and the angular
distribution comes from the Minerbo (M1) closure

  I = E/(4 pi) (1 + 3 f n.fhat)                      f <= 1/3
  I = E/(9 pi) (n.fhat - 3 f + 2) / (1 - f)^2        f  > 1/3

boosted into the tetrad frame by the invariant (n^0_fluid)^-4.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..indices import IDN, IEN, IVX
from . import to_device


def init(pin, mesh, phys):
    rad = phys.rad
    v1 = pin.get_real("problem", "v1")
    nu = pin.get_real("problem", "nu")
    lf = 1.0 / math.sqrt(1.0 - v1 * v1)
    uu1 = lf * v1
    dd = 1.0 / (3.0 * rad.kappa_s)
    nusq = nu * nu
    tp0 = 6.0 * uu1

    w = np.zeros(phys.shape)
    w[:, IDN] = 1.0
    w[:, IVX] = uu1
    w[:, IEN] = 1.0 / (phys.eos.gamma - 1.0)

    f64 = torch.float64
    dev = phys.device
    nh = rad.grid.nh
    uu0 = math.sqrt(1.0 + uu1 * uu1)
    # the fluid 4-velocity in the (flat) tetrad frame
    u_tet = (uu0, uu1, 0.0, 0.0)
    x = torch.as_tensor(rad._coords[0], dtype=f64,
                        device=dev)[:, None, None, None, :]
    tp = lf * (0.0 - v1 * x)
    xp = lf * (x - v1 * 0.0)
    er = torch.clamp(
        torch.exp(-nusq * xp ** 2 / (4.0 * dd * nusq * (tp0 + tp) + 1.0))
        / torch.sqrt(4.0 * dd * nusq * (tp0 + tp) + 1.0), min=1.0e-20)
    tmp_n = (xp - v1 * dd - 2.0 * nusq * dd
             * (2.0 * v1 * dd * (tp0 - v1 * xp)
                + xp * (v1 * xp - 2.0 * tp0)))
    tmp_d = (1.0 + 4.0 * nusq * dd * (tp0 - v1 * xp)) ** 2
    fr = 2.0 * dd * nusq * tmp_n / tmp_d * er
    ff = torch.abs(fr)
    f_f = ff / er
    f1 = torch.where(ff > 0.0, fr / torch.clamp(ff, min=1e-300), 0.0)

    # the fluid-frame direction of every angle (rad_diffusion.cpp:140-152)
    un_t = u_tet[1] * nh[:, 0]
    n0_f = torch.as_tensor(u_tet[0] * 1.0 - un_t, dtype=f64,
                           device=dev).reshape(1, -1, 1, 1, 1)
    n1_f = torch.as_tensor(-u_tet[1] * 1.0 + u_tet[1] / (u_tet[0] + 1.0)
                           * un_t + nh[:, 0], dtype=f64,
                           device=dev).reshape(1, -1, 1, 1, 1)
    fn_f = f1 * n1_f
    thin = er / (9.0 * math.pi) * (fn_f - 3.0 * f_f + 2.0) \
        / torch.clamp((1.0 - f_f) ** 2, min=1e-300)
    thick = er / (4.0 * math.pi) * (1.0 + 3.0 * f_f * fn_f)
    ii_f = torch.where(f_f <= 1.0 / 3.0, thick, thin)
    i0 = rad.n0.to(f64) * rad.n_0.to(f64) * ii_f / n0_f ** 4
    i0 = torch.broadcast_to(i0, rad.shape).to(phys.dtype)
    wt = to_device(phys, w)
    return phys.make_state(phys.prim_to_cons(wt), wt, i0.contiguous())
