"""Stage pieces that the hydro and the MHD stage share.

The face-state floors of the reconstructed primitives, the passive
scalars' upwind flux, the RK register update
``gam0*u0 + gam1*u1 - beta_dt*div(F)`` and the faces that first-order
flux correction replaces, on torch tensors ``[nmb, nvar, n3, n2, n1]``
(reference: src/hydro/hydro_fluxes.cpp, hydro_update.cpp,
hydro_fofc.cpp, src/mhd/mhd_fluxes.cpp, mhd_update.cpp, mhd_fofc.cpp
and the scalar blocks at the end of each Riemann solver).
"""

from __future__ import annotations

import torch

from ..indices import IDN
from .eos import EOSData


def face_floors(q, eos: EOSData):
    """Density and internal-energy floors on reconstructed face states
    (the density only for the isothermal gas; scalars untouched)."""
    if not eos.is_ideal:
        return torch.cat([torch.clamp(q[:, :1], min=eos.dfloor), q[:, 1:]],
                         dim=1)
    return torch.cat([torch.clamp(q[:, :1], min=eos.dfloor), q[:, 1:4],
                      torch.clamp(q[:, 4:5], min=eos.efloor), q[:, 5:]],
                     dim=1)


def scalar_fluxes(f, wl, wr, nfluid: int):
    """The passive scalars' upwind flux on the mass flux, in the channels
    of ``f`` beyond ``nfluid`` (reference: the scalar blocks at the end
    of each Riemann solver); ``f`` unchanged when there are none."""
    if f.shape[1] <= nfluid:
        return f
    fd = f[:, IDN:IDN + 1]
    fs = torch.where(fd >= 0.0, fd * wl[:, nfluid:], fd * wr[:, nfluid:])
    return torch.cat([f[:, :nfluid], fs], dim=1)


def rk_update(u0, u1, flx, gam0, gam1, beta_dt, dirs):
    """gam0 * u0 + gam1 * u1 - beta_dt * div(F) (reference
    mhd_update.cpp, hydro_update.cpp); ``dirs`` lists
    (name, axis, ivx, dx), entry i of a flux is the lower face of cell i
    and the stencil wraps circularly."""
    divf = None
    for name, axis, _ivx, dx in dirs:
        f = flx[name]
        d = (torch.roll(f, -1, dims=axis) - f) / dx
        divf = d if divf is None else divf + d
    return gam0 * u0 + gam1 * u1 - beta_dt * divf


def fofc_faces(c2p, u0, u1, flx, gam0, gam1, beta_dt, dirs, excise=None):
    """The faces of first-order flux correction: a trial RK update, and
    a cell flagged where ``c2p`` (trial state -> its fixed state) changed
    it, i.e. a floor fired or the root find failed; with ``c2p`` None no
    trial is made.  ``excise`` ([nmb, n3, n2, n1] bool, GR) flags the
    cells around the horizon besides.  A face is corrected where the cell
    on either side is flagged.  Returns ({direction: face mask [nmb, n3,
    n2, n1]}, the number of flagged cells)."""
    flag = excise
    if c2p is not None:
        utest = rk_update(u0, u1, flx, gam0, gam1, beta_dt, dirs)
        flag = (c2p(utest) != utest).any(dim=1)
        if excise is not None:
            flag = flag | excise
    masks = {name: flag | torch.roll(flag, 1, dims=axis - 1)
             for name, axis, _ivx, _dx in dirs}
    return masks, flag.sum()
