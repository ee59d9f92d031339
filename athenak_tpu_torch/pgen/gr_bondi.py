"""GR Bondi accretion: stationary spherical accretion onto a black hole.

Counterpart of ``athenak_tpu/pgen/gr_bondi.py`` (reference:
src/pgen/tests/gr_bondi.cpp): the analytic Hawley, Smarr & Wilson (1984)
solution in Cartesian Kerr-Schild coordinates, for GR hydro and for GR
MHD with zero field; ``final`` writes the L1 deviation from it (the
``-errs.dat`` file).  The ghost zones of the physical boundaries are held
at the analytic conserved state by a user boundary function
(FixedBondiInflow, gr_bondi.cpp:526-699), whose mask and fixed state are
device tensors made once.  The temperature root of HSW eq. 76 is found
on the host by vectorised bisection, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..comm import local_blocks
from ..gr import cks
from ..indices import IDN, IEN, IM1, IM2, IM3
from . import errors as err_mod
from . import to_device

_TMIN, _TMAX = 1.0e-2, 1.0e1


def _temperature(r, n_adi, c1, c2):
    """HSW eq. 76 for T(r) by bracketed bisection (vectorised): the
    lesser and the greater root, split at the residual's minimum
    (gr_bondi.cpp:370-447)."""
    r = np.asarray(r, dtype=np.float64)

    def resid(t):
        return ((1.0 + (n_adi + 1.0) * t) ** 2
                * (1.0 - 2.0 / r + c1 * c1
                   / (r ** 4 * t ** (2.0 * n_adi))) - c2)

    # ternary search for the residual's minimum (unimodal between the
    # two roots), where it is negative
    t_lo = np.full_like(r, _TMIN)
    t_hi = np.full_like(r, _TMAX)
    for _ in range(120):
        m1 = t_lo + (t_hi - t_lo) / 3.0
        m2 = t_hi - (t_hi - t_lo) / 3.0
        take_left = resid(m1) < resid(m2)
        t_hi = np.where(take_left, m2, t_hi)
        t_lo = np.where(take_left, t_lo, m1)
    t_neg = 0.5 * (t_lo + t_hi)

    def bisect(tmin, tmax):
        rmin = resid(tmin)
        for _ in range(60):
            tm = 0.5 * (tmin + tmax)
            rm = resid(tm)
            same = np.sign(rm) == np.sign(rmin)
            tmin = np.where(same, tm, tmin)
            rmin = np.where(same, rm, rmin)
            tmax = np.where(same, tmax, tm)
        return 0.5 * (tmin + tmax)

    lesser = bisect(np.full_like(r, _TMIN), t_neg)
    greater = bisect(t_neg, np.full_like(r, _TMAX))
    return lesser, greater


def host_metric(x, y, z, a):
    """The Kerr-Schild metric at host points, as nested lists of float64
    numpy arrays."""
    gl, gu = cks.metric(*(torch.as_tensor(np.asarray(c, dtype=np.float64))
                          for c in (x, y, z)), a)
    return ([[c.numpy() for c in row] for row in gl],
            [[c.numpy() for c in row] for row in gu])


def normal_frame(u1, u2, u3, gl, gu):
    """utilde^i from the spatial u^i (gr_bondi.cpp:278-293): u^0 from the
    normalisation, utilde^i = u^i - g^0i / g^00 u^0."""
    tmp = (gl[1][1] * u1 * u1 + 2 * gl[1][2] * u1 * u2
           + 2 * gl[1][3] * u1 * u3 + gl[2][2] * u2 * u2
           + 2 * gl[2][3] * u2 * u3 + gl[3][3] * u3 * u3)
    gammasq = 1.0 + tmp
    b = gl[0][1] * u1 + gl[0][2] * u2 + gl[0][3] * u3
    u0 = (-b - np.sqrt(np.maximum(b * b - gl[0][0] * gammasq, 0.0))) \
        / gl[0][0]
    return (u1 - gu[0][1] / gu[0][0] * u0, u2 - gu[0][2] / gu[0][0] * u0,
            u3 - gu[0][3] / gu[0][0] * u0)


def _analytic_prims(mesh, pin, gamma, spin, dexcise, pexcise):
    """The analytic primitives on the whole arrays (ghosts included)."""
    k_adi = pin.get_real("problem", "k_adi")
    r_crit = pin.get_real("problem", "r_crit")
    n_adi = 1.0 / (gamma - 1.0)
    u_crit_sq = 1.0 / (2.0 * r_crit)
    u_crit = -np.sqrt(u_crit_sq)
    t_crit = (n_adi / (n_adi + 1.0) * u_crit_sq
              / (1.0 - (n_adi + 3.0) * u_crit_sq))
    c1 = t_crit ** n_adi * u_crit * r_crit ** 2
    c2 = ((1.0 + (n_adi + 1.0) * t_crit) ** 2
          * (1.0 - 3.0 / (2.0 * r_crit)))

    mbi = mesh.mb_indcs
    shape = (mesh.nmb_total, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    x, y, z = np.empty(shape), np.empty(shape), np.empty(shape)
    for gid in range(mesh.nmb_total):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        x[gid] = x1v[None, None, :]
        y[gid] = x2v[None, :, None]
        z[gid] = x3v[:, None, None]

    # Boyer-Lindquist radius, floored at 1 (gr_bondi.cpp:314-325)
    rad2 = x * x + y * y + z * z
    a = spin
    r = np.maximum(np.sqrt((rad2 - a * a
                            + np.sqrt((rad2 - a * a) ** 2
                                      + 4 * a * a * z * z)) / 2.0), 1.0)
    lesser, greater = _temperature(r, n_adi, c1, c2)
    temp = np.where(r <= r_crit, lesser, greater)
    rho = (temp / k_adi) ** n_adi
    pgas = temp * rho
    ur = c1 / (r ** 2 * temp ** n_adi)   # BL radial 4-velocity (HSW 75)

    # u^r (BL) -> CKS spatial 4-velocity (gr_bondi.cpp:337-355)
    delta = r * r - 2.0 * r + a * a
    u1 = ur * ((r * x + a * y) / (r * r + a * a) - y * a / delta)
    u2 = ur * ((r * y - a * x) / (r * r + a * a) + x * a / delta)
    u3 = ur * z / r
    gl, gu = host_metric(x, y, z, a)
    uu1, uu2, uu3 = normal_frame(u1, u2, u3, gl, gu)

    inside = r <= 1.0
    return (np.where(inside, dexcise, rho), np.where(inside, pexcise, pgas),
            np.where(inside, 0.0, uu1), np.where(inside, 0.0, uu2),
            np.where(inside, 0.0, uu3))


def _build_w(mesh, phys, pin):
    cd = phys.coord.coord_data
    rho, pgas, uu1, uu2, uu3 = _analytic_prims(
        mesh, pin, phys.eos.gamma, cd.bh_spin, cd.dexcise, cd.pexcise)
    mbi = mesh.mb_indcs
    w = np.zeros((mesh.nmb_total, phys.nvar, mbi.ncells3, mbi.ncells2,
                  mbi.ncells1))
    w[:, IDN] = rho
    w[:, IEN] = pgas / (phys.eos.gamma - 1.0)
    w[:, IM1] = uu1
    w[:, IM2] = uu2
    w[:, IM3] = uu3
    return to_device(phys, w)


def ghost_mask(mesh):
    """[nmb, 1, n3, n2, n1] bool (host): the ghost slabs on the physical
    boundaries of the active axes."""
    mbi = mesh.mb_indcs
    ng = mbi.ng
    mask = np.zeros((mesh.nmb_total, 1, mbi.ncells3, mbi.ncells2,
                     mbi.ncells1), dtype=bool)
    full = slice(None)
    slabs = {"x1m": (full, full, slice(0, ng)),
             "x1p": (full, full, slice(mbi.ncells1 - ng, None)),
             "x2m": (full, slice(0, ng), full),
             "x2p": (full, slice(mbi.ncells2 - ng, None), full),
             "x3m": (slice(0, ng), full, full),
             "x3p": (slice(mbi.ncells3 - ng, None), full, full)}
    active = ["x1m", "x1p"]
    if mbi.nx2 > 1:
        active += ["x2m", "x2p"]
    if mbi.nx3 > 1:
        active += ["x3m", "x3p"]
    for key in active:
        for gid in np.where(mesh.phys_bc_mask[key])[0]:
            mask[(gid, 0) + slabs[key]] = True
    return mask


def _zero_field(phys, w):
    bfc = {k: torch.zeros(s, dtype=w.dtype, device=w.device)
           for k, s in phys.fc_shapes.items()}
    return bfc, phys.compute_bcc(bfc)


def init(pin, mesh, phys):
    if not getattr(phys, "is_gr", False):
        raise ValueError("gr_bondi requires <coord>/general_rel = true")
    w = _build_w(mesh, phys, pin)
    if phys.is_mhd:
        # unmagnetised Bondi in the GRMHD solver (gr_bondi.cpp:195-213)
        bfc, bcc = _zero_field(phys, w)
        u = phys.prim_to_cons(w, bcc)
    else:
        u = phys.prim_to_cons(w)

    # the fixed-inflow user boundary: the physical boundaries' ghosts
    # held at the analytic conserved state (FixedBondiInflow); the
    # tables are read through local_blocks, so the hook also runs on one
    # rank's blocks (the JAX gr_bondi.py:202)
    mask = torch.as_tensor(ghost_mask(mesh), device=phys.device)
    u_fixed = u.clone()

    def bondi_bc(uu, bv):
        return torch.where(local_blocks(mask),
                           local_blocks(u_fixed), uu, out=uu)

    bondi_bc.shard_safe = True
    phys.bvals.user_bc_func = bondi_bc
    if phys.is_mhd:
        return phys.make_state(u, w, bfc, bcc=bcc)
    return phys.make_state(u, w)


def final(pin, mesh, phys, state):
    """The L1 deviation from the analytic (stationary) solution."""
    w = _build_w(mesh, phys, pin)
    if phys.is_mhd:
        u_ref = phys.prim_to_cons(w, state["bcc"] * 0.0)
        nvars = phys.nmhd
    else:
        u_ref = phys.prim_to_cons(w)
        nvars = phys.nhydro
    l1, linf = err_mod.compute_errors(mesh, state["u"], u_ref, nvars)
    fname = err_mod.write_error_file(
        pin, mesh, l1, linf, ["d", "M1", "M2", "M3", "E"][:nvars])
    print(f"errors written to {fname}")
