"""Bonnor-Ebert sphere collapse with self-gravity and Jeans refinement.

Counterpart of ``athenak_tpu/pgen/be_collapse.py`` (reference:
src/pgen/tests/be_collapse.cpp, the Athena++ collapse.cpp generator;
Tomida & Stone 2023, ApJS 266, 7):

  * the enhanced BE profile rho = f (1 + r^2/rcsq)^{-3/2}, rcsq = rc^2/3,
    held at the cloud radius rc, an optional m = 2 bar perturbation and
    solid-body rotation omega = omegatff / tff, tff = pi sqrt(3/(8 f));
  * cgs units from (mass [Msun], temperature [K]) (be_collapse.cpp:
    120-131) and a uniform Bz from the mass-to-flux ratio mu
    (be_collapse.cpp:170-178);
  * the barotropic cooling hook, e_int = rho/(gamma-1) sqrt(1 +
    (rho/rhocrit)^{2(gamma-1)}), with the momentum zeroed outside the
    cloud (BarotropicCooling, be_collapse.cpp:361-440), an enrolled
    ``srcterms_func`` that reads the cell coordinates of the mesh it is
    bound to: ``rebind`` moves it to the new tree at every update (the
    JAX package's hook keeps the first tree's, ROADMAP F17);
  * the Jeans criterion nJ = v_eff / sqrt(rho_max) 2 pi / dx, v_eff = cs
    (plus the largest Alfven speed for isothermal MHD): refine below
    njeans, derefine above 2.5 njeans (JeansRefinement,
    be_collapse.cpp:444-524).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..comm import local_blocks
from ..indices import IDN, IEN, IM1, IM2, IM3
from . import state_from_prims

# the dimensionless BE constants (be_collapse.cpp:40-43)
RC_DEFAULT = 6.45
RCSQ_FAC = 1.0 / 3.0
BEMASS = 197.561
# physical constants, cgs (be_collapse.cpp:45-50)
CS10 = 1.9e4
MSUN = 1.9891e33
G_CGS = 6.67259e-8


def _be_profile(r, rcsq):
    return (1.0 + r * r / rcsq) ** -1.5


def init(pin, mesh, phys):
    is_mhd = getattr(phys, "is_mhd", False)
    eos = phys.eos
    is_ideal = eos.is_ideal
    gamma = eos.gamma if is_ideal else 5.0 / 3.0
    cs = 1.0 if is_ideal else eos.iso_cs
    rc = pin.get_or_add_real("problem", "cloud_radius", RC_DEFAULT)
    mass = pin.get_or_add_real("problem", "mass", 0.0)
    temp = pin.get_or_add_real("problem", "temperature", 0.0)
    f = pin.get_or_add_real("problem", "f", 1.2)
    amp = pin.get_or_add_real("problem", "amp", 0.0)
    xc = pin.get_or_add_real("problem", "x_center", 0.0)
    yc = pin.get_or_add_real("problem", "y_center", 0.0)
    zc = pin.get_or_add_real("problem", "z_center", 0.0)
    njeans = pin.get_or_add_real("problem", "njeans", 16.0)
    rcsq = rc * rc * RCSQ_FAC

    # the unit system (be_collapse.cpp:120-131)
    if mass > 0.0 and temp > 0.0:
        m0 = mass * MSUN / (BEMASS * f)
        v0 = CS10 * math.sqrt(temp / 10.0)
        rho0 = v0 ** 6 / (m0 ** 2 * 64.0 * math.pi ** 3 * G_CGS ** 3)
        t0 = 1.0 / math.sqrt(4.0 * math.pi * G_CGS * rho0)
        l0 = v0 * t0
        gauss_unit = math.sqrt(rho0 * v0 * v0 * 4.0 * math.pi)
    else:
        rho0 = l0 = gauss_unit = 0.0
    rhocrit_cgs = pin.get_or_add_real("problem", "rhocrit", 0.0)
    rhocrit = rhocrit_cgs / rho0 if (rhocrit_cgs > 0.0
                                     and rho0 > 0.0) else 0.0
    # solid-body rotation (be_collapse.cpp:163-166)
    tff = math.sqrt(3.0 / (8.0 * f)) * math.pi
    omega = pin.get_or_add_real("problem", "omegatff", 0.0) / tff
    # the field from the mass-to-flux ratio (be_collapse.cpp:170-178)
    bz = 0.0
    if is_mhd:
        mu = pin.get_or_add_real("problem", "mu", 0.0)
        if mu > 0.0 and mass > 0.0:
            mucrit1 = 0.53 / (3.0 * math.pi) * math.sqrt(5.0 / G_CGS)
            bz = mass * MSUN / (mucrit1 * mu * math.pi
                                * (rc * l0) ** 2) / gauss_unit
        else:
            bz = pin.get_or_add_real("problem", "b0_z", 0.0)
    four_pi_G = pin.get_or_add_real("gravity", "four_pi_G", 1.0)
    if getattr(phys, "pgrav", None) is not None:
        phys.pgrav.four_pi_G = four_pi_G

    # the initial primitives (be_collapse.cpp:186-300)
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    igm1 = 1.0 / (gamma - 1.0) if is_ideal else 0.0
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        r = np.sqrt((X1 - xc) ** 2 + (X2 - yc) ** 2 + (X3 - zc) ** 2)
        rho = f * _be_profile(np.minimum(r, rc), rcsq)
        if amp > 0.0:
            rho = np.where(
                r < rc,
                rho * (1.0 + amp * r * r / (rc * rc)
                       * np.cos(2.0 * np.arctan2(X2 - yc, X1 - xc))),
                rho)
        inside = r < rc
        w[gid, IDN][act] = rho
        w[gid, IM1][act] = np.where(inside, omega * (X2 - yc), 0.0)
        w[gid, IM2][act] = np.where(inside, -omega * (X1 - xc), 0.0)
        if is_ideal:
            # p = rho cs^2 with cs = 1 at first
            w[gid, IEN][act] = rho * igm1

    def jeans_refinement(state, mesh):
        """Flags from the Jeans number of each block (over the whole
        block, ghosts included, as the JAX package reads it), for the
        state's blocks (one rank's rows under ranks: the cell sizes are
        read through ``local_blocks``)."""
        rho = state["u"][:, IDN]
        rho_max = rho.amax(dim=(1, 2, 3)).cpu().numpy()
        v_eff = np.full(rho.shape[0], cs)
        if is_mhd and not is_ideal:
            bsq = (state["bcc"] ** 2).sum(dim=1)
            v_eff = cs + np.sqrt(
                (bsq / rho).amax(dim=(1, 2, 3)).cpu().numpy())
        dx = np.asarray(local_blocks(mesh.mb_size["dx1"]))
        nj = v_eff / np.sqrt(np.maximum(rho_max, 1e-300)) \
            * (2.0 * math.pi / dx)
        flags = np.zeros(rho.shape[0], dtype=np.int64)
        flags[nj < njeans] = 1
        flags[nj > njeans * 2.5] = -1
        return flags

    phys.user_refine_func = jeans_refinement
    if is_ideal and rhocrit > 0.0:
        phys.srcterms_func = _barotropic(mesh, gamma - 1.0, rhocrit, rc,
                                         (xc, yc, zc), is_mhd)
    if is_mhd:
        bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
        bfc["x3f"][:] = bz
        return state_from_prims(phys, w, bfc)
    return state_from_prims(phys, w)


def _barotropic(mesh, gm1, rhocrit, rc, centre, needs_bcc):
    """The barotropic cooling hook fn(u, w, beta_dt[, bcc]) -> u, bound
    to ``mesh``; ``fn.rebind(mesh)`` binds it to another tree."""
    bound = {"mesh": mesh, "outside": {}}
    xc, yc, zc = centre

    def outside(like):
        """[nmb, n3, n2, n1] True outside the cloud, on ``like``'s device
        (made once a tree for every block, read as the running cycle's
        rows)."""
        key = (str(like.device), like.dtype)
        if key not in bound["outside"]:
            m = bound["mesh"]
            mbi = m.mb_indcs
            nmb = m.nmb_total
            xv = np.empty((nmb, 1, 1, mbi.ncells1))
            yv = np.empty((nmb, 1, mbi.ncells2, 1))
            zv = np.empty((nmb, mbi.ncells3, 1, 1))
            for g in range(nmb):
                c1, c2, c3 = m.cell_centers(g)
                xv[g, 0, 0], yv[g, 0, :, 0], zv[g, :, 0, 0] = c1, c2, c3

            def t(a):
                return torch.as_tensor(a, dtype=like.dtype,
                                       device=like.device)
            r2 = (t(xv) - xc) ** 2 + (t(yv) - yc) ** 2 + (t(zv) - zc) ** 2
            bound["outside"][key] = r2 > rc * rc
        return local_blocks(bound["outside"][key])

    def barotropic(u, wprim, beta_dt, bcc=None):
        out = outside(u)
        u = u.clone()
        mx = torch.where(out, 0.0, u[:, IM1])
        my = torch.where(out, 0.0, u[:, IM2])
        mz = torch.where(out, 0.0, u[:, IM3])
        rho = u[:, IDN]
        ke = 0.5 * (mx * mx + my * my + mz * mz) / rho
        me = 0.5 * torch.sum(bcc * bcc, dim=1) if bcc is not None else 0.0
        te = (rho / gm1) * torch.sqrt(1.0 + (rho / rhocrit) ** (2.0 * gm1))
        u[:, IM1], u[:, IM2], u[:, IM3] = mx, my, mz
        u[:, IEN] = te + ke + me
        return u

    def rebind(m):
        bound["mesh"] = m
        bound["outside"] = {}

    barotropic.needs_bcc = needs_bcc
    barotropic.rebind = rebind
    return barotropic
