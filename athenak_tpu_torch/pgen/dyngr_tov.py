"""TOV star initial data for dynamical GRMHD.

Counterpart of ``athenak_tpu/pgen/dyngr_tov.py`` (reference:
src/pgen/dyn_grmhd/tov.cpp with the TOV solver of src/utils/tov/): a
static spherical star in isotropic coordinates (a conformally flat
spatial metric gamma_ij = psi^4 delta_ij), either on a fixed ADM
background (<mhd>+<adm>) or coupled to Z4c (<mhd>+<z4c>).  An optional
interior poloidal seed field as the reference's mag_tov deck (A_phi ~
max(P - pcut, 0)^np).  The star is integrated and sampled on the host in
float64 (``utils_tov.py``) and moved once to the run's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils_tov import PolytropeEOS, TOVStar
from . import to_device


def _sample(tov, mesh):
    """(rho, P, alpha, psi4) of the star at every cell centre (ghosts
    included), host arrays [nmb, n3, n2, n1]."""
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    shp = (nmb, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    rho, P, alp, psi4 = (np.empty(shp) for _ in range(4))
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X1 = x1v[None, None, :]
        X2 = x2v[None, :, None]
        X3 = x3v[:, None, None]
        r = np.sqrt(np.broadcast_to(X1 ** 2 + X2 ** 2 + X3 ** 2, shp[1:]))
        rg, pg, _m, ag, p4g = tov.sample_iso(r.ravel())
        rho[gid] = rg.reshape(shp[1:])
        P[gid] = pg.reshape(shp[1:])
        alp[gid] = ag.reshape(shp[1:])
        psi4[gid] = p4g.reshape(shp[1:])
    return rho, P, alp, psi4


def _background(tov, mesh):
    """The star's ADM slice on ``mesh``: (g3d, alpha, beta_u, K_dd)."""
    _, _, alp, psi4 = _sample(tov, mesh)
    zero = np.zeros_like(psi4)
    return [psi4, zero, zero, psi4.copy(), zero, psi4.copy()], alp, \
        [zero, zero, zero], None


def _seed_field(tov, mesh, phys, b_amp, pcut, npow):
    """The interior poloidal seed: B = curl A on the staggered mesh by
    edge differences, A_phi = b_amp max(P - pcut, 0)^npow (the JAX
    package's, with the root cell sizes)."""
    def a_pot(x, y, z):
        rr = np.sqrt(x * x + y * y + z * z)
        pp = tov.sample_iso(rr.ravel())[1].reshape(rr.shape)
        am = b_amp * np.maximum(pp - pcut, 0.0) ** npow
        return -am * y, am * x  # (A_x, A_y); A_z = 0

    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    d1 = mesh.mesh_size.dx1
    d2, d3 = mesh.mesh_size.dx2, mesh.mesh_size.dx3
    for gid in range(mesh.nmb_total):
        x1f, x2f, x3f = mesh.face_edges(gid)
        x1v, x2v, x3v = mesh.cell_centers(gid)
        # B1 on x1-faces: dA_z/dy - dA_y/dz = -dA_y/dz
        X, Y, Z = np.meshgrid(x1f, x2v, x3v, indexing="ij")
        ay = a_pot(X, Y, Z + 0.5 * d3)[1]
        ay2 = a_pot(X, Y, Z - 0.5 * d3)[1]
        bfc["x1f"][gid] = (-(ay - ay2) / d3).transpose(2, 1, 0)
        # B2 on x2-faces: dA_x/dz
        X, Y, Z = np.meshgrid(x1v, x2f, x3v, indexing="ij")
        ax = a_pot(X, Y, Z + 0.5 * d3)[0]
        ax2 = a_pot(X, Y, Z - 0.5 * d3)[0]
        bfc["x2f"][gid] = ((ax - ax2) / d3).transpose(2, 1, 0)
        # B3 on x3-faces: dA_y/dx - dA_x/dy
        X, Y, Z = np.meshgrid(x1v, x2v, x3f, indexing="ij")
        ayp = a_pot(X + 0.5 * d1, Y, Z)[1]
        aym = a_pot(X - 0.5 * d1, Y, Z)[1]
        axp = a_pot(X, Y + 0.5 * d2, Z)[0]
        axm = a_pot(X, Y - 0.5 * d2, Z)[0]
        bfc["x3f"][gid] = ((ayp - aym) / d1
                           - (axp - axm) / d2).transpose(2, 1, 0)
    return bfc


def init(pin, mesh, phys):
    rhoc = pin.get_or_add_real("problem", "rhoc", 1.28e-3)
    kappa = pin.get_or_add_real("problem", "kappa", 100.0)
    gamma = pin.get_or_add_real("problem", "gamma", 2.0)
    dr = pin.get_or_add_real("problem", "dr", 1e-3)
    d_atm = pin.get_or_add_real("mhd", "dfloor", 1e-12)
    p_atm = pin.get_or_add_real("mhd", "pfloor", 1e-15)

    # the cold EOS of the star: the evolution's piecewise polytrope, or
    # a single polytrope
    from ..eos_ps.policies import PiecewisePolytropePS
    if isinstance(phys.policy, PiecewisePolytropePS):
        eos = phys.policy
    else:
        eos = PolytropeEOS(kappa=kappa, gamma=gamma)
    tov = TOVStar(eos, rhoc=rhoc, dr=dr)
    phys.tov = tov

    rho, P, alp, psi4 = _sample(tov, mesh)
    rho = np.maximum(rho, d_atm)
    P = np.maximum(P, p_atm)
    w = np.zeros((mesh.nmb_total, 5) + rho.shape[1:])
    w[:, 0] = rho
    w[:, 4] = P
    wt = to_device(phys, w)

    b_amp = pin.get_or_add_real("problem", "b_norm", 0.0)
    if b_amp != 0.0:
        bfc = _seed_field(tov, mesh, phys,
                          b_amp, pin.get_or_add_real("problem", "pcut", 1e-6),
                          pin.get_or_add_real("problem", "magindex", 2.0))
    else:
        bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    bfct = {k: to_device(phys, v) for k, v in bfc.items()}
    bcc = phys.compute_bcc(bfct)

    if phys.fixed_evolution:
        phys.set_fixed_adm(*_background(tov, mesh),
                           sampler=lambda m: _background(tov, m))
        adm = phys.adm_of({})
        z = None
    else:
        from ..z4c.z4c import I_ALPHA, I_CHI, I_GXX, I_GYY, I_GZZ, NZ4C
        npow_chi = phys.z4c.opt.chi_psi_power
        zst = np.zeros((mesh.nmb_total, NZ4C) + rho.shape[1:])
        zst[:, I_CHI] = psi4 ** (npow_chi / 4.0)
        zst[:, I_GXX] = 1.0
        zst[:, I_GYY] = 1.0
        zst[:, I_GZZ] = 1.0
        zst[:, I_ALPHA] = alp
        z = to_device(phys, zst)
        zero = torch.zeros_like(wt[:, 0])
        p4 = to_device(phys, psi4)
        adm = {"g3d": [p4, zero, zero, p4, zero, p4],
               "alpha": to_device(phys, alp),
               "beta_u": [zero] * 3, "K_dd": [zero] * 6}

    n = wt[:, 0] / phys.ps.mb
    T = phys.policy.temperature_from_p(torch.clamp(n, min=phys.ps.n_atm),
                                       wt[:, 4])
    u = phys.prim_to_cons_state(wt, T, bcc, adm)
    return phys.make_state(u, wt, bfct, T=T, z=z)
