"""Fishbone-Moncrief torus around a Kerr black hole (the flagship GRMHD
problem).

Counterpart of ``athenak_tpu/pgen/gr_torus.py`` (reference:
src/pgen/fluids/gr_torus.cpp, the FM branch): a constant-angular-momentum
torus with l fixed by the pressure maximum, the log-enthalpy of FM
3.4-3.6, the velocities of FM 3.3, a power-law background atmosphere,
optional random pressure perturbations (numpy's ``default_rng(7)``, the
JAX package's generator, so both start from the same bits) and an
optional poloidal field from the vector potential A_phi ~ max(rho -
cutoff, 0) on the cell edges, whose staggered curl has div B = 0 to
round-off (the SANE single loop).  The initial data are host numpy; the
accretion fluxes through constant-KS-radius spheres are enrolled as user
history columns (``_enroll_torus_fluxes``).
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IM1, IM2, IM3
from . import state_from_prims
from .gr_bondi import host_metric, normal_frame


class _FM:
    def __init__(self, pin, phys):
        self.spin = phys.coord.coord_data.bh_spin
        self.gamma = phys.eos.gamma
        self.r_edge = pin.get_real("problem", "r_edge")
        self.r_peak = pin.get_real("problem", "r_peak")
        self.prograde = pin.get_or_add_boolean("problem", "prograde", True)
        self.l_peak = self._l_from_r_peak(self.r_peak)
        self.log_h_edge = self._log_h_aux(self.r_edge, 1.0)
        lh_peak = self._log_h_aux(self.r_peak, 1.0) - self.log_h_edge
        gm1 = self.gamma - 1.0
        self.ptot_over_rho_peak = gm1 / self.gamma * (math.exp(lh_peak) - 1)
        self.rho_peak = self.ptot_over_rho_peak ** (1.0 / gm1)

    def _l_from_r_peak(self, r):
        """l at the pressure maximum (CalculateLFromRPeak)."""
        a = self.spin
        sgn = 1.0 if self.prograde else -1.0
        num = (sgn * (r ** 4 + (a * r) ** 2 - 2.0 * a * a * r)
               - a * (r * r - a * a) * math.sqrt(r))
        den = r * r - 3.0 * r + sgn * 2.0 * a * math.sqrt(r)
        return (1.0 / r) * math.sqrt(1.0 / r) * num / den

    def _metric_bl(self, r, sin_theta):
        a = self.spin
        s2 = np.square(sin_theta)
        delta = r * r - 2.0 * r + a * a
        sigma = r * r + a * a * (1.0 - s2)
        aa = (r * r + a * a) ** 2 - delta * a * a * s2
        exp_2nu = sigma * delta / aa
        exp_2psi = aa / sigma * s2
        return s2, delta, sigma, aa, exp_2nu / np.maximum(exp_2psi, 1e-300)

    def _log_h_aux(self, r, sin_theta):
        """LogHAux (FM 3.4-3.6), vectorised over numpy."""
        a = self.spin
        _, delta, sigma, aa, exp_neg2chi = self._metric_bl(r, sin_theta)
        omega = 2.0 * a * r / aa
        var_a = np.sqrt(1.0 + 4.0 * self.l_peak ** 2 * exp_neg2chi)
        var_b = 0.5 * np.log((1.0 + var_a)
                             / np.maximum(sigma * delta / aa, 1e-300))
        return var_b - 0.5 * var_a - self.l_peak * omega

    def log_h(self, r, sin_theta):
        return self._log_h_aux(r, sin_theta) - self.log_h_edge

    def velocity(self, r, sin_theta):
        """BL u^0, u^3 inside the torus (CalculateVelocityInTorus, FM
        3.3)."""
        a = self.spin
        s2, delta, sigma, aa, exp_neg2chi = self._metric_bl(r, sin_theta)
        u_phi_proj = np.sqrt(np.maximum(
            0.5 * (-1.0 + np.sqrt(1.0 + 4.0 * self.l_peak ** 2
                                  * exp_neg2chi)), 0.0))
        if not self.prograde:
            u_phi_proj = -u_phi_proj
        u3_a = (1.0 + u_phi_proj ** 2) / (aa * sigma * delta)
        u3 = 2.0 * a * r * np.sqrt(np.maximum(u3_a, 0.0)) \
            + np.sqrt(sigma / aa) / np.maximum(sin_theta, 1e-12) \
            * u_phi_proj
        g_00 = -(1.0 - 2.0 * r / sigma)
        g_03 = -2.0 * a * r / sigma * s2
        g_33 = (sigma + (1.0 + 2.0 * r / sigma) * a * a * s2) * s2
        u0_a = (g_03 ** 2 - g_00 * g_33) * u3 ** 2
        u0_b = np.sqrt(np.maximum(u0_a - g_00, 1e-300))
        u0 = -1.0 / g_00 * (g_03 * u3 + u0_b)
        return u0, u3


def _bl_coords(x, y, z, a):
    rad2 = x * x + y * y + z * z
    r = np.sqrt((rad2 - a * a
                 + np.sqrt((rad2 - a * a) ** 2 + 4 * a * a * z * z)) / 2.0)
    r = np.maximum(r, 1e-12)
    sth = np.sqrt(np.maximum(1.0 - (z / r) ** 2, 0.0))
    return r, sth


def init(pin, mesh, phys):
    if not getattr(phys, "is_gr", False):
        raise ValueError("gr_torus requires <coord>/general_rel = true")
    # inside the horizon the BL expressions take square roots of negative
    # numbers; those cells are masked out
    with np.errstate(invalid="ignore"):
        return _init(pin, mesh, phys)


def _init(pin, mesh, phys):
    fm = _FM(pin, phys)
    gm1 = phys.eos.gamma - 1.0
    cd = phys.coord.coord_data
    a = cd.bh_spin
    rho_min = pin.get_or_add_real("problem", "rho_min", 1.0e-8)
    rho_pow = pin.get_or_add_real("problem", "rho_pow", -1.5)
    pgas_min = pin.get_or_add_real("problem", "pgas_min", 1.0e-10)
    pgas_pow = pin.get_or_add_real("problem", "pgas_pow", -2.5)
    pert_amp = pin.get_or_add_real("problem", "pert_amp", 0.0)
    b_norm = pin.get_or_add_real("problem", "b_norm", 0.0)
    cutoff = pin.get_or_add_real("problem", "potential_cutoff", 0.2)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))

    def torus_rho_pgas(r, sth):
        log_h = fm.log_h(r, sth)
        in_torus = (log_h >= 0.0) & (r >= fm.r_edge)
        ptor = gm1 / fm.gamma * (np.exp(np.where(in_torus, log_h, 0.0))
                                 - 1.0)
        rho = np.where(in_torus,
                       np.maximum(ptor, 0.0) ** (1.0 / gm1) / fm.rho_peak,
                       0.0)
        return in_torus, rho, np.where(in_torus, ptor * rho, 0.0)

    rng = np.random.default_rng(7)
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X = x1v[None, None, :] + 0.0 * x2v[None, :, None] \
            + 0.0 * x3v[:, None, None]
        Y = 0.0 * x1v[None, None, :] + x2v[None, :, None] \
            + 0.0 * x3v[:, None, None]
        Z = 0.0 * x1v[None, None, :] + 0.0 * x2v[None, :, None] \
            + x3v[:, None, None]
        r, sth = _bl_coords(X, Y, Z, a)
        in_torus, rho, pgas = torus_rho_pgas(r, sth)
        # background atmosphere, excised interior
        rho_bg = np.where(r > 1.0, rho_min * r ** rho_pow, cd.dexcise)
        pgas_bg = np.where(r > 1.0, pgas_min * r ** pgas_pow, cd.pexcise)
        _, u3_bl = fm.velocity(r, sth)
        # the azimuthal vector BL -> CKS is (-y, x, 0); u^0 from the
        # normalisation
        ux = np.where(in_torus, -u3_bl * Y, 0.0)
        uy = np.where(in_torus, u3_bl * X, 0.0)
        gl, gu = host_metric(X, Y, Z, a)
        uu1, uu2, uu3 = normal_frame(ux, uy, np.zeros_like(ux), gl, gu)
        pert = 2.0 * pert_amp * (rng.random(rho.shape) - 0.5)
        w[gid, IDN] = np.maximum(rho, rho_bg)
        w[gid, IEN] = np.maximum(pgas, pgas_bg) * (1.0 + pert) / gm1
        w[gid, IM1] = np.where(in_torus, uu1, 0.0)
        w[gid, IM2] = np.where(in_torus, uu2, 0.0)
        w[gid, IM3] = np.where(in_torus, uu3, 0.0)

    if not phys.is_mhd:
        _enroll_torus_fluxes(pin, mesh, phys)
        return state_from_prims(phys, w)

    # the magnetised torus: A_phi ~ max(rho - cutoff, 0) on the cell
    # edges, A = A_phi (-y, x, 0) / w^2 (flat phi), A3 = 0
    def a_pot(x, y, z):
        r, sth = _bl_coords(x, y, z, a)
        _, rho, _ = torus_rho_pgas(r, sth)
        aphi = np.maximum(rho - cutoff, 0.0)
        w2 = np.maximum(x * x + y * y, 1e-12)
        return -y / w2 * aphi * b_norm, x / w2 * aphi * b_norm

    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    ms = mesh.mesh_size
    for gid in range(nmb):
        x1f, x2f, x3f = mesh.face_edges(gid)
        x1v, x2v, x3v = mesh.cell_centers(gid)
        n1, n2, n3 = mbi.ncells1, mbi.ncells2, mbi.ncells3
        X1v, X2v, X3v = x1v[None, None, :], x2v[None, :, None], \
            x3v[:, None, None]
        X1f = x1f[:n1 + 1][None, None, :]
        X2f = x2f[:n2 + 1][None, :, None]
        X3f = x3f[:n3 + 1][:, None, None]
        # A1 at (x1v, x2f, x3f), A2 at (x1f, x2v, x3f)
        a1, _ = a_pot(X1v + 0 * X2f + 0 * X3f, 0 * X1v + X2f + 0 * X3f,
                      0 * X1v + 0 * X2f + X3f)
        _, a2 = a_pot(X1f + 0 * X2v + 0 * X3f, 0 * X1f + X2v + 0 * X3f,
                      0 * X1f + 0 * X2v + X3f)
        bfc["x1f"][gid] += -(a2[1:, :, :] - a2[:-1, :, :]) / ms.dx3
        bfc["x2f"][gid] += (a1[1:, :, :] - a1[:-1, :, :]) / ms.dx3
        bfc["x3f"][gid] += (a2[:, :, 1:] - a2[:, :, :-1]) / ms.dx1 \
            - (a1[:, 1:, :] - a1[:, :-1, :]) / ms.dx2
    _enroll_torus_fluxes(pin, mesh, phys)
    return state_from_prims(phys, w, bfc)


# ---------------------------------------------------------------------
# the accretion fluxes through constant-KS-radius spheres (TorusFluxes,
# gr_torus.cpp:1723-1906): mdot, edot, ldot (and Phi_BH under MHD) from
# the primitives interpolated to Gauss-Legendre x uniform-phi sphere
# grids, as user history columns
# ---------------------------------------------------------------------
def _enroll_torus_fluxes(pin, mesh, phys, ntheta: int = 16):
    from ..z4c.ahf import interp_fields
    from .errors import host

    a = phys.coord.coord_data.bh_spin
    is_mhd = phys.is_mhd
    gamma = phys.eos.gamma
    # default radii: the horizon, 12 and 24 (gr_torus.cpp:171-178),
    # those whose spheres fit in the domain; problem/flux_radii overrides
    ms = mesh.mesh_size
    rmax_fit = min(abs(ms.x1min), ms.x1max, abs(ms.x2min), ms.x2max,
                   abs(ms.x3min), ms.x3max)
    spec = pin.get_or_add_string("problem", "flux_radii", "")
    if spec:
        radii = [float(s) for s in spec.replace(",", " ").split()]
    else:
        radii = [r for r in (1.0 + math.sqrt(1.0 - a * a), 12.0, 24.0)
                 if r < rmax_fit]

    nphi = 2 * ntheta
    xgl, wgl = np.polynomial.legendre.leggauss(ntheta)
    theta = np.arccos(xgl)
    phi = (np.arange(nphi) + 0.5) * (2.0 * np.pi / nphi)
    TH, PH = np.meshgrid(theta, phi, indexing="ij")
    domega = np.broadcast_to((wgl * 2.0 * np.pi / nphi)[:, None],
                             TH.shape).ravel()
    sth, cth = np.sin(TH).ravel(), np.cos(TH).ravel()
    sph, cph = np.sin(PH).ravel(), np.cos(PH).ravel()

    grids = []
    for R in radii:
        # the CKS embedding of the KS sphere of radius R
        x = (R * cph - a * sph) * sth
        y = (R * sph + a * cph) * sth
        z = R * cth
        gl, gu = host_metric(x, y, z, a)
        rad2 = x * x + y * y + z * z
        den = 2.0 * R * R - rad2 + a * a
        drd = (R * x / den, R * y / den, (R * z + a * a * z / R) / den)
        # the covariant-phi projection (d x^i / d phi)
        dxdph = (-R * sph - a * cph) * sth
        dydph = (R * cph - a * sph) * sth
        grids.append((np.stack([x, y, z], axis=1), gl, gu, drd, dxdph,
                      dydph, R * R + (a * cth) ** 2))
    labels = []
    for R in radii:
        rs = f"{R:.1f}"
        labels += [f"mdot_{rs}", f"edot_{rs}", f"ldot_{rs}"]
        if is_mhd:
            labels.append(f"phi_{rs}")

    def hist(mesh_now, state):
        w = host(state["w"])
        fields = [w[:, c] for c in (IDN, IM1, IM2, IM3, IEN)]
        if is_mhd:
            bcc = host(state["bcc"])
            fields += [bcc[:, 0], bcc[:, 1], bcc[:, 2]]
        vals = []
        for (pts, gl, gu, drd, dxdph, dydph, smdet) in grids:
            ch = interp_fields(mesh_now, fields, pts)
            dn, vx, vy, vz, ie = ch[:5]
            q = (gl[1][1] * vx * vx + gl[2][2] * vy * vy
                 + gl[3][3] * vz * vz
                 + 2.0 * (gl[1][2] * vx * vy + gl[1][3] * vx * vz
                          + gl[2][3] * vy * vz))
            alp = np.sqrt(-1.0 / gu[0][0])
            lor = np.sqrt(1.0 + q)
            u0 = lor / alp
            u1 = vx - alp * lor * gu[0][1]
            u2 = vy - alp * lor * gu[0][2]
            u3 = vz - alp * lor * gu[0][3]
            uvec = (u0, u1, u2, u3)
            ul = [sum(gl[i][j] * uvec[j] for j in range(4))
                  for i in range(4)]
            if is_mhd:
                bx, by, bz = ch[5:]
                b0 = ul[1] * bx + ul[2] * by + ul[3] * bz
                b1 = (bx + b0 * u1) / u0
                b2 = (by + b0 * u2) / u0
                b3 = (bz + b0 * u3) / u0
                bvec = (b0, b1, b2, b3)
                bl = [sum(gl[i][j] * bvec[j] for j in range(4))
                      for i in range(4)]
                bsq = sum(bvec[i] * bl[i] for i in range(4))
            else:
                b1 = b2 = b3 = b0 = 0.0
                bl = [0.0] * 4
                bsq = 0.0
            ur = drd[0] * u1 + drd[1] * u2 + drd[2] * u3
            br = drd[0] * b1 + drd[1] * b2 + drd[2] * b3
            u_ph = dxdph * ul[1] + dydph * ul[2]
            b_ph = dxdph * bl[1] + dydph * bl[2]
            wtot = dn + gamma * ie + bsq
            vals += [float(np.sum(-dn * ur * smdet * domega)),
                     float(np.sum(-(wtot * ur * ul[0] - br * bl[0])
                                  * smdet * domega)),
                     float(np.sum((wtot * ur * u_ph - br * b_ph)
                                  * smdet * domega))]
            if is_mhd:
                vals.append(float(np.sum(
                    0.5 * np.abs(br * u0 - b0 * ur) * smdet * domega)))
        return labels, vals

    if grids:
        phys.user_hist_func = hist
