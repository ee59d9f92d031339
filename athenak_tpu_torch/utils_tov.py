"""TOV star solver: host-side ODE integration of the static star.

Counterpart of ``athenak_tpu/utils_tov.py``, a copy kept in the port
(reference: ``TOVStar``, src/utils/tov/tov.hpp:24-230, tov.cpp): RK4
integration of the TOV equations in Schwarzschild (areal) radius
together with the isotropic-radius ODE, giving rho(r), P(r), m(r),
alpha(r) and the mapping r_iso(r).  It runs once on the host in numpy
(as the reference's host-side ConstructTOV); the problem generators
sample it onto the mesh and move the result to the run's device.

EOS interface: any object with ``cold_pressure_np(rho)``,
``cold_energy_np(rho)`` and ``cold_rho_from_p_np(P)`` (see
eos_ps/policies.py PiecewisePolytropePS; PolytropeEOS below covers the
single-polytrope case, reference: tov_polytrope.hpp).
"""

from __future__ import annotations

import numpy as np


class PolytropeEOS:
    """P = K rho^Gamma, e = rho + P/(Gamma-1)
    (reference: src/utils/tov/tov_polytrope.hpp)."""

    def __init__(self, kappa: float, gamma: float) -> None:
        self.k = kappa
        self.g = gamma

    def cold_pressure_np(self, rho):
        return self.k * np.asarray(rho) ** self.g

    def cold_energy_np(self, rho):
        rho = np.asarray(rho)
        return rho + self.cold_pressure_np(rho) / (self.g - 1.0)

    def cold_rho_from_p_np(self, p):
        return (np.maximum(np.asarray(p), 0.0) / self.k) ** (1.0 / self.g)


class TOVStar:
    """Integrated TOV profile + samplers (isotropic coordinates)."""

    def __init__(self, eos, rhoc: float, dr: float = 1e-4,
                 rmax: float = 100.0, pfloor: float = 1e-16) -> None:
        self.eos = eos
        self.rhoc = rhoc
        self.dr = dr

        pc = eos.cold_pressure_np(rhoc)
        npts = int(rmax / dr)

        # state: P, m, alpha-tilde (log alpha up to a constant), r_iso
        def rhs(r, P, m):
            if P <= pfloor:
                return 0.0, 0.0, 0.0, 1.0
            rho = eos.cold_rho_from_p_np(P)
            e = eos.cold_energy_np(rho)
            if r < 1e-12:
                return 0.0, 0.0, 0.0, 1.0
            A = 1.0 / (1.0 - 2.0 * m / r)
            B = (m + 4.0 * np.pi * r ** 3 * P) / r ** 2
            dP = -(e + P) * A * B
            dm = 4.0 * np.pi * r ** 2 * e
            dalp = A * B          # d(ln alpha)/dr
            # isotropic radius ODE: d(ln riso)/dr = sqrt(A)/r
            driso = np.sqrt(A) / r
            return dP, dm, dalp, driso

        rs = np.linspace(0.0, rmax, npts + 1)
        P = np.empty(npts + 1)
        m = np.empty(npts + 1)
        lnalp = np.empty(npts + 1)
        lnriso = np.empty(npts + 1)
        P[0], m[0], lnalp[0] = pc, 0.0, 0.0
        lnriso[0] = 0.0  # integrates d ln(riso/r); riso -> r as r -> 0
        edge = None
        for i in range(npts):
            r = rs[i]
            h = dr

            def f(rr, y):
                dP, dm, dalp, driso = rhs(rr, y[0], y[1])
                # integrate ln(riso) - ln(r): d/dr = sqrt(A)/r - 1/r
                dl = (driso - 1.0 / rr) if rr > 1e-12 else 0.0
                return np.array([dP, dm, dalp, dl])

            y = np.array([P[i], m[i], lnalp[i], lnriso[i]])
            k1 = f(r + 1e-30, y)
            k2 = f(r + 0.5 * h, y + 0.5 * h * k1)
            k3 = f(r + 0.5 * h, y + 0.5 * h * k2)
            k4 = f(r + h, y + h * k3)
            y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            P[i + 1], m[i + 1], lnalp[i + 1], lnriso[i + 1] = y
            if P[i + 1] <= pfloor and edge is None:
                edge = i + 1
                break
        if edge is None:
            raise RuntimeError("TOV: star surface not found; raise rmax")

        n = edge + 1
        self.R = rs[:n]
        self.P = np.maximum(P[:n], 0.0)
        self.m = m[:n]
        self.R_edge = rs[edge]
        self.M = m[edge]
        # exact exterior lapse fixes the additive constant:
        # alpha(R_edge) = sqrt(1 - 2M/R)
        alp = np.exp(lnalp[:n])
        alp *= np.sqrt(1.0 - 2.0 * self.M / self.R_edge) / alp[-1]
        self.alpha = alp
        # isotropic radius: riso = r * exp(lnriso + C); match exterior
        # Schwarzschild isotropic riso_edge = 0.5*(R - M + sqrt(R(R-2M)))
        riso_raw = self.R * np.exp(lnriso[:n])
        riso_raw[0] = 0.0
        riso_edge_exact = 0.5 * (self.R_edge - self.M
                                 + np.sqrt(self.R_edge
                                           * (self.R_edge - 2 * self.M)))
        scale = riso_edge_exact / riso_raw[-1]
        self.R_iso = riso_raw * scale
        self.R_edge_iso = riso_edge_exact

    # ------------------------------------------------------------------
    def sample_iso(self, r_iso):
        """(rho, P, m, alpha, psi4) at isotropic radii (vectorized).

        Interior: linear interpolation of the integrated profile.
        Exterior: Schwarzschild in isotropic coordinates
        (reference: tov.hpp GetPrimitivesAtIsoPoint + FindSchwarzschildR).
        """
        r_iso = np.asarray(r_iso, dtype=np.float64)
        inside = r_iso < self.R_edge_iso
        # interior interpolation on the R_iso grid
        P = np.interp(r_iso, self.R_iso, self.P, right=0.0)
        m = np.interp(r_iso, self.R_iso, self.m, right=self.M)
        alp = np.interp(r_iso, self.R_iso, self.alpha)
        R_areal = np.interp(r_iso, self.R_iso, self.R)
        # exterior closed forms
        re = np.maximum(r_iso, 1e-30)
        psi_ext = 1.0 + self.M / (2.0 * re)
        R_ext = re * psi_ext ** 2
        alp_ext = (1.0 - self.M / (2.0 * re)) / (1.0 + self.M / (2.0 * re))
        P = np.where(inside, P, 0.0)
        m = np.where(inside, m, self.M)
        alp = np.where(inside, alp, alp_ext)
        R_areal = np.where(inside, R_areal, R_ext)
        rho = self.eos.cold_rho_from_p_np(P)
        # conformal factor: psi^4 = (R/riso)^2 everywhere (the metric is
        # conformally flat in isotropic coordinates)
        psi4 = np.where(r_iso > 1e-12, (R_areal / re) ** 2,
                        (1.0 + self.M / (2.0 * max(self.R_iso[1], 1e-10)))
                        ** 4)
        # center: psi4 smooth limit via first interior sample
        if np.any(r_iso <= 1e-12):
            c = (self.R[1] / self.R_iso[1]) ** 2
            psi4 = np.where(r_iso <= 1e-12, c, psi4)
        return rho, P, m, alp, psi4
