"""Apparent-horizon finder: spectral fast-flow on a Gauss-Legendre
sphere.

Counterpart of ``athenak_tpu/z4c/ahf.py``, a copy kept in the port: the
reference ``FastFlow`` class (reference:
src/z4c/fastflow.cpp, after Gundlach 1998's fast-flow method): the
horizon shape r(theta,phi) = sum a_lm Y_lm flows down the expansion
Theta until the marginally-outer-trapped surface Theta = 0 is found;
the flow update damps each multipole as a_lm -= A/(1+B l(l+1)) <Theta
Y_lm>.  Outputs: area, irreducible and Christodoulou masses, spin from
the flat rotational Killing integrands, mean/min radius.

Host-side numpy implementation (the finder runs every ``compute_dt``,
not per cycle); the ADM fields are formed on the state's device
(``adm_fields_from_z4c``), fetched once a call, and the surface
interpolation is vectorized over all quadrature points.  As in the JAX
package, no run calls the finder: it is a tool for a state in hand.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from .z4c import sym_idx


def _det6(g3d):
    """det of a symmetric 3-metric given as its six components."""
    gxx, gxy, gxz, gyy, gyz, gzz = g3d
    return (gxx * (gyy * gzz - gyz * gyz)
            - gxy * (gxy * gzz - gyz * gxz)
            + gxz * (gxy * gyz - gyy * gxz))


def _inv6(g3d, detg):
    """The six components of the inverse of a symmetric 3-metric."""
    gxx, gxy, gxz, gyy, gyz, gzz = g3d
    i = 1.0 / detg
    return [(gyy * gzz - gyz * gyz) * i,
            (gxz * gyz - gxy * gzz) * i,
            (gxy * gyz - gyy * gxz) * i,
            (gxx * gzz - gxz * gxz) * i,
            (gxy * gxz - gxx * gyz) * i,
            (gxx * gyy - gxy * gxy) * i]


# --------------------------------------------------------------------------
# real spherical harmonics with theta/phi derivatives (lmax small)
# --------------------------------------------------------------------------
def _legendre_tables(lmax: int, costh: np.ndarray):
    """Associated Legendre P_l^m(x) for 0<=m<=l<=lmax via standard
    recurrences; returns dict[(l,m)] arrays."""
    x = costh
    sx = np.sqrt(np.maximum(1.0 - x * x, 1e-300))
    P: Dict = {}
    P[(0, 0)] = np.ones_like(x)
    for m in range(1, lmax + 1):
        P[(m, m)] = -(2 * m - 1) * sx * P[(m - 1, m - 1)]
    for m in range(0, lmax):
        P[(m + 1, m)] = (2 * m + 1) * x * P[(m, m)]
    for m in range(0, lmax + 1):
        for ll in range(m + 2, lmax + 1):
            P[(ll, m)] = ((2 * ll - 1) * x * P[(ll - 1, m)]
                          - (ll + m - 1) * P[(ll - 2, m)]) / (ll - m)
    return P


def ylm_tables(lmax: int, theta: np.ndarray, phi: np.ndarray):
    """Real spherical harmonics and their first/second theta-phi
    derivatives at the quadrature points.

    Returns dict with Y0[l], Yc[l][m], Ys[l][m] (m>=1) and derivative
    tables; convention matches the reference (orthonormal real Ylm)."""
    x = np.cos(theta)
    sinth = np.sin(theta)
    P = _legendre_tables(lmax + 1, x)

    def norm(ll, m):
        f = math.sqrt((2 * ll + 1) / (4.0 * math.pi)
                      * math.factorial(ll - m) / math.factorial(ll + m))
        return f * (math.sqrt(2.0) if m > 0 else 1.0)

    def dP_dth(ll, m):
        # dP/dtheta = (l x P_l^m - (l+m) P_{l-1}^m)/sin(theta) * (-1)...
        # use: dP_l^m/dtheta = (1/sinth)*(l*x*P_l^m - (l+m)*P_{l-1}^m)
        pm1 = P[(ll - 1, m)] if ll - 1 >= m else np.zeros_like(x)
        return -(ll * x * P[(ll, m)] - (ll + m) * pm1) / np.maximum(
            sinth, 1e-300) * (-1.0)

    out = {"Y0": {}, "Yc": {}, "Ys": {}, "dY0": {}, "dYc": {},
           "dYs": {}, "d2Y0": {}, "d2Yc": {}, "d2Ys": {}}
    for ll in range(lmax + 1):
        for m in range(0, ll + 1):
            N = norm(ll, m)
            p = N * P[(ll, m)]
            dp = N * dP_dth(ll, m)
            # second theta derivative from the spherical ODE:
            # d2Y = -cot(th) dY + (m^2/sin^2 - l(l+1)) Y
            cot = x / np.maximum(sinth, 1e-300)
            d2p = -cot * dp + (m * m / np.maximum(sinth * sinth, 1e-300)
                               - ll * (ll + 1)) * p
            if m == 0:
                out["Y0"][ll] = p
                out["dY0"][ll] = dp
                out["d2Y0"][ll] = d2p
            else:
                cm, sm = np.cos(m * phi), np.sin(m * phi)
                out["Yc"][(ll, m)] = p * cm
                out["Ys"][(ll, m)] = p * sm
                out["dYc"][(ll, m)] = (dp * cm, -m * p * sm)   # (dth, dph)
                out["dYs"][(ll, m)] = (dp * sm, m * p * cm)
                out["d2Yc"][(ll, m)] = (d2p * cm, -m * dp * sm,
                                        -m * m * p * cm)  # (th2, thph, ph2)
                out["d2Ys"][(ll, m)] = (d2p * sm, m * dp * cm,
                                        -m * m * p * sm)
    return out


# --------------------------------------------------------------------------
# leaf-aware interpolation of block fields to points
# --------------------------------------------------------------------------
def interp_fields(mesh, fields, pts):
    """Trilinear interpolation of a list of [nmb, n3, n2, n1] arrays to
    points [npts, 3]; works on uniform and refined meshes (the owning
    leaf is resolved per point)."""
    mbi = mesh.mb_indcs
    ms = mesh.mesh_size
    flds = [np.asarray(f) for f in fields]
    npts = len(pts)
    out = np.zeros((len(flds), npts))
    levloc = {}
    for gid in range(mesh.nmb_total):
        l = mesh.lloc_eachmb[gid]
        lev = int(mesh.mb_lev[gid]) if hasattr(mesh, "mb_lev") else 0
        levloc[(lev, int(l[0]), int(l[1]), int(l[2]))] = gid
    max_lev = int(mesh.mb_lev.max()) if hasattr(mesh, "mb_lev") else 0
    nrbx = (mesh.nmb_x1, mesh.nmb_x2, mesh.nmb_x3)
    sizes = (ms.x1max - ms.x1min, ms.x2max - ms.x2min,
             ms.x3max - ms.x3min)
    mins = (ms.x1min, ms.x2min, ms.x3min)

    for n in range(npts):
        x, y, z = pts[n]
        gid = None
        for lev in range(max_lev, -1, -1):
            nb = [nrbx[d] << lev for d in range(3)]
            ll = [min(int((([x, y, z][d] - mins[d]) / sizes[d])
                          * nb[d]), nb[d] - 1) for d in range(3)]
            key = (lev, ll[0], ll[1], ll[2])
            if key in levloc:
                gid = levloc[key]
                break
        if gid is None:
            continue
        x1v, x2v, x3v = mesh.cell_centers(gid)
        dx1 = x1v[1] - x1v[0]
        dx2 = x2v[1] - x2v[0] if len(x2v) > 1 else 1.0
        dx3 = x3v[1] - x3v[0] if len(x3v) > 1 else 1.0
        fi = (x - x1v[0]) / dx1
        fj = (y - x2v[0]) / dx2
        fk = (z - x3v[0]) / dx3
        i = int(np.clip(np.floor(fi), 0, mbi.ncells1 - 2))
        j = int(np.clip(np.floor(fj), 0, mbi.ncells2 - 2))
        k = int(np.clip(np.floor(fk), 0, mbi.ncells3 - 2))
        ai, aj, ak = fi - i, fj - j, fk - k
        w = np.array([(1 - ak) * (1 - aj) * (1 - ai),
                      (1 - ak) * (1 - aj) * ai,
                      (1 - ak) * aj * (1 - ai),
                      (1 - ak) * aj * ai,
                      ak * (1 - aj) * (1 - ai),
                      ak * (1 - aj) * ai,
                      ak * aj * (1 - ai),
                      ak * aj * ai])
        for fidx, f in enumerate(flds):
            c = f[gid, k:k + 2, j:j + 2, i:i + 2].reshape(8)
            out[fidx, n] = float(c @ w)
    return out


# --------------------------------------------------------------------------
# the finder
# --------------------------------------------------------------------------
class FastFlow:
    """Spectral fast-flow apparent-horizon finder (reference:
    src/z4c/fastflow.cpp)."""

    def __init__(self, lmax: int = 8, ntheta: int = 20,
                 flow_iterations: int = 200, flow_ab_const: float = 1.0,
                 mass_tol: float = 1e-6, hmean_tol: float = 100.0,
                 verbose: bool = False) -> None:
        self.lmax = lmax
        self.flow_iterations = flow_iterations
        self.ab_const = flow_ab_const
        self.mass_tol = mass_tol
        self.hmean_tol = hmean_tol
        self.verbose = verbose

        # Gauss-Legendre x uniform-phi quadrature sphere
        xg, wg = np.polynomial.legendre.leggauss(ntheta)
        nphi = 2 * ntheta
        phi = (np.arange(nphi) + 0.5) * (2.0 * math.pi / nphi)
        TH, PH = np.meshgrid(np.arccos(xg), phi, indexing="ij")
        self.theta = TH.reshape(-1)
        self.phi = PH.reshape(-1)
        W = np.broadcast_to(wg[:, None] * (2.0 * math.pi / nphi),
                            TH.shape)
        self.weights = W.reshape(-1).copy()
        self.Y = ylm_tables(lmax, self.theta, self.phi)
        self.last_a0: Optional[float] = None

    # ------------------------------------------------------------------
    def _radii(self, a0, ac, as_):
        Y = self.Y
        rr = sum(a0[ll] * Y["Y0"][ll] for ll in range(self.lmax + 1))
        rr_th = sum(a0[ll] * Y["dY0"][ll] for ll in range(self.lmax + 1))
        rr_ph = np.zeros_like(rr)
        for (ll, m), yc in Y["Yc"].items():
            rr = rr + ac[(ll, m)] * yc + as_[(ll, m)] * Y["Ys"][(ll, m)]
            rr_th = rr_th + ac[(ll, m)] * Y["dYc"][(ll, m)][0] \
                + as_[(ll, m)] * Y["dYs"][(ll, m)][0]
            rr_ph = rr_ph + ac[(ll, m)] * Y["dYc"][(ll, m)][1] \
                + as_[(ll, m)] * Y["dYs"][(ll, m)][1]
        return rr, rr_th, rr_ph

    # ------------------------------------------------------------------
    def find(self, mesh, adm_fields, center=(0.0, 0.0, 0.0),
             r_guess: Optional[float] = None):
        """Run the flow.  ``adm_fields``: dict with g3d[6], K_dd[6]
        block arrays (+ dg[3][6] precomputed metric derivatives).
        Returns dict of horizon properties or None."""
        lmax = self.lmax
        Y = self.Y
        g3d = adm_fields["g3d"]
        K_dd = adm_fields["K_dd"]
        dg = adm_fields["dg"]          # dg[d][c] arrays

        # spectral coefficients
        a0 = np.zeros(lmax + 1)
        ac = {k: 0.0 for k in Y["Yc"]}
        as_ = {k: 0.0 for k in Y["Yc"]}
        if r_guess is None:
            r_guess = self.last_a0 / math.sqrt(4 * math.pi) \
                if self.last_a0 else 1.0
        a0[0] = r_guess * math.sqrt(4.0 * math.pi)

        alpha = self.ab_const
        beta = 0.5 * self.ab_const
        A = alpha / (lmax * (lmax + 1)) + beta
        B = beta / alpha
        ABfac = np.array([A / (1.0 + B * ll * (ll + 1))
                          for ll in range(lmax + 1)])

        sinth, costh = np.sin(self.theta), np.cos(self.theta)
        sinph, cosph = np.sin(self.phi), np.cos(self.phi)
        found = False
        mass_prev = 0.0
        props = None
        for it in range(self.flow_iterations):
            rr, rr_th, rr_ph = self._radii(a0, ac, as_)
            if rr.min() < 1e-8 or not np.isfinite(rr).all():
                return None
            xp = rr * sinth * cosph + center[0]
            yp = rr * sinth * sinph + center[1]
            zp = rr * costh + center[2]
            pts = np.stack([xp, yp, zp], axis=1)
            vals = interp_fields(mesh, list(g3d) + list(K_dd)
                                 + [dg[d][c] for d in range(3)
                                    for c in range(6)], pts)
            gi = vals[0:6]
            Ki = vals[6:12]
            dgi = vals[12:].reshape(3, 6, -1)

            H, u, R, deth, TrK = self._expansion(
                rr, rr_th, rr_ph, a0, ac, as_, gi, Ki, dgi, center,
                xp - center[0], yp - center[1], zp - center[2])
            rho = H * u  # flowflag 2 (reference default "fast" flow)
            # the quadrature weights carry the d(cos th) measure, while
            # sqrt(deth) is the area density per dth dph: divide out one
            # sin(th) (reference: fastflow.cpp:1364 da = w sqrt(deth)/sinth)
            dA_el = np.sqrt(np.maximum(deth, 0.0)) \
                / np.maximum(sinth, 1e-300)
            area = float(np.sum(self.weights * dA_el))
            hmean = float(np.sum(self.weights * rho))
            if not np.isfinite(area) or not np.isfinite(hmean):
                return None
            if abs(hmean) > self.hmean_tol:
                return None
            mass = math.sqrt(area / (16.0 * math.pi))
            if mass < 1e-10:
                return None
            # spin integrand (flat rotational KVs)
            xr, yr, zr = xp - center[0], yp - center[1], zp - center[2]
            phiv = {"x": (np.zeros_like(xr), -zr, yr),
                    "y": (zr, np.zeros_like(xr), -xr),
                    "z": (-yr, xr, np.zeros_like(xr))}
            S = {}
            for k2, pv in phiv.items():
                intS = sum(pv[a] * R[b] * Ki[sym_idx(a, b)]
                           for a in range(3) for b in range(3))
                S[k2] = float(np.sum(self.weights * intS * dA_el)
                              / (8.0 * math.pi))
            Smag = math.sqrt(S["x"] ** 2 + S["y"] ** 2 + S["z"] ** 2)
            props = {
                "area": area, "mass_irr": mass,
                "mass": math.sqrt(mass * mass
                                  + 0.25 * (Smag / mass) ** 2
                                  ) if Smag < mass * mass * 2 else mass,
                "Sx": S["x"], "Sy": S["y"], "Sz": S["z"], "S": Smag,
                "mean_radius": a0[0] / math.sqrt(4 * math.pi),
                "min_radius": float(rr.min()),
                "hmean": hmean, "iterations": it,
            }
            if abs(mass_prev - mass) < self.mass_tol:
                found = True
                break
            mass_prev = mass

            # flow update of the spectral coefficients
            drho = self.weights * rho
            for ll in range(lmax + 1):
                a0[ll] -= ABfac[ll] * float(np.sum(drho * Y["Y0"][ll]))
                for m in range(1, ll + 1):
                    ac[(ll, m)] -= ABfac[ll] * float(
                        np.sum(drho * Y["Yc"][(ll, m)]))
                    as_[(ll, m)] -= ABfac[ll] * float(
                        np.sum(drho * Y["Ys"][(ll, m)]))

        if not found:
            return None
        self.last_a0 = a0[0]
        return props

    # ------------------------------------------------------------------
    def _expansion(self, rr, rr_th, rr_ph, a0, ac, as_, gi, Ki, dgi,
                   center, xp, yp, zp):
        """Expansion Theta of the level set F = r - h(theta,phi)
        (reference: SurfaceIntegrals, fastflow.cpp:956-1290)."""
        lmax = self.lmax
        Y = self.Y
        detg = _det6(list(gi))
        ginv = _inv6(list(gi), detg)
        TrK = sum(np.asarray(ginv[sym_idx(a, b)]) * Ki[sym_idx(a, b)]
                  for a in range(3) for b in range(3))

        rp = np.sqrt(xp * xp + yp * yp + zp * zp)
        rhop = np.sqrt(np.maximum(xp * xp + yp * yp, 1e-300))
        irp = 1.0 / np.maximum(rp, 1e-10)
        irp3 = irp ** 3
        irho = 1.0 / rhop

        drdi = [xp * irp, yp * irp, zp * irp]
        dthdi = [zp * xp * irp * irp * irho, zp * yp * irp * irp * irho,
                 -rhop * irp * irp]
        dphdi = [-yp * irho * irho, xp * irho * irho, np.zeros_like(xp)]

        drdidj = {(0, 0): irp - xp * xp * irp3,
                  (0, 1): -xp * yp * irp3,
                  (0, 2): -xp * zp * irp3,
                  (1, 1): irp - yp * yp * irp3,
                  (1, 2): -yp * zp * irp3,
                  (2, 2): irp - zp * zp * irp3}
        i4 = irp ** 4
        irho3 = irho ** 3
        dthdidj = {
            (0, 0): zp * (-2 * xp ** 4 - xp * xp * yp * yp + yp ** 4
                          + zp * zp * yp * yp) * i4 * irho3,
            (0, 1): -xp * yp * zp * (3 * xp * xp + 3 * yp * yp
                                     + zp * zp) * i4 * irho3,
            (0, 2): xp * (xp * xp + yp * yp - zp * zp) * i4 * irho,
            (1, 1): zp * (-2 * yp ** 4 - yp * yp * xp * xp + xp ** 4
                          + zp * zp * xp * xp) * i4 * irho3,
            (1, 2): yp * (xp * xp + yp * yp - zp * zp) * i4 * irho,
            (2, 2): 2 * zp * rhop * i4}
        dphdidj = {(0, 0): 2 * yp * xp * irho ** 4,
                   (0, 1): (yp * yp - xp * xp) * irho ** 4,
                   (0, 2): np.zeros_like(xp),
                   (1, 1): -2 * yp * xp * irho ** 4,
                   (1, 2): np.zeros_like(xp),
                   (2, 2): np.zeros_like(xp)}

        # dh/dth, dh/dph and second derivatives from the Ylm expansion
        h_th = rr_th
        h_ph = rr_ph
        h_th2 = sum(a0[ll] * Y["d2Y0"][ll] for ll in range(lmax + 1))
        h_thph = np.zeros_like(rr)
        h_ph2 = np.zeros_like(rr)
        for (ll, m) in Y["Yc"]:
            c = ac[(ll, m)]
            s = as_[(ll, m)]
            h_th2 = h_th2 + c * Y["d2Yc"][(ll, m)][0] \
                + s * Y["d2Ys"][(ll, m)][0]
            h_thph = h_thph + c * Y["d2Yc"][(ll, m)][1] \
                + s * Y["d2Ys"][(ll, m)][1]
            h_ph2 = h_ph2 + c * Y["d2Yc"][(ll, m)][2] \
                + s * Y["d2Ys"][(ll, m)][2]

        dF = [drdi[a] - dthdi[a] * h_th - dphdi[a] * h_ph
              for a in range(3)]
        dFdidj = {}
        for a in range(3):
            for b in range(a, 3):
                dFdidj[(a, b)] = (
                    drdidj[(a, b)]
                    - dthdidj[(a, b)] * h_th
                    - dthdi[a] * (dthdi[b] * h_th2 + dphdi[b] * h_thph)
                    - dphdidj[(a, b)] * h_ph
                    - dphdi[a] * (dthdi[b] * h_thph + dphdi[b] * h_ph2))

        def sym(d, a, b):
            return d[(a, b) if a <= b else (b, a)]

        dF_u = [sum(np.asarray(ginv[sym_idx(a, b)]) * dF[b]
                    for b in range(3)) for a in range(3)]
        norm = sum(dF_u[a] * dF[a] for a in range(3))
        u = np.sqrt(np.maximum(norm, 0.0))
        divu = np.where(norm > 0, 1.0 / np.maximum(u, 1e-300), 0.0)

        # covariant Hessian
        nnF = {}
        for a in range(3):
            for b in range(a, 3):
                v = dFdidj[(a, b)]
                for d in range(3):
                    v = v - 0.5 * dF_u[d] * (
                        dgi[a][sym_idx(b, d)] + dgi[b][sym_idx(a, d)]
                        - dgi[d][sym_idx(a, b)])
                nnF[(a, b)] = v

        d2F = sum(np.asarray(ginv[sym_idx(a, b)]) * sym(nnF, a, b)
                  for a in range(3) for b in range(3))
        dFKdF = sum(dF_u[a] * dF_u[b] * Ki[sym_idx(a, b)]
                    for a in range(3) for b in range(3))
        dFnnF = sum(dF_u[a] * dF_u[b] * sym(nnF, a, b)
                    for a in range(3) for b in range(3))
        H = d2F * divu + dFKdF * divu ** 2 - dFnnF * divu ** 3 - TrK

        R = [dF_u[a] * divu for a in range(3)]

        # induced metric determinant for the surface element
        sinth, costh = np.sin(self.theta), np.cos(self.theta)
        sinph, cosph = np.sin(self.phi), np.cos(self.phi)
        dXdth = [(h_th * sinth + rr * costh) * cosph,
                 (h_th * sinth + rr * costh) * sinph,
                 h_th * costh - rr * sinth]
        dXdph = [(h_ph * cosph - rr * sinph) * sinth,
                 (h_ph * sinph + rr * cosph) * sinth,
                 h_ph * costh]
        h11 = sum(dXdth[a] * dXdth[b] * gi[sym_idx(a, b)]
                  for a in range(3) for b in range(3))
        h12 = sum(dXdth[a] * dXdph[b] * gi[sym_idx(a, b)]
                  for a in range(3) for b in range(3))
        h22 = sum(dXdph[a] * dXdph[b] * gi[sym_idx(a, b)]
                  for a in range(3) for b in range(3))
        deth = h11 * h22 - h12 * h12
        return H, u, R, deth, TrK


def adm_fields_from_z4c(z4c_mod, z):
    """(g3d, K_dd, dg) numpy block fields from a Z4c state ``z`` (a
    tensor): the ADM metric, curvature and metric derivatives formed on
    its device, then moved to the host."""
    from . import fd
    from .z4c import adm_from_z4c

    adm = adm_from_z4c(z4c_mod, z)
    ng = z4c_mod.ng
    idx = z4c_mod.idx
    dg = [[fd.d1(adm["g3d"][c], d, idx, ng) for c in range(6)]
          for d in range(3)]

    def host(t):
        return t.detach().cpu().numpy()

    return {"g3d": [host(c) for c in adm["g3d"]],
            "K_dd": [host(c) for c in adm["K_dd"]],
            "dg": [[host(c) for c in row] for row in dg]}
