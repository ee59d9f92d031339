"""Weyl scalar psi4 and gravitational-wave extraction.

Counterpart of ``athenak_tpu/z4c/weyl.py``: the Newman-Penrose psi4 on
the ADM slice
(reference: src/z4c/z4c_calculate_weyl_scalars.cpp:26-410 — Ricci from
metric derivatives, 4D Riemann via Gauss-Codazzi, Gram-Schmidt radial
tetrad, r-scaled projections) and the spin-weight -2 spherical-harmonic
decomposition on extraction spheres (reference: src/z4c/z4c_wave_extr.cpp
swsh() via the Wigner-d formula of arXiv:0709.0093 eqs II.7-II.8).

``weyl_scalars`` runs as torch ops on the state's device, the tensor
loops unrolled over channel views as in the Z4c right-hand side (the JAX
package runs jnp there, with no Pallas kernel); only the two psi4
channels cross to the host, at output cadence, where the sphere
decomposition runs in numpy on the geodesic grid with trilinear
interpolation (``ahf.interp_fields``, which finds the owning leaf on any
tiling, where the JAX package's lookup assumes one level, ROADMAP F11).
The puncture trackers are ``Z4c.post_cycle``'s, on the device.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from . import fd
from .ahf import interp_fields
from .z4c import spatial_det, spatial_inv


def _sym_pairs():
    return itertools.combinations_with_replacement(range(3), 2)


def weyl_scalars(z4c_mod, u):
    """(Re psi4, Im psi4) * r on all cells (valid in the interior).

    Follows reference z4c_calculate_weyl_scalars.cpp:140-408: ADM vars
    from the Z4c state, 3-Ricci, Gauss-Codazzi 4D Riemann pieces, and
    projection onto the Gram-Schmidt (radial, theta, phi) triad.
    """
    opt = z4c_mod.opt
    ng = z4c_mod.ng
    idx = z4c_mod.idx
    chi, gt, khat, A, gam, theta, alpha, beta = z4c_mod.unpack(u)

    chi_g = torch.clamp(chi, min=opt.chi_min_floor)
    psi4 = chi_g ** (4.0 / opt.chi_psi_power)
    K_tr = khat + 2.0 * theta
    # ADM variables (reference: z4c_adm.cpp Z4cToADM)
    g = [[psi4 * gt[a][b] for b in range(3)] for a in range(3)]
    Kdd = [[psi4 * A[a][b] + (K_tr / 3.0) * g[a][b]
            for b in range(3)] for a in range(3)]

    def D1(f, d):
        return fd.d1(f, d, idx, ng)

    dg = [[[D1(g[a][b], c) for b in range(3)] for a in range(3)]
          for c in range(3)]
    dK = [[[D1(Kdd[a][b], c) for b in range(3)] for a in range(3)]
          for c in range(3)]
    ddg = {}
    for a, b in _sym_pairs():
        for c, d in _sym_pairs():
            if a == b:
                ddg[(a, b, c, d)] = fd.d2(g[c][d], a, idx, ng)
            else:
                ddg[(a, b, c, d)] = fd.d1d1(g[c][d], a, b, idx, ng)

    def DDg(a, b, c, d):
        a, b = (a, b) if a <= b else (b, a)
        c, d = (c, d) if c <= d else (d, c)
        return ddg[(a, b, c, d)]

    detg = spatial_det(g)
    gu = spatial_inv(g, detg)

    Gddd = [[[0.5 * (dg[a][b][c] + dg[b][a][c] - dg[c][a][b])
              for b in range(3)] for a in range(3)] for c in range(3)]
    Gudd = [[[sum(gu[c][d] * Gddd[d][a][b] for d in range(3))
              for b in range(3)] for a in range(3)] for c in range(3)]

    # 3-Ricci (reference: weyl scalars version, lines 197-221)
    Rdd = [[None] * 3 for _ in range(3)]
    for a, b in _sym_pairs():
        r = sum(gu[c][d] * (Gudd[e][a][c] * Gddd[e][b][d]
                            - Gudd[e][a][b] * Gddd[e][c][d])
                for c in range(3) for d in range(3) for e in range(3))
        r = r + sum(0.5 * gu[c][d] * (
            - DDg(c, d, a, b) - DDg(a, b, c, d)
            + DDg(a, c, b, d) + DDg(b, c, a, d))
            for c in range(3) for d in range(3))
        Rdd[a][b] = r
        Rdd[b][a] = r
    R = sum(gu[a][b] * Rdd[a][b] for a in range(3) for b in range(3))

    K = sum(gu[a][b] * Kdd[a][b] for a in range(3) for b in range(3))
    # covariant derivative of K (reference lines 240-253)
    DKddd = [[[dK[a][b][c]
               - sum(Gudd[d][a][b] * Kdd[d][c] + Gudd[d][a][c] * Kdd[b][d]
                     for d in range(3))
               for c in range(3)] for b in range(3)] for a in range(3)]

    # tetrad (reference lines 256-340): radial/theta/phi Gram-Schmidt;
    # the coordinates formed in float64 on the host, then cast
    x1v, x2v, x3v = z4c_mod.coords_bcast()

    def dev(a):
        return torch.as_tensor(a, dtype=chi.dtype, device=chi.device)

    zero = torch.zeros_like(chi)
    xx = dev(np.where(x1v ** 2 + x2v ** 2 < 1e-10, x1v + 1e-8, x1v)) + zero
    yy = dev(x2v) + zero
    zz = dev(x3v) + zero
    uv = [xx, yy, zz]
    vv = [xx * zz, yy * zz, -(xx ** 2) - yy ** 2]
    wv = [-yy, xx, torch.zeros_like(xx)]

    def dot(p, q):
        return sum(g[a][b] * p[a] * q[b] for a in range(3) for b in range(3))

    wn = torch.sqrt(dot(wv, wv))
    wv = [w / wn for w in wv]
    d1p = dot(wv, uv)
    uv = [uv[a] - d1p * wv[a] for a in range(3)]
    un = torch.sqrt(dot(uv, uv))
    uv = [q / un for q in uv]
    d1p = dot(wv, vv)
    d2p = dot(uv, vv)
    vv = [vv[a] - d1p * wv[a] - d2p * uv[a] for a in range(3)]
    vn = torch.sqrt(dot(vv, vv))
    vv = [q / vn for q in vv]

    # Gauss-Codazzi pieces (reference lines 341-380)
    def riem4(a, b, c, d):
        return (g[a][c] * Rdd[b][d] + g[b][d] * Rdd[a][c]
                - g[a][d] * Rdd[b][c] - g[b][c] * Rdd[a][d]
                - 0.5 * R * (g[a][c] * g[b][d] - g[a][d] * g[b][c])
                + Kdd[a][c] * Kdd[b][d] - Kdd[a][d] * Kdd[b][c])

    def riem3n(a, b, c):  # Riemm4_ddd(a,b,c) = -(D_c K_ab - D_b K_ac)
        return -(DKddd[c][a][b] - DKddd[b][a][c])

    riem_nn = [[Rdd[a][b] + K * Kdd[a][b]
                - sum(gu[c][d] * Kdd[a][c] * Kdd[d][b]
                      for c in range(3) for d in range(3))
                for b in range(3)] for a in range(3)]

    rpsi4 = torch.zeros_like(chi)
    ipsi4 = torch.zeros_like(chi)
    for a in range(3):
        for b in range(3):
            re_pr = vv[a] * vv[b] - wv[a] * wv[b]
            im_pr = -vv[a] * wv[b] - wv[a] * vv[b]
            rpsi4 = rpsi4 - 0.25 * riem_nn[a][b] * re_pr
            ipsi4 = ipsi4 - 0.25 * riem_nn[a][b] * im_pr
            for c in range(3):
                rpsi4 = rpsi4 + 0.5 * riem3n(a, c, b) * uv[c] * re_pr
                ipsi4 = ipsi4 + 0.5 * riem3n(a, c, b) * uv[c] * im_pr
                for d in range(3):
                    proj = riem4(d, a, c, b) * uv[d] * uv[c]
                    rpsi4 = rpsi4 - 0.25 * proj * re_pr
                    ipsi4 = ipsi4 - 0.25 * proj * im_pr
    r = dev(np.sqrt(x1v ** 2 + x2v ** 2 + x3v ** 2)) + zero
    return rpsi4 * r, ipsi4 * r


# ---------------------------------------------------------------------------
# spin-weight -2 spherical harmonics (host side)
# ---------------------------------------------------------------------------
def swsh_m2(l: int, m: int, theta, phi):
    """s=-2 spin-weighted spherical harmonic via the Wigner-d sum
    (reference: z4c_wave_extr.cpp:46-58; arXiv:0709.0093 eq II.7-II.8).
    Returns (Re, Im) arrays."""
    fac = math.factorial
    k1 = max(m - 2, 0)
    k2 = min(l + m, l - 2)
    wig = np.zeros_like(np.asarray(theta, dtype=np.float64))
    for k in range(k1, k2 + 1):
        wig = wig + ((-1.0) ** k
                     * math.sqrt(fac(l + m) * fac(l - m)
                                 * fac(l + 2) * fac(l - 2))
                     * np.cos(theta / 2.0) ** (2 * l + m - 2 - 2 * k)
                     * np.sin(theta / 2.0) ** (2 * k + 2 - m)
                     / (fac(l + m - k) * fac(l - 2 - k)
                        * fac(k) * fac(k + 2 - m)))
    norm = math.sqrt((2 * l + 1) / (4.0 * math.pi))
    return norm * wig * np.cos(m * phi), norm * wig * np.sin(m * phi)


class WaveExtractor:
    """Decompose psi4 into (l, m) modes on extraction spheres.

    Reference: z4c_wave_extr.cpp WaveExtr() — interpolate psi4 onto a
    spherical grid, integrate against conj(sw Y^{-2}_{lm}) dOmega.  Here
    the sphere is the geodesic grid (exact solid-angle weights)."""

    def __init__(self, radii, lmax: int = 4, nlevel: int = 16) -> None:
        from ..radiation.geodesic_grid import GeodesicGrid
        self.radii = list(radii)
        self.lmax = lmax
        grid = GeodesicGrid(nlevel)
        self.dirs = np.asarray(grid.nh)        # [nang, 3] unit vectors
        self.weights = np.asarray(grid.solid_angles)  # sums to 4 pi
        x, y, z = self.dirs.T
        self.theta = np.arccos(np.clip(z, -1.0, 1.0))
        self.phi = np.arctan2(y, x)
        # precompute harmonics on the fixed angular grid
        self.ylm = {}
        for ll in range(2, lmax + 1):
            for mm in range(-ll, ll + 1):
                self.ylm[(ll, mm)] = swsh_m2(ll, mm, self.theta, self.phi)

    def modes(self, mesh, rpsi4, ipsi4):
        """[(radius, {(l,m): (re, im)})] mode amplitudes."""
        out = []
        for rad in self.radii:
            pts = rad * self.dirs
            re, im = interp_fields(mesh, [rpsi4, ipsi4], pts)
            modes = {}
            for key, (yr, yi) in self.ylm.items():
                # integral psi4 * conj(Y) dOmega
                modes[key] = (
                    float(np.sum(self.weights * (re * yr + im * yi))),
                    float(np.sum(self.weights * (im * yr - re * yi))))
            out.append((rad, modes))
        return out
