"""Two-puncture (Bowen-York) initial data for Z4c.

Counterpart of ``athenak_tpu/pgen/z4c_two_punctures.py`` (reference:
src/pgen/z4c/two_punctures/, which links the external TwoPunctures
spectral solver; the JAX package replaces it with the Brandt-Bruegmann
puncture construction solved numerically):

  psi     = 1 + m1/(2 r1) + m2/(2 r2) + u
  A~^ij   = Bowen-York (linear momenta P_i and spins S_i per puncture)
  Delta u = -(1/8) A~_ij A~^ij (psi_BL + u)^(-7)

with the correction ``u`` obtained by red-black SOR on an auxiliary
uniform cube and interpolated onto the (possibly refined) mesh.  For
P = S = 0 this reduces to the analytic Brill-Lindquist solution (u = 0).

The SOR sweeps run as torch ops in float64 on the run's device (the JAX
package runs them in numpy: ``tp_npoints`` 64 x ``tp_iterations`` 4000
half-sweeps of 64^3 cells, each with a ``pow(-7)`` over the cube); the
cube's set-up and the interpolation onto the mesh stay numpy on the
host, and the solution crosses to the host once.  The keys read are
``punc_ADM_mass_{1,2}``, ``punc{n}_x{d}``, ``punc{n}_P_x{d}`` and
``punc{n}_S_x{d}``, as in the JAX package.

Gauge: precollapsed lapse alpha = psi^-2, zero shift; trace-free
Bowen-York curvature means Khat = Theta = 0 and
At_ij = psi^-6 A~_ij (chi = psi^-4 convention).
"""

from __future__ import annotations

import numpy as np
import torch

from ..z4c.z4c import (I_ALPHA, I_AXX, I_CHI, I_GXX, I_GYY, I_GZZ, NZ4C,
                       sym_idx)
from . import to_device


def _bowen_york(X, m, centers, Ps, Ss):
    """A~_ij (conformal, flat-index) summed over punctures (Bowen &
    York 1980): momentum and spin terms."""
    At = [np.zeros_like(X[0]) for _ in range(6)]
    for (c, P, S) in zip(centers, Ps, Ss):
        dx = [X[a] - c[a] for a in range(3)]
        r = np.sqrt(dx[0] ** 2 + dx[1] ** 2 + dx[2] ** 2)
        r = np.maximum(r, 1e-12)
        n = [dx[a] / r for a in range(3)]
        Pn = sum(P[a] * n[a] for a in range(3))
        # spin term: (3/r^3)(eps_kil S^k n^l n_j + eps_kjl S^k n^l n_i)
        eps = np.zeros((3, 3, 3))
        eps[0, 1, 2] = eps[1, 2, 0] = eps[2, 0, 1] = 1.0
        eps[0, 2, 1] = eps[2, 1, 0] = eps[1, 0, 2] = -1.0
        Sn = [sum(eps[k, a, l] * S[k] * n[l]
                  for k in range(3) for l in range(3)) for a in range(3)]
        for a in range(3):
            for b in range(a, 3):
                d_ab = 1.0 if a == b else 0.0
                mom = (3.0 / (2.0 * r * r)) * (
                    P[a] * n[b] + P[b] * n[a] - (d_ab - n[a] * n[b]) * Pn)
                spin = (3.0 / r ** 3) * (Sn[a] * n[b] + Sn[b] * n[a])
                At[sym_idx(a, b)] += mom + spin
    return At


def _solve_u(domain, centers, masses, Ps, Ss, N=64, iters=4000,
             omega=1.8, device="cpu"):
    """Red-black SOR for the puncture correction u on an auxiliary
    uniform cube; Dirichlet u=0 on the (far) boundary.  The sweeps run in
    float64 torch ops on ``device``, each value as the numpy sweeps of
    the JAX package form it; returns (xs, ys, zs, u) on the host, or None
    for Brill-Lindquist data."""
    (x0, x1, y0, y1, z0, z1) = domain
    xs = np.linspace(x0, x1, N)
    ys = np.linspace(y0, y1, N)
    zs = np.linspace(z0, z1, N)
    h = xs[1] - xs[0]
    Z, Y, Xg = np.meshgrid(zs, ys, xs, indexing="ij")
    X = [Xg, Y, Z]
    psi_bl = 1.0 + sum(
        m / (2.0 * np.maximum(np.sqrt((Xg - c[0]) ** 2 + (Y - c[1]) ** 2
                                      + (Z - c[2]) ** 2), 1e-12))
        for m, c in zip(masses, centers))
    At = _bowen_york(X, masses, centers, Ps, Ss)
    Asq = sum((1.0 if a == b else 2.0) * At[sym_idx(a, b)] ** 2
              for a in range(3) for b in range(a, 3))
    if float(Asq.max()) == 0.0:
        return None  # Brill-Lindquist: u = 0 analytic

    # checkerboard masks
    ii, jj, kk = np.meshgrid(np.arange(N), np.arange(N), np.arange(N),
                             indexing="ij")
    red = ((ii + jj + kk) % 2 == 0)
    interior = np.zeros_like(red)
    interior[1:-1, 1:-1, 1:-1] = True

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    psi = dev(psi_bl)
    # -(1/8) Asq, the same product every sweep forms first
    src = dev(-(1.0 / 8.0) * Asq)
    hh = float(h * h)
    masks = [torch.as_tensor(m & interior, device=device)
             for m in (red, ~red)]
    u = torch.zeros_like(psi)

    def sweep(u, m):
        rhs = src * (psi + u) ** (-7.0)
        nb = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
              + torch.roll(u, 1, 1) + torch.roll(u, -1, 1)
              + torch.roll(u, 1, 2) + torch.roll(u, -1, 2))
        gs = (nb - hh * rhs) / 6.0
        return torch.where(m, (1.0 - omega) * u + omega * gs, u)

    for _ in range(iters // 2):
        u = sweep(u, masks[0])
        u = sweep(u, masks[1])
    return (xs, ys, zs, u.cpu().numpy())


def _interp_u(sol, pts_x, pts_y, pts_z):
    xs, ys, zs, u = sol
    N = len(xs)

    def frac(p, g):
        f = (p - g[0]) / (g[1] - g[0])
        i = np.clip(np.floor(f).astype(int), 0, N - 2)
        return i, np.clip(f - i, 0.0, 1.0)

    i, ai = frac(pts_x, xs)
    j, aj = frac(pts_y, ys)
    k, ak = frac(pts_z, zs)
    out = np.zeros_like(pts_x)
    for dk in (0, 1):
        for dj in (0, 1):
            for di in (0, 1):
                w = ((ak if dk else 1 - ak) * (aj if dj else 1 - aj)
                     * (ai if di else 1 - ai))
                out += w * u[k + dk, j + dj, i + di]
    return out


def init(pin, mesh, phys):
    gor = pin.get_or_add_real
    masses = [gor("problem", "punc_ADM_mass_1", 0.5),
              gor("problem", "punc_ADM_mass_2", 0.5)]
    centers = [[gor("problem", f"punc{n}_x{d}", 0.0)
                for d in (1, 2, 3)] for n in (1, 2)]
    Ps = [[gor("problem", f"punc{n}_P_x{d}", 0.0)
           for d in (1, 2, 3)] for n in (1, 2)]
    Ss = [[gor("problem", f"punc{n}_S_x{d}", 0.0)
           for d in (1, 2, 3)] for n in (1, 2)]
    ntp = pin.get_or_add_integer("problem", "tp_npoints", 64)
    tp_iters = pin.get_or_add_integer("problem", "tp_iterations", 4000)

    ms = mesh.mesh_size
    sol = _solve_u((ms.x1min, ms.x1max, ms.x2min, ms.x2max,
                    ms.x3min, ms.x3max), centers, masses, Ps, Ss,
                   N=ntp, iters=tp_iters, device=phys.device)

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    z = np.zeros((nmb, NZ4C, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        X3, X2, X1 = np.meshgrid(x3v, x2v, x1v, indexing="ij")
        psi_bl = 1.0 + sum(
            m / (2.0 * np.maximum(
                np.sqrt((X1 - c[0]) ** 2 + (X2 - c[1]) ** 2
                        + (X3 - c[2]) ** 2), 1e-12))
            for m, c in zip(masses, centers))
        if sol is not None:
            ucorr = _interp_u(sol, X1.reshape(-1), X2.reshape(-1),
                              X3.reshape(-1)).reshape(X1.shape)
        else:
            ucorr = 0.0
        psi = psi_bl + ucorr
        At = _bowen_york([X1, X2, X3], masses, centers, Ps, Ss)

        z[gid, I_CHI] = psi ** phys.opt.chi_psi_power
        z[gid, I_GXX] = 1.0
        z[gid, I_GYY] = 1.0
        z[gid, I_GZZ] = 1.0
        # At_ij = chi * (K_ij - g_ij K/3) = psi^-6 A~_ij (K = 0)
        for c6 in range(6):
            z[gid, I_AXX + c6] = psi ** (-6.0) * At[c6]
        z[gid, I_ALPHA] = psi ** (-2.0)

    return phys.make_state(to_device(phys, z))
