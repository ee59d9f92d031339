"""Self-gravity: the Poisson solve for the potential.

Counterpart of ``athenak_tpu/gravity.py`` (reference:
src/gravity/mg_gravity.cpp and the FAS driver of src/multigrid/; solved
every RK stage, driver.cpp:406-408).  ``make_gravity`` picks the solver:
on a uniform fully periodic mesh the global FFT (``SelfGravity``), else
the multigrid (``multigrid.MGPoisson``), or what ``<gravity>/solver``
names.  The FFT assembles the blocks into the global grid with the
Z-order permutation, divides by the eigenvalues of the second-order
finite-difference Laplacian (so that the difference gradient of phi
matches the source's discretisation) and scatters back; the mean mode
is removed (the Jeans swindle of a periodic box).  ``torch.fft`` does
the transforms, as the JAX package's ``jnp.fft`` does outside any
Pallas kernel; the ghost fill of phi takes the fill kernels B and G
where their gates admit the mesh.  The momentum and energy sources are
``srcterms.SourceTerms._self_gravity``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .comm import own_blocks, whole_blocks


def make_gravity(pin, mesh, device, dtype):
    """The solver of a ``<gravity>`` block (reference: MGGravityDriver,
    src/gravity/mg_gravity.cpp): the global FFT on a uniform periodic
    mesh, the multigrid otherwise or when asked for."""
    uniform = not mesh.multilevel and not mesh.adaptive
    periodic = all(v == "periodic" for v in mesh.mesh_bcs.values())
    default = "fft" if (uniform and periodic) else "multigrid"
    solver = pin.get_or_add_string("gravity", "solver", default)
    if solver == "fft":
        if mesh.multilevel:
            raise NotImplementedError(
                "self-gravity (fft) with static mesh refinement is not "
                "supported yet")
        return SelfGravity(pin, mesh, device, dtype)
    if solver == "multigrid":
        from .multigrid import MGPoisson
        return MGPoisson(pin, mesh, device, dtype)
    raise ValueError(f"gravity/solver={solver} (fft|multigrid)")


class SelfGravity:
    """The global FFT Poisson solve on a uniform periodic mesh."""

    def __init__(self, pin, mesh, device, dtype) -> None:
        self.mesh = mesh
        self.four_pi_G = pin.get_or_add_real("gravity", "four_pi_G", -1.0)
        if self.four_pi_G <= 0.0:
            raise ValueError(
                "gravity/four_pi_G must be set (reference: "
                "src/gravity/gravity.cpp:41-50)")
        for key in ("ix1", "ox1", "ix2", "ox2", "ix3", "ox3"):
            if mesh.mesh_bcs[key] != "periodic":
                raise NotImplementedError(
                    "FFT self-gravity requires fully periodic boundaries "
                    "(multigrid for other BCs lands with AMR)")
        device = torch.device(device)
        gn = mesh.mesh_indcs
        # block (lx3, lx2, lx1) -> gid permutation of the global assembly
        order = np.empty((mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1),
                         dtype=np.int64)
        for gid, loc in enumerate(mesh.lloc_eachmb):
            order[loc[2], loc[1], loc[0]] = gid
        order = order.ravel()
        inv = np.empty_like(order)
        inv[order] = np.arange(len(order))
        self._order = torch.as_tensor(order, device=device)
        self._inv_order = torch.as_tensor(inv, device=device)
        # the eigenvalues of the 2nd-order difference Laplacian,
        # sum_d (2 cos(k_d dx_d) - 2) / dx_d^2, in float64 on the host
        ms = mesh.mesh_size
        kx = 2.0 * math.pi * np.fft.fftfreq(gn.nx1)
        ky = 2.0 * math.pi * np.fft.fftfreq(max(gn.nx2, 1))
        kz = 2.0 * math.pi * np.fft.fftfreq(max(gn.nx3, 1))
        lam = ((2.0 * np.cos(kx)[None, None, :] - 2.0) / ms.dx1 ** 2
               + (2.0 * np.cos(ky)[None, :, None] - 2.0) / ms.dx2 ** 2
               + (2.0 * np.cos(kz)[:, None, None] - 2.0) / ms.dx3 ** 2)
        lam[0, 0, 0] = 1.0     # the mean mode is removed separately
        inv_lam = 1.0 / lam
        inv_lam[0, 0, 0] = 0.0
        self._inv_lam = torch.as_tensor(inv_lam, dtype=dtype, device=device)
        self.nsolve = 0

    def _to_global(self, f):
        """[nmb, n3a, n2a, n1a] block interiors -> the global grid."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        nb3, nb2, nb1 = mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1
        g = f[self._order].reshape(nb3, nb2, nb1, mbi.nx3, mbi.nx2, mbi.nx1)
        g = g.permute(0, 3, 1, 4, 2, 5)
        return g.reshape(nb3 * mbi.nx3, nb2 * mbi.nx2, nb1 * mbi.nx1)

    def _to_blocks(self, g):
        mesh = self.mesh
        mbi = mesh.mb_indcs
        nb3, nb2, nb1 = mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1
        g = g.reshape(nb3, mbi.nx3, nb2, mbi.nx2, nb1, mbi.nx1)
        g = g.permute(0, 2, 4, 1, 3, 5)
        f = g.reshape(nb3 * nb2 * nb1, mbi.nx3, mbi.nx2, mbi.nx1)
        return f[self._inv_order]

    def solve(self, u, bvals, phi0=None):
        """phi [nmb, 1, n3, n2, n1] with its ghosts filled: lap(phi) =
        four_pi_G (rho - <rho>) on the global grid.  On one rank's blocks
        the density of every block comes through one all-gather
        (``comm.whole_blocks``), every rank transforms the whole grid and
        keeps its own blocks' potential, whose ghosts the rank exchange
        fills: the float work of one rank, on the same data."""
        mbi = self.mesh.mb_indcs
        act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
               slice(mbi.is_, mbi.ie + 1))
        g = self._to_global(whole_blocks(u[(slice(None), 0) + act]))
        src = self.four_pi_G * (g - torch.mean(g))
        phi_k = torch.fft.fftn(src) * self._inv_lam.to(src.dtype)
        phi_g = torch.fft.ifftn(phi_k).real.to(u.dtype)
        phi = torch.zeros((u.shape[0], 1) + tuple(u.shape[2:]),
                          dtype=u.dtype, device=u.device)
        phi[(slice(None), 0) + act] = own_blocks(self._to_blocks(phi_g))
        self.nsolve += 1
        return bvals.fill_ghosts(phi)
