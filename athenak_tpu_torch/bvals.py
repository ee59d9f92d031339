"""Ghost-zone filling for cell-centred arrays: halo exchange + physical BCs.

Counterpart of ``athenak_tpu/bvals.py`` for single-level meshes
(reference: src/bvals/bvals_cc.cpp, src/bvals/physics/hydro_bcs.cpp).
The axes are swept in order x1, x2, x3; each sweep copies the full current
extent of the transverse axes, so edge and corner ghosts fill
transitively.  Every sweep reads only interior cells along its own axis,
which lets the port write the ghost slabs in place: ``fill_ghosts``
returns the tensor it was given, with its ghosts filled.

A single fully periodic block takes the fill kernel
(``ops/fill.py``, kernel B) and a same-level periodic pool of blocks the
pool-fill kernel (``ops/pool_fill.py``, kernel G) when the tensor lies
on the card in float32, the port's counterpart of the JAX package's TPU
gate.
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import gather_blocks
from .indices import IVX, IVY, IVZ
from .mesh import Mesh

# cell-axis position of each mesh axis in [nmb, nvar, x3, x2, x1] arrays
_AXIS_OF = {"x1": 4, "x2": 3, "x3": 2}
_NORMAL_VEL = {"x1": IVX, "x2": IVY, "x3": IVZ}


def _slc(axis: int, lo: int, hi: int):
    """Index of [lo, hi) along ``axis`` of a 5-D cell array."""
    idx = [slice(None)] * 5
    idx[axis] = slice(lo, hi)
    return tuple(idx)


def kernel_dtype_ok(t) -> bool:
    """The fill and stage kernels run on float32 tensors on the card."""
    return t.is_cuda and t.dtype == torch.float32


class BoundaryValues:
    """Neighbour tables and BC appliers for cell-centred arrays."""

    def __init__(self, mesh: Mesh) -> None:
        self.mesh = mesh
        mbi = mesh.mb_indcs
        self.ng = mbi.ng
        self.active_axes = [ax for ax, nx in
                            (("x1", mbi.nx1), ("x2", mbi.nx2),
                             ("x3", mbi.nx3)) if nx > 1]
        self.nbr = {k: np.asarray(v) for k, v in mesh.nbr_gid.items()}
        self.mask = {k: np.asarray(v) for k, v in mesh.phys_bc_mask.items()}
        self.any_phys = {k: bool(v.any())
                         for k, v in mesh.phys_bc_mask.items()}
        self.flag = {
            "x1m": mesh.mesh_bcs["ix1"], "x1p": mesh.mesh_bcs["ox1"],
            "x2m": mesh.mesh_bcs["ix2"], "x2p": mesh.mesh_bcs["ox2"],
            "x3m": mesh.mesh_bcs["ix3"], "x3p": mesh.mesh_bcs["ox3"],
        }
        for key, flag in self.flag.items():
            if self.any_phys[key] and flag not in (
                    "periodic", "outflow", "reflect", "diode", "vacuum"):
                raise NotImplementedError(
                    f"boundary flag '{flag}' is not ported to "
                    "athenak_tpu_torch yet")
        # single-block fully periodic 3-D mesh: one fill-kernel pass
        self.use_fill_kernel = (
            mesh.nmb_total == 1
            and len(self.active_axes) == 3
            and self.ng == 2
            and not any(self.any_phys.values())
            and all(f == "periodic" for f in self.flag.values()))
        # same-level periodic pool of blocks: one pool-fill launch
        from .ops.pool_fill import supports_pool_fill
        self.use_pool_fill = supports_pool_fill(mesh)
        self._nbr27 = None
        self._nbr27_dev = None

    def nbr27(self, device=None):
        """The [nmb, 27] donor table of the pool fill: host numpy, or with
        ``device`` an int32 tensor there, copied once and kept."""
        if self._nbr27 is None:
            from .ops.pool_fill import neighbor27
            self._nbr27 = neighbor27(self.mesh)
        if device is None:
            return self._nbr27
        if self._nbr27_dev is None or self._nbr27_dev.device != device:
            self._nbr27_dev = torch.as_tensor(self._nbr27, device=device)
        return self._nbr27_dev

    def pool_fill_active(self, t) -> bool:
        """True when the pool-fill kernel fills ``t``'s ghosts."""
        return self.use_pool_fill and kernel_dtype_ok(t)

    def local_mask(self, key: str, ndim: int, device):
        """Per-block physical-BC mask of one face, broadcastable."""
        return torch.as_tensor(self.mask[key], device=device).reshape(
            (-1,) + (1,) * (ndim - 1))

    # ------------------------------------------------------------------
    def fill_ghosts(self, u):
        """Fill every ghost zone of ``u [nmb, nvar, n3, n2, n1]`` in place.

        The normal-velocity channel for reflect/diode BCs follows the
        conserved/primitive index convention (IVX/IVY/IVZ == IM1/IM2/IM3).
        """
        if self.use_fill_kernel and kernel_dtype_ok(u):
            from .ops.fill import periodic_fill_cc
            return periodic_fill_cc(u)
        if self.pool_fill_active(u):
            from .ops.pool_fill import pool_fill_cc
            return pool_fill_cc(u, self.nbr27(u.device), self.mesh)
        for ax in self.active_axes:
            self._sweep_axis(u, ax)
        return u

    def _sweep_axis(self, u, ax: str) -> None:
        ng = self.ng
        axis = _AXIS_OF[ax]
        n = u.shape[axis]
        # both donor slabs are interior cells along this axis; gather
        # them before any ghost is written
        ghost_m = gather_blocks(u[_slc(axis, n - 2 * ng, n - ng)],
                                self.nbr[f"{ax}m"]).clone()
        ghost_p = gather_blocks(u[_slc(axis, ng, 2 * ng)],
                                self.nbr[f"{ax}p"]).clone()
        if self.any_phys[f"{ax}m"]:
            ghost_m = self._phys_bc(u, ax, "m", ghost_m)
        if self.any_phys[f"{ax}p"]:
            ghost_p = self._phys_bc(u, ax, "p", ghost_p)
        u[_slc(axis, 0, ng)] = ghost_m
        u[_slc(axis, n - ng, n)] = ghost_p

    def _phys_bc(self, u, ax: str, side: str, gathered):
        """Physical-BC ghost values selected on the masked blocks
        (reference: src/bvals/physics/hydro_bcs.cpp:85-130)."""
        ng = self.ng
        axis = _AXIS_OF[ax]
        n = u.shape[axis]
        key = f"{ax}{side}"
        flag = self.flag[key]
        if flag == "periodic":
            return gathered
        nvel = _NORMAL_VEL[ax]
        if side == "m":
            active_edge = u[_slc(axis, ng, 2 * ng)]
            edge_cell = u[_slc(axis, ng, ng + 1)]
        else:
            active_edge = u[_slc(axis, n - 2 * ng, n - ng)]
            edge_cell = u[_slc(axis, n - ng - 1, n - ng)]

        if flag == "reflect":
            bc = torch.flip(active_edge, dims=(axis,)).clone()
            bc[:, nvel] = -bc[:, nvel]
        elif flag == "outflow":
            bc = edge_cell.expand(gathered.shape)
        elif flag == "diode":
            e = edge_cell.clone()
            v = e[:, nvel]
            e[:, nvel] = torch.clamp(v, max=0.0) if side == "m" \
                else torch.clamp(v, min=0.0)
            bc = e.expand(gathered.shape)
        else:  # vacuum
            bc = torch.zeros_like(gathered)
        return torch.where(self.local_mask(key, 5, u.device), bc, gathered)
