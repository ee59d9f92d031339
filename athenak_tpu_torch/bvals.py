"""Ghost-zone filling for cell-centred arrays: halo exchange + physical BCs.

Counterpart of ``athenak_tpu/bvals.py`` (reference:
src/bvals/bvals_cc.cpp, src/bvals/physics/hydro_bcs.cpp).  The axes are
swept in order x1, x2, x3; each sweep copies the full current extent of
the transverse axes, so edge and corner ghosts fill transitively.  Each
sweep computes both of its ghost slabs from the array as it stands
before the sweep, as the JAX package's functional sweep does, and only
then writes them: ``fill_ghosts`` returns the tensor it was given, with
its ghosts filled in place.

On a statically refined mesh the sweeps run twice (the second round
restricts and prolongs from donors whose own ghosts the first round
filled) and a face whose neighbour sits on another level takes its
ghosts by restriction from the finer donors or min-mod prolongation
from the coarser one (``_ml_override``); a last pass fills the edge and
corner patches straight from diagonal donors (``_fill_corners``).
The prolongation is min-mod, or 4th-order Lagrange where the physics
sets ``prolong_order = 4`` (Z4c).  With
``<mesh_refinement>/prolong_primitives`` the physics refills the
primitives' ghosts after c2p and rebuilds the conserved ghosts from
them (``prolong_prims_fixup``).

A single fully periodic block takes the fill kernel
(``ops/fill.py``, kernel B) and a same-level periodic pool of blocks the
pool-fill kernel (``ops/pool_fill.py``, kernel G) when the tensor lies
on the card in float32, the port's counterpart of the JAX package's TPU
gate.

An ``inflow`` flag holds its ghosts at the fixed state a problem
generator puts in ``inflow_state`` (a [nvar] tensor a face key, x1m and
so on; the outflow copy until one is set).  A ``shear_periodic`` x1 side
gathers from the wraparound donor as a periodic one does; the shearing
box (``shearing_box.py``) remaps those ghosts after the fill.  A ``user``
boundary flag leaves its ghosts to the problem generator's
``user_bc_func(u, bvals) -> u`` (the sweeps treat the side as periodic),
which runs after every fill route, as in the JAX package; the hooks of
the port's problem generators write in place, and ``fill_ghosts``
returns what the hook returns.
"""

from __future__ import annotations

import numpy as np
import torch

from .indices import IVX, IVY, IVZ
from .mesh import Mesh
from .refinement import (box, donor_columns, mixed_level, pair_merge,
                         parity, prolong_cc_order, prolong_guard,
                         restrict_cc)

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
        self.multilevel = mesh.multilevel
        # mixed-level prolongation order: 2 (min-mod) or 4 (Lagrange, set
        # by Z4c; reference: prolongation.hpp HighOrderProlongCC)
        self.prolong_order = 2
        # <mesh_refinement>/prolong_primitives, set by the physics
        # constructors (reference: mesh_refinement.cpp:52-69)
        self.prolong_prims = False
        self._ghost_mask = {}
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
            if self.any_phys.get(key, False) and flag not in (
                    "periodic", "shear_periodic", "outflow", "reflect",
                    "diode", "vacuum", "inflow", "user"):
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
        # a problem generator's user boundary function, fn(u, bvals) -> u
        self.user_bc_func = None
        # fixed inflow states set by problem generators: face key ->
        # [nvar] tensor
        self.inflow_state = {}

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

    def pool_route(self, t) -> bool:
        """True when ``t``'s ghosts take the pool's fill: kernel G on one
        rank, the exchange on one rank's blocks of a group."""
        return self.use_pool_fill and kernel_dtype_ok(t)

    def pool_fill_active(self, t) -> bool:
        """True when the pool-fill kernel fills ``t``'s ghosts: never on
        one rank's blocks of a group, where the exchange owns block
        movement (the JAX package's gate, bvals.py:109-115)."""
        from .comm import current_comm
        return self.pool_route(t) and current_comm() is None

    def local_mask(self, key: str, ndim: int, device):
        """Per-block physical-BC mask of one face, broadcastable."""
        return self.mesh.tables.mask(self.mask[key], ndim, device)

    # ------------------------------------------------------------------
    def fill_ghosts(self, u):
        """Fill every ghost zone of ``u [nmb, nvar, n3, n2, n1]`` in place.

        The normal-velocity channel for reflect/diode BCs follows the
        conserved/primitive index convention (IVX/IVY/IVZ == IM1/IM2/IM3).
        """
        if self.use_fill_kernel and kernel_dtype_ok(u):
            from .ops.fill import periodic_fill_cc
            u = periodic_fill_cc(u)
        elif self.pool_fill_active(u):
            from .ops.pool_fill import pool_fill_cc
            u = pool_fill_cc(u, self.nbr27(u.device), self.mesh)
        else:
            for _ in range(2 if self.multilevel else 1):
                for ax in self.active_axes:
                    self._sweep_axis(u, ax)
            if self.multilevel:
                self._fill_corners(u)
        if self.user_bc_func is not None:
            u = self.user_bc_func(u, self)
        return u

    # ------------------------------------------------------------------
    def ghost_mask(self, device):
        """[1, 1, n3, n2, n1] bool on ``device``, True in the ghost cells
        (made once a device)."""
        key = str(device)
        if key not in self._ghost_mask:
            mbi = self.mesh.mb_indcs
            m = torch.ones((mbi.ncells3, mbi.ncells2, mbi.ncells1),
                           dtype=torch.bool)
            sl = [slice(None)] * 3
            if mbi.nx3 > 1:
                sl[0] = slice(mbi.ks, mbi.ke + 1)
            if mbi.nx2 > 1:
                sl[1] = slice(mbi.js, mbi.je + 1)
            sl[2] = slice(mbi.is_, mbi.ie + 1)
            m[tuple(sl)] = False
            self._ghost_mask[key] = m[None, None].to(device)
        return self._ghost_mask[key]

    def prolong_prims_fixup(self, u, w, p2c):
        """Prolongation in primitive variables: refill w's ghosts (so the
        mixed-level strips are prolonged from donor primitives) and
        overwrite u's ghost cells with p2c(w) (reference:
        prolong_prims.cpp ConsToPrimCoarseBndry/PrimToConsFineBndry).
        Returns (u, w)."""
        w = self.fill_ghosts(w)
        return torch.where(self.ghost_mask(u.device), p2c(w), u), w

    # ------------------------------------------------------------------
    def _sweep_axis(self, u, ax: str) -> None:
        ng = self.ng
        axis = _AXIS_OF[ax]
        n = u.shape[axis]
        # both ghost slabs come from u as it stands before the sweep:
        # gather and override them before any ghost is written
        ghost = {}
        for side, lo in (("m", n - 2 * ng), ("p", ng)):
            g = self.mesh.tables.gather(u[_slc(axis, lo, lo + ng)],
                                        self.nbr[f"{ax}{side}"]).clone()
            if self.multilevel:
                g = self._ml_override(u, ax, side, g)
            if self.any_phys[f"{ax}{side}"]:
                g = self._phys_bc(u, ax, side, g)
            ghost[side] = g
        u[_slc(axis, 0, ng)] = ghost["m"]
        u[_slc(axis, n - ng, n)] = ghost["p"]

    # ------------------------------------------------------------------
    def _ml_override(self, u, ax: str, side: str, ghost):
        """Replace the same-level ghost candidate with restriction (finer
        donors) or prolongation (coarser donor) where the face is a
        level boundary (reference: bvals_cc.cpp pack/unpack with coarse
        buffers + ProlongCC; the JAX package's masked selects over
        gathered slabs).  Reads u only; returns a new slab."""
        t = self.mesh.ml[f"{ax}{side}"]
        if not (t["any_fine"] or t["any_coarse"]):
            return ghost
        dev = u.device
        tables = self.mesh.tables
        ng, h = self.ng, self.ng // 2
        axis = _AXIS_OF[ax]
        n = u.shape[axis]
        # mixed-level blocks have no same-level donor: their gathered
        # candidate is self-garbage.  Start from the CURRENT ghost content
        # instead, so slab parts outside the restriction/prolongation
        # write regions (corner rings) keep what earlier sweeps copied.
        mlm = tables.mask(mixed_level(t), 5, dev)
        cur = u[_slc(axis, 0, ng)] if side == "m" \
            else u[_slc(axis, n - ng, n)]
        ghost = torch.where(mlm, cur, ghost)
        mbi = self.mesh.mb_indcs
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        nc_of = {"x1": mbi.ncells1, "x2": mbi.ncells2, "x3": mbi.ncells3}
        tn = t["t_names"]
        cell_axes = [_AXIS_OF[a] - 5 for a in self.active_axes]

        # ---- finer donors: 2x cell-average restriction, quadrant assembly
        if t["any_fine"]:
            slab = u[_slc(axis, n - 3 * ng, n - ng)] if side == "m" \
                else u[_slc(axis, ng, 3 * ng)]
            parts = [restrict_cc(tables.gather(slab, col), cell_axes)
                     for col in donor_columns(t)]
            # pair-merge along each transverse axis (fastest quadrant bit
            # first); each restricted slab covers my transverse cells
            # [h, mid+h) / [mid-h, nc-h), overlapping by 2h donor-ghost
            # cells that both donors agree on
            for a2 in tn:
                parts = pair_merge(parts, _AXIS_OF[a2], nx_of[a2] // 2 + h, h)
            region = box(ghost, {_AXIS_OF[a2]: (h, nc_of[a2] - h)
                                  for a2 in tn})
            fmask = tables.mask(t["fine_mask"], 5, dev)
            region.copy_(torch.where(fmask, parts[0], region))

        # ---- coarser donor: min-mod (or 4th-order Lagrange)
        # prolongation over a per-block parity-selected window of the
        # donor face
        if t["any_coarse"]:
            g = prolong_guard(self.prolong_order)
            slab = u[_slc(axis, n - ng - h - g, n - ng + g)] if side == "m" \
                else u[_slc(axis, ng - g, ng + h + g)]
            d = tables.gather(slab, t["coarse"])
            for a2 in tn:
                t_axis = _AXIS_OF[a2]
                half = nx_of[a2] // 2
                ln = half + ng + 2 * g
                s0 = ng - h - g
                sel = tables.mask(parity(t, a2), 5, dev)
                d = torch.where(sel, d.narrow(t_axis, s0 + half, ln),
                                d.narrow(t_axis, s0, ln))
            pro = prolong_cc_order(d, cell_axes, self.prolong_order)
            wmask = tables.mask(t["coarse_mask"], 5, dev)
            # guard the transverse corner strips: where the diagonal
            # neighbour is same-level or finer, the sweeps already placed
            # the correct (copied/restricted) values there (concave trees;
            # see refinement.build_ml_tables pkeep)
            for a2 in tn:
                t_axis = _AXIS_OF[a2]
                ncc = nc_of[a2]
                shp = [1] * 5
                shp[t_axis] = ncc
                pos = torch.arange(ncc, device=dev).reshape(shp)
                km = tables.mask(t["pkeep"][a2]["m"], 5, dev)
                kp = tables.mask(t["pkeep"][a2]["p"], 5, dev)
                wmask = wmask & ((pos >= ng) | km) & ((pos < ncc - ng) | kp)
            ghost = torch.where(wmask, pro, ghost)
        return ghost

    # ------------------------------------------------------------------
    def _fill_corners(self, u) -> None:
        """Direct diagonal-donor fill of the edge/corner ghost patches, in
        place.  At mixed-level junctions the restriction/prolongation
        write regions leave corner holes; this pass copies or restricts
        the ng-deep corner patches straight from the diagonal donors
        (reference: the edge/corner buffers of src/bvals/bvals.hpp:61-101;
        the JAX package's ``_fill_corners``)."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng, h = self.ng, self.ng // 2
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        act = self.active_axes
        dev = u.device
        tables = self.mesh.tables

        def side_slices(s, n):
            """(my ghost span, same-donor span, fine-donor span)."""
            if s == "m":
                return (0, ng), (n - 2 * ng, n - ng), (n - 3 * ng, n - ng)
            return (n - ng, n), (ng, 2 * ng), (ng, 3 * ng)

        pairs = [(d1, d2) for i, d1 in enumerate(act) for d2 in act[i + 1:]]
        for d1, d2 in pairs:
            a1, a2 = _AXIS_OF[d1], _AXIS_OF[d2]
            # edge direction (3D) / absent (2D)
            rest = [a for a in act if a not in (d1, d2)]
            for s1 in ("m", "p"):
                for s2 in ("m", "p"):
                    t = mesh.ml.get(f"e_{d1}{s1}{d2}{s2}")
                    if t is None or not (t["any_same"] or t["any"]):
                        continue
                    my1, dn1, fn1 = side_slices(s1, u.shape[a1])
                    my2, dn2, fn2 = side_slices(s2, u.shape[a2])
                    if t["any_same"]:
                        region = box(u, {a1: my1, a2: my2})
                        donor = tables.gather(box(u, {a1: dn1, a2: dn2}),
                                              t["same_gid"])
                        mb = tables.mask(t["same_mask"], 5, dev)
                        region.copy_(torch.where(mb, donor, region))
                    if t["any"]:
                        caxes = [a1 - 5, a2 - 5]
                        if rest:
                            caxes.append(_AXIS_OF[rest[0]] - 5)
                        src = box(u, {a1: fn1, a2: fn2})
                        parts = [restrict_cc(tables.gather(src, col), caxes)
                                 for col in donor_columns(t)]
                        spans = {a1: my1, a2: my2}
                        if rest:
                            # assemble the two edge-axis donors over the
                            # transverse core (vertex cubes via v_ pass)
                            ar = _AXIS_OF[rest[0]]
                            assembled = pair_merge(
                                parts, ar, nx_of[rest[0]] // 2 + h, h)[0]
                            spans[ar] = (h, u.shape[ar] - h)
                        else:
                            assembled = parts[0]
                        region = box(u, spans)
                        mb = tables.mask(t["mask"], 5, dev)
                        region.copy_(torch.where(mb, assembled, region))
        if len(act) != 3:
            return
        axes = (_AXIS_OF["x1"], _AXIS_OF["x2"], _AXIS_OF["x3"])
        for s1 in ("m", "p"):
            for s2 in ("m", "p"):
                for s3 in ("m", "p"):
                    t = mesh.ml.get(f"v_{s1}{s2}{s3}")
                    if t is None or not (t["any_same"] or t["any_fine"]):
                        continue
                    sl = [side_slices(s, u.shape[a])
                          for s, a in zip((s1, s2, s3), axes)]
                    region = box(u, {a: s[0] for a, s in zip(axes, sl)})
                    if t["any_same"]:
                        donor = tables.gather(
                            box(u, {a: s[1] for a, s in zip(axes, sl)}),
                            t["same_gid"])
                        mb = tables.mask(t["same_mask"], 5, dev)
                        region.copy_(torch.where(mb, donor, region))
                    if t["any_fine"]:
                        donor = restrict_cc(tables.gather(
                            box(u, {a: s[2] for a, s in zip(axes, sl)}),
                            t["fine_gid"]), [a - 5 for a in axes])
                        mb = tables.mask(t["fine_mask"], 5, dev)
                        region.copy_(torch.where(mb, donor, region))

    # ------------------------------------------------------------------
    def _phys_bc(self, u, ax: str, side: str, gathered):
        """Physical-BC ghost values selected on the masked blocks
        (reference: src/bvals/physics/hydro_bcs.cpp:85-130)."""
        ng = self.ng
        axis = _AXIS_OF[ax]
        n = u.shape[axis]
        key = f"{ax}{side}"
        flag = self.flag[key]
        if flag in ("periodic", "shear_periodic", "user"):
            # shear-periodic ghosts are the wraparound donor's, remapped
            # by the shearing box after the fill; a user side's, the
            # hook's after the fill
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
        elif flag == "inflow":
            st = self.inflow_state.get(key)
            bc = edge_cell.expand(gathered.shape) if st is None else \
                st.to(u.dtype).reshape(1, -1, 1, 1, 1).expand(gathered.shape)
        else:  # vacuum
            bc = torch.zeros_like(gathered)
        return torch.where(self.local_mask(key, 5, u.device), bc, gathered)
