"""The multigrid Poisson solver of self-gravity.

Counterpart of ``athenak_tpu/multigrid.py`` (reference: the FAS driver
src/multigrid/multigrid_driver.cpp:129-567, 731-860 and
src/gravity/mg_gravity.cpp): the same ``<gravity>`` parameters
(threshold, niteration, npresmooth, npostsmooth, omega, full_multigrid,
fmg_ncycle, show_defect, subtract_average, bottom_smooth, mg_bc,
mporder, auto_mporigin, nodipole, mask_radius), the same volume-weighted
L2 defect and its printout.  Two kinds of dense levels stand in for the
reference's octet blocks:

  * global levels: the root grid and every coarsening of it down to two
    cells a side, assembled from the blocks by their locations; a
    uniform mesh solves here alone (red-black SOR, full-weighting
    restriction, linear prolongation);
  * box levels, one for each refinement level of a refined mesh: a dense
    array over the bounding box of the cells that leaves of that level
    or finer cover, with a fixed mask of active cells and a one-cell
    Dirichlet border interpolated from the coarser level (the MLAT form
    of the reference's octet levels, with its interface correction).

Non-periodic mesh faces take ``mg_bc``: zerofixed, zerograd, or the
multipole expansion of the source about its centre of mass, to order 2
or 4 (``_multipole_setup``).  The V-cycles run until the defect falls
to ``threshold`` (at most ``niteration``, 40 without it; one host read
of the defect a cycle, where the JAX package runs a device
``while_loop``) or, without a threshold, ``niteration`` times.  The
driver carries the last stage's potential in ``state["phi"]``, the next
solve's starting guess.  Every step is a torch op, as the JAX package's
are jnp ops outside its Pallas kernels; the ghost fill of the result
takes the fill kernels B and G where their gates admit the mesh.
``nsolve`` and ``ncycles`` count the solves and their V-cycles.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .comm import current_comm, own_blocks, whole_blocks


def _repeat(n, fn, x):
    for _ in range(max(n, 0)):
        x = fn(x)
    return x


class _BoxLevel:
    """One refinement level as a dense masked box (host numpy).

      lo:     the level-l index of box cell (0, 0, 0), (z, y, x)
      shape:  the box shape (z, y, x) with its one-cell border ring
      active: cells covered by leaves of level >= l
      owned:  cells of level-l leaves
      border: the ring around the active cells
      dxs:    (d3, d2, d1) at this level
      red:    the red cells of the red-black order of the level's grid
      leaf_gids / leaf_off: each level-l leaf's gid and the offset of
              its first interior cell in the box
    """

    def __init__(self, mesh, lev, active_dims):
        mbi = mesh.mb_indcs
        self.lev = lev
        nx = (mbi.nx3, mbi.nx2, mbi.nx1)
        dfac = lambda f: np.array([f if active_dims[2] else 1,  # noqa: E731
                                   f if active_dims[1] else 1, f])
        cells = []
        gids = []
        for gid, (l1, l2, l3, lv) in enumerate(mesh.leaves):
            if lv < lev:
                continue
            f = 2 ** (lv - lev)
            lo = np.array([l3 * nx[0], l2 * nx[1], l1 * nx[2]])
            lo_p = lo // dfac(f)
            sz_p = np.maximum(np.array(nx) // dfac(f), 1)
            cells.append((lo_p, lo_p + sz_p, lv == lev, gid))
            if lv == lev:
                gids.append(gid)
        bb_lo = np.array([c[0] for c in cells]).min(axis=0)
        bb_hi = np.array([c[1] for c in cells]).max(axis=0)
        g = np.array([1 if active_dims[2] else 0,
                      1 if active_dims[1] else 0, 1])
        self.lo = bb_lo - g
        self.shape = tuple(bb_hi - bb_lo + 2 * g)
        self.active = np.zeros(self.shape, dtype=bool)
        self.owned = np.zeros(self.shape, dtype=bool)
        for lo_p, hi_p, is_own, _ in cells:
            sl = tuple(slice(int(a - o), int(b - o))
                       for a, b, o in zip(lo_p, hi_p, self.lo))
            self.active[sl] = True
            if is_own:
                self.owned[sl] = True
        dil = np.zeros_like(self.active)
        for ax in [2] + ([1] if active_dims[1] else []) \
                + ([0] if active_dims[2] else []):
            dil |= np.roll(self.active, 1, axis=ax)
            dil |= np.roll(self.active, -1, axis=ax)
        self.border = dil & ~self.active

        ms = mesh.mesh_size
        gi = mesh.mesh_indcs
        f = 2 ** lev
        self.dxs = ((ms.x3max - ms.x3min) / (max(gi.nx3, 1)
                                             * (f if active_dims[2] else 1)),
                    (ms.x2max - ms.x2min) / (max(gi.nx2, 1)
                                             * (f if active_dims[1] else 1)),
                    (ms.x1max - ms.x1min) / (gi.nx1 * f))
        kk, jj, ii = np.meshgrid(*[np.arange(s) for s in self.shape],
                                 indexing="ij")
        self.red = ((ii + self.lo[2]
                     + ((jj + self.lo[1]) if active_dims[1] else 0)
                     + ((kk + self.lo[0]) if active_dims[2] else 0))
                    % 2 == 0)
        self.leaf_gids = np.array(gids, dtype=np.int64)
        offs = [lo_p - self.lo for lo_p, _, is_own, _ in cells if is_own]
        self.leaf_off = np.array(offs, dtype=np.int64) if offs \
            else np.zeros((0, 3), dtype=np.int64)


class MGPoisson:
    """lap(phi) = four_pi_G (rho - <rho>) by FAS multigrid; ``solve(u,
    bvals, phi0)`` returns phi [nmb, 1, n3, n2, n1] with its ghosts
    filled (reference: MGGravityDriver::Solve, once a stage)."""

    _MP_SCALE = None

    def __init__(self, pin, mesh, device, dtype) -> None:
        self.mesh = mesh
        self.device = torch.device(device)
        self.four_pi_G = pin.get_or_add_real("gravity", "four_pi_G", -1.0)
        if self.four_pi_G <= 0.0:
            raise ValueError("gravity/four_pi_G must be set")
        self.omega = pin.get_or_add_real("gravity", "omega", 1.15)
        self.eps = pin.get_or_add_real("gravity", "threshold", -1.0)
        self.niter = pin.get_or_add_integer("gravity", "niteration", -1)
        self.npre = int(pin.get_or_add_real("gravity", "npresmooth", 1))
        self.npost = int(pin.get_or_add_real("gravity", "npostsmooth", 1))
        self.fmg = pin.get_or_add_boolean("gravity", "full_multigrid",
                                          False)
        self.fmg_ncycle = pin.get_or_add_integer("gravity", "fmg_ncycle", 1)
        self.show_defect = pin.get_or_add_integer("gravity",
                                                  "show_defect", 0)
        self.subtract_average = pin.get_or_add_boolean(
            "gravity", "subtract_average", True)
        self.nbottom = pin.get_or_add_integer("gravity", "bottom_smooth",
                                              30)
        if self.eps < 0.0 and self.niter < 0:
            raise ValueError("Either gravity/threshold or "
                             "gravity/niteration must be set "
                             "(reference: mg_gravity.cpp:52-59)")
        # isolated boundaries (reference: mg_gravity.cpp:68-121,
        # multigrid_driver.cpp:1827-2120): mg_bc applies to every
        # non-periodic mesh face
        self.periodic = all(v == "periodic" for v in mesh.mesh_bcs.values())
        mg_bc = pin.get_or_add_string("gravity", "mg_bc", "none")
        if mg_bc not in ("none", "zerofixed", "zerograd", "multipole"):
            raise ValueError(f"gravity/mg_bc = '{mg_bc}' unknown "
                             "(none/zerofixed/zerograd/multipole)")
        if mg_bc == "none" and not self.periodic:
            raise NotImplementedError(
                "multigrid gravity on non-periodic meshes requires "
                "gravity/mg_bc = zerofixed | zerograd | multipole "
                "(reference: mg_gravity.cpp:68-88)")

        def _flag(face):
            bc = mesh.mesh_bcs.get(face, "periodic")
            return "periodic" if bc == "periodic" else mg_bc
        self.mg_bc = mg_bc
        # (lo, hi) flags per array axis (x3, x2, x1)
        self.bc_flags = ((_flag("ix3"), _flag("ox3")),
                         (_flag("ix2"), _flag("ox2")),
                         (_flag("ix1"), _flag("ox1")))
        self.isolated = any(f != "periodic" for lh in self.bc_flags
                            for f in lh)
        self.mporder = 0
        self.nodipole = False
        self.autompo = False
        self._mp = None
        self.mp_coeffs = None
        self.mp_origin = None
        if mg_bc == "multipole":
            if not (mesh.mesh_indcs.nx2 > 1 and mesh.mesh_indcs.nx3 > 1):
                raise ValueError("gravity/mg_bc = multipole requires a "
                                 "3D mesh")
            self.mporder = pin.get_or_add_integer("gravity", "mporder", 4)
            if self.mporder not in (2, 4):
                raise ValueError("gravity/mporder must be 2 or 4")
            self.autompo = pin.get_or_add_boolean("gravity",
                                                  "auto_mporigin", True)
            self.nodipole = pin.get_or_add_boolean("gravity", "nodipole",
                                                   False)
            if self.autompo and self.nodipole:
                raise ValueError("auto_mporigin and nodipole cannot be "
                                 "used together")
            if not self.autompo:
                self.mpo = (pin.get_real("gravity", "mporigin_x1"),
                            pin.get_real("gravity", "mporigin_x2"),
                            pin.get_real("gravity", "mporigin_x3"))
        if self.isolated:
            # the isolated problem is not singular: no mean is removed
            self.subtract_average = False
        # the source is zeroed outside mask_radius (reference:
        # Multigrid::ApplyMask, multigrid.cpp:355-385)
        self.mask_radius = pin.get_or_add_real("gravity", "mask_radius",
                                               -1.0)
        self.mask_origin = (
            pin.get_or_add_real("gravity", "mask_origin_x1", 0.0),
            pin.get_or_add_real("gravity", "mask_origin_x2", 0.0),
            pin.get_or_add_real("gravity", "mask_origin_x3", 0.0))

        ms = mesh.mesh_size
        self.total_vol = ((ms.x1max - ms.x1min) * (ms.x2max - ms.x2min)
                          * (ms.x3max - ms.x3min))
        gi = mesh.mesh_indcs
        mbi = mesh.mb_indcs
        self.active = [True, gi.nx2 > 1, gi.nx3 > 1]
        self.act_in = (slice(mbi.ks, mbi.ke + 1),
                       slice(mbi.js, mbi.je + 1),
                       slice(mbi.is_, mbi.ie + 1))
        self._nxb = (mbi.nx3, mbi.nx2, mbi.nx1)
        vol = (np.asarray(mesh.mb_size["dx1"]) * np.asarray(
            mesh.mb_size["dx2"]) * np.asarray(mesh.mb_size["dx3"]))
        self._vol = torch.as_tensor(vol.reshape(-1, 1, 1, 1), dtype=dtype,
                                    device=self.device)

        # box levels 1..max_level of a refined mesh
        self.boxes: List[_BoxLevel] = []
        max_level = int(getattr(mesh, "max_level", 0)) \
            if getattr(mesh, "leaves", None) is not None else 0
        for lev in range(1, max_level + 1):
            bl = _BoxLevel(mesh, lev, self.active)
            if bl.border.any():
                glob = np.array([max(gi.nx3, 1), max(gi.nx2, 1),
                                 gi.nx1]) * 2 ** lev
                if np.any(bl.lo < 0) or np.any(
                        bl.lo + np.array(bl.shape) > glob):
                    raise NotImplementedError(
                        "refined region touches the domain boundary "
                        "(periodic box-border wrap not implemented)")
            self.boxes.append(bl)

        # the root-level leaves' places in the root grid
        if getattr(mesh, "leaves", None) is not None:
            self.root_gids = np.array(
                [g for g, (_, _, _, lv) in enumerate(mesh.leaves)
                 if lv == 0], dtype=np.int64)
            self.root_off = np.array(
                [(l3 * mbi.nx3, l2 * mbi.nx2, l1 * mbi.nx1)
                 for (l1, l2, l3, lv) in mesh.leaves if lv == 0],
                dtype=np.int64)
        else:
            self.root_gids = np.arange(mesh.nmb_total)
            self.root_off = np.array(
                [(int(loc[2]) * mbi.nx3, int(loc[1]) * mbi.nx2,
                  int(loc[0]) * mbi.nx1) for loc in mesh.lloc_eachmb],
                dtype=np.int64)

        # the global levels, root resolution downward
        n1, n2, n3 = gi.nx1, max(gi.nx2, 1), max(gi.nx3, 1)
        d1 = (ms.x1max - ms.x1min) / n1
        d2 = (ms.x2max - ms.x2min) / n2
        d3 = (ms.x3max - ms.x3min) / n3

        def can_halve(n1, n2, n3):
            dims = [n1] + ([n2] if self.active[1] else []) \
                + ([n3] if self.active[2] else [])
            return all(d % 2 == 0 and d > 2 for d in dims)

        self.glevels = []        # (shape (z, y, x), (d3, d2, d1))
        while True:
            self.glevels.append(((n3, n2, n1), (d3, d2, d1)))
            if not can_halve(n1, n2, n3):
                break
            n1 //= 2
            d1 *= 2.0
            if self.active[1]:
                n2 //= 2
                d2 *= 2.0
            if self.active[2]:
                n3 //= 2
                d3 *= 2.0
        self._masks = {}
        self._src_mask = None
        self.nsolve = 0
        self.ncycles = 0
        self.last_cycles = 0

    # ------------------------------------------------------------------
    # device copies of host masks and index grids, made once
    # ------------------------------------------------------------------
    def _t(self, key, make):
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(make(), device=self.device)
        return self._masks[key]

    def _box_t(self, li, name):
        return self._t(("box", li, name),
                       lambda: getattr(self.boxes[li - 1], name))

    # ------------------------------------------------------------------
    # dense-array primitives (box and global levels)
    # ------------------------------------------------------------------
    def _axes(self):
        return [2] + ([1] if self.active[1] else []) \
            + ([0] if self.active[2] else [])

    def _nbrs(self, g, ax, gi=None, homog=False):
        """(left, right) neighbours along ``ax``; on an isolated global
        level the wrap is replaced by the boundary ghosts (reference:
        ApplyPhysicalBoundaries, multigrid_driver.cpp:1732-2030):
        zerofixed -interior, zerograd +interior, multipole 2 phi_mp -
        interior; ``homog`` (the corrections) takes multipole as
        zerofixed."""
        gm = torch.roll(g, 1, dims=ax)
        gp = torch.roll(g, -1, dims=ax)
        if gi is None or not self.isolated:
            return gm, gp
        lo, hi = self.bc_flags[ax]
        n = g.shape[ax]

        def ghost(side, flag):
            edge = g.narrow(ax, 0 if side == 0 else n - 1, 1)
            if flag == "zerograd":
                return edge
            if flag == "multipole" and not homog and self._mp is not None:
                return 2.0 * self._mp[gi][(ax, side)] - edge
            return -edge

        if lo != "periodic":
            gm = torch.cat([ghost(0, lo), g.narrow(ax, 0, n - 1)], dim=ax)
        if hi != "periodic":
            gp = torch.cat([g.narrow(ax, 1, n - 1), ghost(1, hi)], dim=ax)
        return gm, gp

    def _lap(self, g, dxs, gi=None):
        gm, gp = self._nbrs(g, 2, gi)
        out = (gm - 2.0 * g + gp) / dxs[2] ** 2
        if self.active[1]:
            gm, gp = self._nbrs(g, 1, gi)
            out = out + (gm - 2.0 * g + gp) / dxs[1] ** 2
        if self.active[2]:
            gm, gp = self._nbrs(g, 0, gi)
            out = out + (gm - 2.0 * g + gp) / dxs[0] ** 2
        return out

    def _diag(self, dxs):
        d = 2.0 / dxs[2] ** 2
        if self.active[1]:
            d = d + 2.0 / dxs[1] ** 2
        if self.active[2]:
            d = d + 2.0 / dxs[0] ** 2
        return d

    def _smooth(self, g, rhs, dxs, red, omega, update_mask=None, gi=None):
        """One red-black SOR sweep, red first."""
        diag = self._diag(dxs)
        for color in (True, False):
            gm, gp = self._nbrs(g, 2, gi)
            num = (gm + gp) / dxs[2] ** 2
            if self.active[1]:
                gm, gp = self._nbrs(g, 1, gi)
                num = num + (gm + gp) / dxs[1] ** 2
            if self.active[2]:
                gm, gp = self._nbrs(g, 0, gi)
                num = num + (gm + gp) / dxs[0] ** 2
            gs = (num - rhs) / diag
            mask = red if color else ~red
            if update_mask is not None:
                mask = mask & update_mask
            g = torch.where(mask, g + omega * (gs - g), g)
        return g

    def _restrict(self, g):
        if self.active[2]:
            g = g.reshape(g.shape[0] // 2, 2, g.shape[1],
                          g.shape[2]).mean(dim=1)
        if self.active[1]:
            g = g.reshape(g.shape[0], g.shape[1] // 2, 2,
                          g.shape[2]).mean(dim=2)
        return g.reshape(g.shape[0], g.shape[1], g.shape[2] // 2,
                         2).mean(dim=3)

    def _prolong(self, c, gi=None, homog=True):
        """Linear cell-centred 2x prolongation; on an isolated global
        level the edge neighbours are the coarse level ``gi``'s boundary
        ghosts, elsewhere the array wraps (callers mask the edge ring)."""
        for ax in self._axes():
            cm, cp = self._nbrs(c, ax, gi, homog=homog)
            lo = 0.75 * c + 0.25 * cm
            hi = 0.75 * c + 0.25 * cp
            st = torch.stack([lo, hi], dim=ax + 1)
            sh = list(c.shape)
            sh[ax] *= 2
            c = st.reshape(sh)
        return c

    def _g_red(self, shape):
        def make():
            kk, jj, ii = np.meshgrid(np.arange(shape[0]),
                                     np.arange(shape[1]),
                                     np.arange(shape[2]), indexing="ij")
            return ((ii + (jj if self.active[1] else 0)
                     + (kk if self.active[2] else 0)) % 2 == 0)
        return self._t(("red", shape), make)

    # ------------------------------------------------------------------
    # blocks <-> dense levels
    # ------------------------------------------------------------------
    def _leaf_idx(self, key, gids, offs):
        """Index grids (Z, Y, X), each [nleaf, n3, n2, n1], of the leaf
        interiors in a dense level, on the device."""
        def make(k):
            n3, n2, n1 = self._nxb
            shp = (len(gids), n3, n2, n1)
            z = offs[:, 0, None, None, None] + np.arange(n3)[None, :, None,
                                                             None]
            y = offs[:, 1, None, None, None] + np.arange(n2)[None, None, :,
                                                             None]
            x = offs[:, 2, None, None, None] + np.arange(n1)[None, None,
                                                             None, :]
            return np.ascontiguousarray(np.broadcast_to((z, y, x)[k], shp))
        return tuple(self._t(("idx", key, k), lambda k=k: make(k))
                     for k in range(3))

    def _gids(self, key, gids, nmb):
        """The gids as a device index, clamped into [0, nmb): a warm start
        from the potential of the tree before an update reads it at the
        new tree's gids, as the JAX package's clamping gather does."""
        return self._t(("gids", key, nmb),
                       lambda: np.minimum(gids, nmb - 1))

    def _blocks_to_levels(self, f):
        """Block interiors [nmb, n3, n2, n1] -> the dense levels [root,
        box_1, ..., box_L]."""
        gi = self.mesh.mesh_indcs
        shape0 = (max(gi.nx3, 1), max(gi.nx2, 1), gi.nx1)
        g0 = torch.zeros(shape0, dtype=f.dtype, device=f.device)
        zz, yy, xx = self._leaf_idx("root", self.root_gids, self.root_off)
        g0[zz, yy, xx] = f[self._gids("root", self.root_gids, f.shape[0])]
        out = [g0]
        for li, bl in enumerate(self.boxes, 1):
            g = torch.zeros(bl.shape, dtype=f.dtype, device=f.device)
            if bl.leaf_gids.size:
                zz, yy, xx = self._leaf_idx(li, bl.leaf_gids, bl.leaf_off)
                g[zz, yy, xx] = f[self._gids(li, bl.leaf_gids, f.shape[0])]
            out.append(g)
        return out

    def _levels_to_blocks(self, levels, dtype):
        """The dense levels -> [nmb, 1, nc3, nc2, nc1], ghosts zero."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        out = torch.zeros((mesh.nmb_total, 1, mbi.ncells3, mbi.ncells2,
                           mbi.ncells1), dtype=dtype, device=self.device)
        inner = out[(slice(None), 0) + self.act_in]      # a view
        zz, yy, xx = self._leaf_idx("root", self.root_gids, self.root_off)
        inner[self._gids("root", self.root_gids, mesh.nmb_total)] = \
            levels[0][zz, yy, xx]
        for li, (bl, g) in enumerate(zip(self.boxes, levels[1:]), 1):
            if bl.leaf_gids.size:
                zz, yy, xx = self._leaf_idx(li, bl.leaf_gids, bl.leaf_off)
                inner[self._gids(li, bl.leaf_gids, mesh.nmb_total)] = \
                    g[zz, yy, xx]
        return out

    # ------------------------------------------------------------------
    # box-level helpers
    # ------------------------------------------------------------------
    def _act_vec(self):
        return np.array([1 if self.active[2] else 0,
                         1 if self.active[1] else 0, 1])

    def _core(self, bl):
        v = self._act_vec()
        return tuple(slice(int(a), int(s - a)) for a, s in zip(v, bl.shape))

    def _scale_up(self, idx):
        return idx * (1 + self._act_vec())

    def _coarse_window(self, li):
        """The coarse index window covering box li, with a margin for the
        prolongation stencil's wrap."""
        bl = self.boxes[li - 1]
        cshape = self.glevels[0][0] if li == 1 else self.boxes[li - 2].shape
        v = self._act_vec()
        lo = bl.lo.copy()
        hi = bl.lo + np.array(bl.shape)
        clo = np.where(v > 0, np.floor_divide(lo - 1, 2), lo)
        chi = np.where(v > 0, -np.floor_divide(-(hi + 1), 2), hi)
        if li == 1:
            clo = np.maximum(clo, 0)
            chi = np.minimum(chi, np.array(cshape))
        else:
            coff = self.boxes[li - 2].lo
            clo = np.maximum(clo, coff) - coff
            chi = np.minimum(chi, coff + np.array(cshape)) - coff
        csl = tuple(slice(int(a), int(b)) for a, b in zip(clo, chi))
        return (clo if li == 1 else clo + self.boxes[li - 2].lo), csl

    def _box_window(self, li, coarse):
        """The prolongation of the coarse window, cut to box li."""
        bl = self.boxes[li - 1]
        clo, csl = self._coarse_window(li)
        fine_full = self._prolong(coarse[csl])
        off = bl.lo - self._scale_up(clo)
        return fine_full[tuple(slice(int(o), int(o + s))
                               for o, s in zip(off, bl.shape))]

    def _box_set_border(self, li, g, coarse):
        """The Dirichlet border of box level li, linearly interpolated
        from the coarser level (the global root for li == 1)."""
        return torch.where(self._box_t(li, "border"),
                           self._box_window(li, coarse), g)

    def _coarse_sl(self, li, shape_r):
        """The slice placing the restricted box core in the coarse
        array."""
        bl = self.boxes[li - 1]
        v = self._act_vec()
        lo_c = (bl.lo + v) // (1 + v)
        coff = np.zeros(3, dtype=np.int64) if li == 1 \
            else self.boxes[li - 2].lo
        return tuple(slice(int(a - o), int(a - o + s))
                     for a, o, s in zip(lo_c, coff, shape_r))

    def _coarse_dxs(self, li):
        return self.glevels[0][1] if li == 1 else self.boxes[li - 2].dxs

    def _interface_corr(self, li, phi_b, phi_c, cov, sl):
        """The conservative interface (reflux) correction to the coarse
        rhs at uncovered cells next to the covered region: the naive
        coarse face gradient replaced by the restricted fine-face
        gradient mean.  Zero away from the interface."""
        bl = self.boxes[li - 1]
        core = self._core(bl)
        dxs_c = self._coarse_dxs(li)
        act = self._box_t(li, "active")
        bord = self._box_t(li, "border")
        corr = torch.zeros_like(phi_c)
        axdx = [(2, bl.dxs[2], dxs_c[2])]
        if self.active[1]:
            axdx.append((1, bl.dxs[1], dxs_c[1]))
        if self.active[2]:
            axdx.append((0, bl.dxs[0], dxs_c[0]))
        for ax, hf, hc in axdx:
            for sh in (1, -1):
                m = act & torch.roll(bord, sh, dims=ax)
                phi_bd = torch.roll(phi_b, sh, dims=ax)
                val = torch.where(m, (phi_b - phi_bd) / hf, 0.0)
                fhat = 2.0 * self._restrict(val[core])
                fld = torch.zeros_like(phi_c)
                fld[sl] = fhat
                fhat_c = torch.roll(fld, -sh, dims=ax)
                c_mask = (~cov) & torch.roll(cov, -sh, dims=ax) \
                    & (fhat_c != 0.0)
                phi_d = torch.roll(phi_c, -sh, dims=ax)
                naive = (phi_d - phi_c) / hc ** 2
                corr = corr + torch.where(c_mask, naive - fhat_c / hc, 0.0)
        return corr

    def _inject(self, li, phi_l, coarse_phi):
        """restrict(phi_l) placed on box li's covered cells of the coarse
        level; returns (phi_c, act_r, sl)."""
        bl = self.boxes[li - 1]
        core = self._core(bl)
        phi_r = self._restrict(phi_l[core])
        act_r = self._t(("act_r", li),
                        lambda: self._restrict_mask(bl.active[core]))
        sl = self._coarse_sl(li, phi_r.shape)
        phi_c = coarse_phi.clone()
        phi_c[sl] = torch.where(act_r, phi_r, coarse_phi[sl])
        return phi_c, act_r, sl

    def _box_coarsen(self, li, phi_l, res_l, coarse_phi, coarse_rhs):
        """restrict(phi_l) and the tau-corrected rhs injected into the
        coarser level on the covered region, with the reflux correction
        of the uncovered cells at the interface.  Returns (phi_c, rhs_c)."""
        bl = self.boxes[li - 1]
        phi_c, act_r, sl = self._inject(li, phi_l, coarse_phi)
        res_r = self._restrict(res_l[self._core(bl)])
        lap_c = self._lap(phi_c, self._coarse_dxs(li),
                          0 if li == 1 else None)
        pad = torch.zeros_like(coarse_rhs)
        pad[sl] = torch.where(act_r, res_r, 0.0)
        cov = self._cov_mask(li)
        rhs_c = torch.where(cov, lap_c + pad, coarse_rhs)
        rhs_c = rhs_c + self._interface_corr(li, phi_l, phi_c, cov, sl)
        if li == 1 and self.periodic:
            # the root subproblem's own compatibility
            rhs_c = rhs_c - torch.mean(rhs_c)
        return phi_c, rhs_c

    def _cov_mask(self, li):
        """The coarse cells covered by box level li."""
        def make():
            bl = self.boxes[li - 1]
            act_r = self._restrict_mask(bl.active[self._core(bl)])
            shape = self.glevels[0][0] if li == 1 \
                else self.boxes[li - 2].shape
            m = np.zeros(shape, dtype=bool)
            m[self._coarse_sl(li, act_r.shape)] = act_r
            return m
        return self._t(("cov", li), make)

    def _restrict_mask(self, m):
        x = m.astype(np.float64)
        if self.active[2]:
            x = x.reshape(x.shape[0] // 2, 2, x.shape[1],
                          x.shape[2]).mean(axis=1)
        if self.active[1]:
            x = x.reshape(x.shape[0], x.shape[1] // 2, 2,
                          x.shape[2]).mean(axis=2)
        x = x.reshape(x.shape[0], x.shape[1], x.shape[2] // 2,
                      2).mean(axis=3)
        return x > 0.5

    def _box_correct(self, li, phi_l, phi_c, phi_c0):
        """The coarse correction prolonged into box li (active + border)."""
        corr = self._box_window(li, phi_c - phi_c0)
        upd = self._t(("upd", li), lambda: self.boxes[li - 1].active
                      | self.boxes[li - 1].border)
        return torch.where(upd, phi_l + corr, phi_l)

    # ------------------------------------------------------------------
    # the FAS / MLAT V-cycle over [boxes L..1] + [global stack]
    # ------------------------------------------------------------------
    def _vcycle_glob(self, gi, g, rhs):
        shape, dxs = self.glevels[gi]
        red = self._g_red(shape)
        if gi + 1 >= len(self.glevels):
            return _repeat(self.nbottom, lambda v: self._smooth(
                v, rhs, dxs, red, 1.0, gi=gi), g)
        g = _repeat(self.npre, lambda v: self._smooth(
            v, rhs, dxs, red, self.omega, gi=gi), g)
        res = rhs - self._lap(g, dxs, gi)
        g0c = self._restrict(g)
        rhsc = self._lap(g0c, self.glevels[gi + 1][1], gi + 1) \
            + self._restrict(res)
        gc = self._vcycle_glob(gi + 1, g0c, rhsc)
        g = g + self._prolong(gc - g0c, gi=gi + 1)
        return _repeat(self.npost, lambda v: self._smooth(
            v, rhs, dxs, red, self.omega, gi=gi), g)

    def _vcycle_box(self, li, levels, rhs_levels):
        """A V-cycle from box level li (len(boxes) is the finest) down;
        returns the updated list of levels."""
        if li == 0:
            return [self._vcycle_glob(0, levels[0], rhs_levels[0])] \
                + levels[1:]
        bl = self.boxes[li - 1]
        rhs = rhs_levels[li]
        coarse = levels[li - 1]
        phi = self._box_set_border(li, levels[li], coarse)
        red = self._box_t(li, "red")
        am = self._box_t(li, "active")
        phi = _repeat(self.npre, lambda v: self._smooth(
            v, rhs, bl.dxs, red, self.omega, update_mask=am), phi)
        res = torch.where(am, rhs - self._lap(phi, bl.dxs, None), 0.0)
        phi_c0, rhs_c = self._box_coarsen(li, phi, res, coarse,
                                          rhs_levels[li - 1])
        levels3 = self._vcycle_box(
            li - 1, levels[:li - 1] + [phi_c0] + levels[li:],
            rhs_levels[:li - 1] + [rhs_c] + rhs_levels[li:])
        phi = self._box_correct(li, phi, levels3[li - 1], phi_c0)
        phi = self._box_set_border(li, phi, levels3[li - 1])
        phi = _repeat(self.npost, lambda v: self._smooth(
            v, rhs, bl.dxs, red, self.omega, update_mask=am), phi)
        return levels3[:li] + [phi] + levels3[li + 1:]

    # ------------------------------------------------------------------
    def _source_mask(self, nmb):
        """[nmb, n3, n2, n1] True inside mask_radius (reference:
        multigrid.cpp:355-385), from the tree's cell centres."""
        if self._src_mask is None:
            mbi = self.mesh.mb_indcs
            m = np.ones((nmb,) + self._nxb, dtype=bool)
            ox, oy, oz = self.mask_origin
            r2m = self.mask_radius ** 2
            for g in range(min(nmb, self.mesh.nmb_total)):
                c1, c2, c3 = self.mesh.cell_centers(g)
                c1 = c1[mbi.is_:mbi.ie + 1] - ox
                c2 = c2[mbi.js:mbi.je + 1] - oy
                c3 = c3[mbi.ks:mbi.ke + 1] - oz
                m[g] = (c1[None, None, :] ** 2 + c2[None, :, None] ** 2
                        + c3[:, None, None] ** 2) <= r2m
            self._src_mask = torch.as_tensor(m, device=self.device)
        return self._src_mask

    def _make_rhs_levels(self, u):
        """four_pi_G (rho - <rho>) in the dense levels."""
        rho = u[(slice(None), 0) + self.act_in]
        if self.mask_radius > 0.0:
            rho = torch.where(self._source_mask(rho.shape[0]), rho, 0.0)
        if self.subtract_average:
            mean = torch.sum(rho * self._vol.to(rho.dtype)) / self.total_vol
            rho = rho - mean
        return self._blocks_to_levels(self.four_pi_G * rho)

    def _composite_defect(self, levels, rhs_levels):
        """The volume-weighted L2 defect over the owned cells of every
        level with the conservative composite operator (reference:
        CalculateDefectNorm, multigrid_driver.cpp:905-937): fine levels
        see borders interpolated from the coarse solution, coarse levels
        freshly injected fine values and the reflux correction."""
        acc = 0.0
        phi_cur = None
        corr_next = None
        for li in range(len(self.boxes), 0, -1):
            bl = self.boxes[li - 1]
            phi = levels[li] if phi_cur is None else phi_cur
            phi = self._box_set_border(li, phi, levels[li - 1])
            rhs_eff = rhs_levels[li]
            if corr_next is not None:
                rhs_eff = rhs_eff + corr_next
            r = rhs_eff - self._lap(phi, bl.dxs, None)
            acc = acc + torch.sum(torch.where(
                self._box_t(li, "owned"), r ** 2, 0.0)) \
                * float(np.prod(bl.dxs))
            coarse, _, sl = self._inject(li, phi, levels[li - 1])
            corr_next = self._interface_corr(li, phi, coarse,
                                             self._cov_mask(li), sl)
            phi_cur = coarse
        g = levels[0] if phi_cur is None else phi_cur
        dxs = self.glevels[0][1]
        rhs0 = rhs_levels[0]
        if corr_next is not None:
            rhs0 = rhs0 + corr_next
        r = rhs0 - self._lap(g, dxs, 0)
        r2 = r ** 2 if not self.boxes else \
            torch.where(~self._cov_mask(1), r ** 2, 0.0)
        acc = acc + torch.sum(r2) * float(np.prod(dxs))
        return torch.sqrt(acc / self.total_vol)

    def _fmg_start(self, rhs_levels):
        """The full-multigrid first guess (reference: SolveFMG,
        multigrid_driver.cpp:739-747)."""
        rhs_eff = list(rhs_levels)
        for li in range(len(self.boxes), 0, -1):
            bl = self.boxes[li - 1]
            core = self._core(bl)
            r = self._restrict(rhs_eff[li][core])
            act_r = self._t(("act_r", li),
                            lambda: self._restrict_mask(bl.active[core]))
            sl = self._coarse_sl(li, r.shape)
            c = rhs_eff[li - 1].clone()
            c[sl] = torch.where(act_r, r, c[sl])
            rhs_eff[li - 1] = c
        rhs_g = [rhs_eff[0]]
        for _ in range(len(self.glevels) - 1):
            rhs_g.append(self._restrict(rhs_g[-1]))
        shape, dxs = self.glevels[-1]
        red = self._g_red(shape)
        g = torch.zeros(shape, dtype=rhs_g[-1].dtype, device=self.device)
        g = _repeat(self.nbottom, lambda v: self._smooth(
            v, rhs_g[-1], dxs, red, 1.0, gi=len(self.glevels) - 1), g)
        for gi in range(len(self.glevels) - 2, -1, -1):
            g = self._prolong(g, gi=gi + 1)
            for _ in range(self.fmg_ncycle):
                g = self._vcycle_glob(gi, g, rhs_g[gi])
        levels = [g]
        for li in range(1, len(self.boxes) + 1):
            levels.append(self._box_window(li, levels[li - 1]))
            for _ in range(self.fmg_ncycle):
                levels = self._vcycle_box(li, levels, rhs_eff[:li + 1]
                                          + rhs_levels[li + 1:])
        return levels

    def _iterate(self, levels, rhs_levels):
        """V-cycles to the threshold (one host read of the defect a
        cycle) or ``niteration`` of them."""
        top = len(self.boxes)
        n = 0
        if self.eps >= 0.0:
            max_it = self.niter if self.niter > 0 else 40
            d = self._composite_defect(levels, rhs_levels)
            while n < max_it and bool(d > self.eps):
                levels = self._vcycle_box(top, levels, rhs_levels)
                d = self._composite_defect(levels, rhs_levels)
                n += 1
        else:
            for _ in range(max(self.niter, 1)):
                levels = self._vcycle_box(top, levels, rhs_levels)
                n += 1
        self.last_cycles = n
        self.ncycles += n
        return levels

    # ------------------------------------------------------------------
    # multipole boundary values (reference: multigrid_driver.cpp:
    # 2210-2366, multigrid.hpp:679-708, 2371-2434)
    # ------------------------------------------------------------------
    def _block_coords(self, dtype):
        """Cell-centre coordinates (x, y, z) of the block interiors,
        broadcastable to [nmb, n3, n2, n1]."""
        mbi = self.mesh.mb_indcs
        mbs = self.mesh.mb_size

        def ax(name, n):
            lo = np.asarray(mbs[f"{name}min"], np.float64)[:, None]
            d = np.asarray(mbs["d" + name], np.float64)[:, None]
            return lo + (np.arange(n)[None, :] + 0.5) * d
        x = ax("x1", mbi.nx1)[:, None, None, :]
        y = ax("x2", max(mbi.nx2, 1))[:, None, :, None]
        z = ax("x3", max(mbi.nx3, 1))[:, :, None, None]
        return tuple(torch.as_tensor(a, dtype=dtype, device=self.device)
                     for a in (x, y, z))

    def _mp_harmonics(self, x, y, z, s):
        """The raw moments, sums of s times the solid harmonics
        (multigrid_driver.cpp:2244-2300); [25], unused entries zero."""
        x2, y2, z2 = x * x, y * y, z * z
        xy, yz, zx = x * y, y * z, z * x
        r2 = x2 + y2 + z2
        hx2my2 = 0.5 * (x2 - y2)
        mp = [None] * 25
        mp[0] = torch.ones_like(s)
        if self.nodipole:
            mp[1] = mp[2] = mp[3] = torch.zeros_like(s)
        else:
            mp[1], mp[2], mp[3] = y, z, x
        mp[4], mp[5] = xy, yz
        mp[6] = 3.0 * z2 - r2
        mp[7], mp[8] = zx, hx2my2
        if self.mporder == 4:
            tx2my2 = 3.0 * x2 - y2
            x2mty2 = x2 - 3.0 * y2
            fz2mr2 = 5.0 * z2 - r2
            sz2mr2 = 7.0 * z2 - r2
            sz2mtr2 = 7.0 * z2 - 3.0 * r2
            mp[9] = y * tx2my2
            mp[10] = xy * z
            mp[11] = y * fz2mr2
            mp[12] = z * (z2 - 3.0 * r2)
            mp[13] = x * fz2mr2
            mp[14] = z * hx2my2
            mp[15] = x * x2mty2
            mp[16] = xy * hx2my2
            mp[17] = yz * tx2my2
            mp[18] = xy * sz2mr2
            mp[19] = yz * sz2mtr2
            mp[20] = 35.0 * z2 * z2 - 30.0 * z2 * r2 + 3.0 * r2 * r2
            mp[21] = zx * sz2mtr2
            mp[22] = hx2my2 * sz2mr2
            mp[23] = zx * x2mty2
            mp[24] = 0.125 * (x2 * x2mty2 - y2 * tx2my2)
        else:
            for c in range(9, 25):
                mp[c] = torch.zeros_like(s)
        return torch.stack([torch.sum(s * h) for h in mp])

    @classmethod
    def _mp_scale(cls):
        """The normalisation constants (reference:
        ScaleMultipoleCoefficients, multigrid_driver.cpp:2320-2366)."""
        if cls._MP_SCALE is None:
            pi = np.pi
            c0 = c1 = 0.25 / pi
            c2 = 0.0625 / pi
            c2a = 0.75 / pi
            c30 = 0.0625 / pi
            c31 = 0.0625 * 1.5 / pi
            c32 = 0.25 * 15.0 / pi
            c33 = 0.0625 * 2.5 / pi
            c40 = 0.0625 * 0.0625 / pi
            c41 = 0.0625 * 2.5 / pi
            c42 = 0.0625 * 5.0 / pi
            c43 = 0.0625 * 17.5 / pi
            c44 = 0.25 * 35.0 / pi
            cls._MP_SCALE = np.array(
                [c0, c1, c1, c1, c2a, c2a, c2, c2a, c2a,
                 c33, c32, c31, c30, c31, c32, c33,
                 c44, c43, c42, c41, c40, c41, c42, c43, c44])
        return cls._MP_SCALE

    def _eval_mp_phi(self, mpc, x, y, z):
        """phi_mp at (x, y, z) relative to the expansion origin
        (reference: EvalMultipolePhi, multigrid.hpp:679-708)."""
        x2, y2, z2 = x * x, y * y, z * z
        xy, yz, zx = x * y, y * z, z * x
        r2 = x2 + y2 + z2
        ir2 = 1.0 / r2
        ir1 = torch.sqrt(ir2)
        ir3 = ir2 * ir1
        ir5 = ir3 * ir2
        hx2my2 = 0.5 * (x2 - y2)
        phis = (ir1 * mpc[0]
                + ir3 * (mpc[1] * y + mpc[2] * z + mpc[3] * x)
                + ir5 * (mpc[4] * xy + mpc[5] * yz
                         + (3.0 * z2 - r2) * mpc[6]
                         + mpc[7] * zx + mpc[8] * hx2my2))
        if self.mporder == 4:
            ir7 = ir5 * ir2
            ir9 = ir7 * ir2
            x2mty2 = x2 - 3.0 * y2
            tx2my2 = 3.0 * x2 - y2
            phis = phis + ir7 * (
                y * tx2my2 * mpc[9] + x * x2mty2 * mpc[15]
                + xy * z * mpc[10] + z * hx2my2 * mpc[14]
                + (5.0 * z2 - r2) * (y * mpc[11] + x * mpc[13])
                + z * (z2 - 3.0 * r2) * mpc[12]) + ir9 * (
                xy * hx2my2 * mpc[16]
                + 0.125 * (x2 * x2mty2 - y2 * tx2my2) * mpc[24]
                + yz * tx2my2 * mpc[17] + zx * x2mty2 * mpc[23]
                + (7.0 * z2 - r2) * (xy * mpc[18] + hx2my2 * mpc[22])
                + (7.0 * z2 - 3.0 * r2) * (yz * mpc[19] + zx * mpc[21])
                + (35.0 * z2 * z2 - 30.0 * z2 * r2
                   + 3.0 * r2 * r2) * mpc[20])
        return phis

    def _multipole_setup(self, u):
        """The multipole coefficients of the source and the boundary-face
        slabs of phi_mp on every global level."""
        rho = u[(slice(None), 0) + self.act_in]
        dt = rho.dtype
        # moments of src = -4 pi G rho (positive scaling constants give
        # the attractive, negative potential)
        s = -self.four_pi_G * rho * self._vol.to(dt)
        xs, ys, zs = self._block_coords(dt)
        if self.autompo:
            tot = torch.sum(s)
            xo = torch.sum(s * xs) / tot
            yo = torch.sum(s * ys) / tot
            zo = torch.sum(s * zs) / tot
        else:
            xo, yo, zo = [torch.tensor(v, dtype=dt, device=self.device)
                          for v in self.mpo]
        mpc = self._mp_harmonics(xs - xo, ys - yo, zs - zo, s)
        mpc = mpc * torch.as_tensor(self._mp_scale(), dtype=dt,
                                    device=self.device)
        self.mp_coeffs, self.mp_origin = mpc, (xo, yo, zo)
        ms = self.mesh.mesh_size
        lims = ((ms.x3min, ms.x3max), (ms.x2min, ms.x2max),
                (ms.x1min, ms.x1max))
        self._mp = []
        for shape, dxs in self.glevels:
            slabs = {}
            cc = [lims[a][0] + (np.arange(shape[a]) + 0.5) * dxs[a]
                  for a in range(3)]
            for ax in range(3):
                for side, flag in enumerate(self.bc_flags[ax]):
                    if flag != "multipole":
                        continue
                    oth = [a for a in range(3) if a != ax]
                    g0, g1 = np.meshgrid(cc[oth[0]], cc[oth[1]],
                                         indexing="ij")
                    vals = [None, None, None]
                    vals[oth[0]] = torch.as_tensor(g0, dtype=dt,
                                                   device=self.device)
                    vals[oth[1]] = torch.as_tensor(g1, dtype=dt,
                                                   device=self.device)
                    vals[ax] = torch.full(g0.shape, lims[ax][side],
                                          dtype=dt, device=self.device)
                    z, y, x = vals      # array axes (0, 1, 2) = (x3, x2, x1)
                    phi = self._eval_mp_phi(mpc, x - xo, y - yo, z - zo)
                    slabs[(ax, side)] = phi.unsqueeze(ax)
            self._mp.append(slabs)

    # ------------------------------------------------------------------
    def solve(self, u, bvals, phi0=None):
        """phi [nmb, 1, n3, n2, n1] with its ghosts filled.  ``phi0``, the
        previous stage's potential, is the first guess; without it the
        full-multigrid start (``full_multigrid``) or zeros.  On one
        rank's blocks the density and ``phi0`` of every block come
        through an all-gather each (``comm.whole_blocks``), every rank
        solves on the whole mesh (so each reads the same defect and takes
        the same V-cycles) and keeps its own blocks' potential, whose
        ghosts the rank exchange fills."""
        u = whole_blocks(u[:, :1])
        if phi0 is not None:
            phi0 = whole_blocks(phi0)
        phi = self._solve_whole(u, phi0)
        return bvals.fill_ghosts(own_blocks(phi))

    def _solve_whole(self, u, phi0):
        """The solve on every block: phi [nmb, 1, ...], ghosts zero."""
        if self.mg_bc == "multipole":
            self._multipole_setup(u)
        rhs_levels = self._make_rhs_levels(u)
        if phi0 is not None:
            levels = self._blocks_to_levels(
                phi0[(slice(None), 0) + self.act_in])
        elif self.fmg:
            levels = self._fmg_start(rhs_levels)
        else:
            levels = self._zero_levels(u.dtype)
        levels = self._iterate(levels, rhs_levels)
        phi = self._levels_to_blocks(levels, u.dtype)
        if self.subtract_average:
            act = (slice(None), slice(None)) + self.act_in
            mean = torch.sum(phi[act] * self._vol.to(u.dtype)[:, None]) \
                / self.total_vol
            phi = phi - mean
        self.nsolve += 1
        return phi

    def _zero_levels(self, dtype):
        return [torch.zeros(self.glevels[0][0], dtype=dtype,
                            device=self.device)] \
            + [torch.zeros(bl.shape, dtype=dtype, device=self.device)
               for bl in self.boxes]

    def solve_verbose(self, u) -> List[float]:
        """A solve that prints the reference's defect lines (reference:
        SolveIterative, multigrid_driver.cpp:788-860); returns the
        defect history and keeps the interior potential in
        ``_last_phi``.  On one rank's blocks every rank solves on the
        whole mesh (``comm.whole_blocks``) and rank 0 prints."""
        cur = current_comm()
        loud = cur is None or cur.rank == 0
        u = whole_blocks(u[:, :1])
        if self.mg_bc == "multipole":
            self._multipole_setup(u)
        rhs_levels = self._make_rhs_levels(u)
        levels = self._fmg_start(rhs_levels) if self.fmg \
            else self._zero_levels(u.dtype)
        top = len(self.boxes)
        d = float(self._composite_defect(levels, rhs_levels))
        hist = [d]
        if loud:
            print(f"MG initial defect = {d:.15e}")
        n = 0
        max_it = self.niter if self.niter > 0 else 40
        while n < max_it:
            levels = self._vcycle_box(top, levels, rhs_levels)
            d = float(self._composite_defect(levels, rhs_levels))
            hist.append(d)
            if self.show_defect >= 2 and loud:
                print(f"MG iteration {n}: defect = {d:.15e}")
            n += 1
            if self.eps >= 0.0 and d <= self.eps:
                break
        if loud:
            print("MGGravityDriver::Solve: Final defect norm = "
                  f"{d:.15e}")
        self._last_phi = self._levels_to_blocks(levels, u.dtype)
        return hist
