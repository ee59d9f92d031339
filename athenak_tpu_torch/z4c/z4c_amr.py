"""Z4c refinement strategies and the trilinear interpolation of the
puncture trackers.

Counterpart of ``athenak_tpu/z4c/z4c_amr.py`` (reference:
src/z4c/z4c_amr.{hpp,cpp}, src/z4c/compact_object_tracker.cpp): the
``<z4c_amr>`` methods ``trivial``, ``tracker``, ``chi`` and ``dchi`` (the
last two a per-block reduction of the conformal factor on the device),
the ``radius_N_rad`` / ``radius_N_reflevel`` minimum-level shells (host
logic on the block extents), and ``device_interp``, the trilinear
interpolation on the device that moves the trackers
(``Z4c.post_cycle``): the owning block of each point is found by
bounding-box containment over the blocks' extents, which works on any
leaf tiling; the extents are copied to the device once a mesh, so a
cycle makes no host round trip.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..amr import block_interior, centred_diff_sq
from ..comm import current_comm, global_sum, local_blocks
from .z4c import I_CHI


def _interp_tables(mesh, device, dtype):
    """(lo, hi, dx, top) of ``device_interp`` on ``device`` at ``dtype``:
    the blocks' lower and upper corners and spacings [nmb, 3] and the
    largest position inside the mesh [1, 3], made once a mesh."""
    cache = mesh.__dict__.setdefault("_interp_tables", {})
    key = (str(device), dtype)
    if key not in cache:
        sz = mesh.mb_size
        lo = np.stack([sz["x1min"], sz["x2min"], sz["x3min"]], axis=1)
        hi = np.stack([sz["x1max"], sz["x2max"], sz["x3max"]], axis=1)
        dx = np.stack([sz["dx1"], sz["dx2"], sz["dx3"]], axis=1)
        ms = mesh.mesh_size
        top = np.array([ms.x1max, ms.x2max, ms.x3max]) \
            - 1e-6 * dx.min(axis=0)
        cache[key] = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                           for a in (lo, hi, dx, top[None, :]))
    return cache[key]


def device_interp(mesh, u, chans: List[int], pos):
    """Trilinear interpolation of channels ``chans`` of the block array
    ``u`` [nmb, nch, n3, n2, n1] (ghosts filled) at the points ``pos``
    [npts, 3], on ``u``'s device; returns [npts, len(chans)].  A point
    belongs to the first block whose half-open box holds it (a point on
    the mesh's upper faces is pulled inside first).  On one rank's blocks
    of a group (``comm.use_comm``) the owning rank interpolates and a SUM
    all-reduce hands every rank the values (JAX z4c_amr.py:41-100): the
    boxes are half-open and each block is on one rank, so exactly one
    rank adds each point's values to zeros."""
    mbi = mesh.mb_indcs
    dt = u.dtype
    lo, hi, dx, top = (local_blocks(t) for t in
                       _interp_tables(mesh, u.device, dt))
    pos = torch.minimum(pos.to(dt), top)
    inside = ((pos[:, None, :] >= lo[None]) & (pos[:, None, :] < hi[None])
              ).all(dim=-1)                                     # [np, nmb]
    gid = torch.argmax(inside.to(torch.int32), dim=1)           # [np]
    ng = mbi.ng
    ncell = (mbi.ncells1, mbi.ncells2, mbi.ncells3)
    act = (mbi.nx1 > 1, mbi.nx2 > 1, mbi.nx3 > 1)
    i0, w = [], []
    for d in range(3):
        if not act[d]:
            i0.append(torch.zeros_like(gid))
            w.append(torch.zeros_like(pos[:, 0]))
            continue
        # cell centres: x = lo + (i - ng + 0.5) dx
        fi = (pos[:, d] - lo[gid, d]) / dx[gid, d] + (ng - 0.5)
        ii = torch.clamp(torch.floor(fi), 0, ncell[d] - 2).to(torch.int64)
        i0.append(ii)
        w.append(fi - ii.to(dt))
    ch = torch.as_tensor(chans, device=u.device)
    out = torch.zeros((pos.shape[0], len(chans)), dtype=dt, device=u.device)
    for dk in range(2):
        for dj in range(2):
            for di in range(2):
                # an axis of one cell reads its cell for both corners
                # (weight 0 on the second)
                kk, jj, ii = (torch.clamp(i0[d] + o, max=ncell[d] - 1)
                              for d, o in ((2, dk), (1, dj), (0, di)))
                c = u[gid[:, None], ch[None, :], kk[:, None], jj[:, None],
                      ii[:, None]]
                wt = ((w[2] if dk else 1.0 - w[2])
                      * (w[1] if dj else 1.0 - w[1])
                      * (w[0] if di else 1.0 - w[0]))
                out = out + wt[:, None] * c
    if current_comm() is not None:
        own = inside.any(dim=1)
        out = global_sum(torch.where(own[:, None], out,
                                     torch.zeros_like(out)))
    return out


class Z4cAMR:
    """Parsed <z4c_amr> block (reference: Z4c_AMR::Z4c_AMR,
    z4c_amr.cpp:27-57): one exclusive method (trivial/tracker/chi/dchi)
    plus optional radius_N_rad / radius_N_reflevel minimum-level
    shells."""

    def __init__(self, pin) -> None:
        self.method = pin.get_or_add_string("z4c_amr", "method", "trivial")
        # deck aliases (reference inputs/z4c decks use chi_min / dchi_max
        # for what z4c_amr.cpp:30-43 calls chi / dchi)
        self.method = {"chi_min": "chi", "dchi_max": "dchi"}.get(
            self.method, self.method)
        if self.method not in ("trivial", "tracker", "chi", "dchi"):
            raise ValueError(
                f"<z4c_amr> method={self.method} unknown "
                "(trivial/tracker/chi/dchi)")
        self.chi_thresh = pin.get_or_add_real("z4c_amr", "chi_min", 0.2) \
            if self.method == "chi" else None
        self.dchi_thresh = pin.get_or_add_real(
            "z4c_amr", "dchi_max", 0.01) if self.method == "dchi" else None
        self.radius: List[float] = []
        self.reflevel: List[int] = []
        for nr in range(16):
            name = f"radius_{nr}_rad"
            if not pin.does_parameter_exist("z4c_amr", name):
                break
            self.radius.append(pin.get_real("z4c_amr", name))
            self.reflevel.append(pin.get_or_add_integer(
                "z4c_amr", f"radius_{nr}_reflevel", -1))

    # -- device part: chi / dchi block reductions -----------------------
    def device_flags(self, u, mesh):
        """int32 [nmb] flags of the chi/dchi methods on ``u``'s device
        (reference: RefineChiMin / RefineDchiMax, z4c_amr.cpp:133-226)."""
        mbi = mesh.mb_indcs
        chi = u[:, I_CHI]
        zero = torch.zeros(chi.shape[0], dtype=torch.int32, device=u.device)
        if self.method == "chi":
            qmin = torch.amin(block_interior(chi, mbi), dim=(1, 2, 3))
            t = self.chi_thresh
            return torch.where(qmin < t, 1,
                               torch.where(qmin > 1.25 * t, -1, zero))
        if self.method == "dchi":
            dmax = torch.amax(block_interior(
                torch.sqrt(centred_diff_sq(chi, mbi)), mbi), dim=(1, 2, 3))
            t = self.dchi_thresh
            return torch.where(dmax > t, 1,
                               torch.where(dmax < 0.5 * t, -1, zero))
        return zero

    # -- host part: tracker boxes and radial shells ---------------------
    def host_flags(self, flags, state, mesh, phys) -> np.ndarray:
        """The tracker method (the exact distance from each tracker to
        each block's box; reference: RefineTracker, z4c_amr.cpp:72-131;
        the [nco, 3] positions are read back from the device) and the
        RefineRadii minimum-level shells (z4c_amr.cpp:228-275): a block
        whose nearest corner lies inside a shell is refined up to the
        shell's level and not derefined at it."""
        sz = mesh.mb_size
        lev = np.asarray(mesh.mb_lev)
        x1min, x1max = sz["x1min"], sz["x1max"]
        x2min, x2max = sz["x2min"], sz["x2max"]
        x3min, x3max = sz["x3min"], sz["x3max"]

        if self.method == "tracker" and getattr(phys, "nco", 0) > 0:
            if "co_pos" in state:
                pos = state["co_pos"].detach().to(
                    device="cpu", dtype=torch.float64).numpy()
            else:
                pos = np.asarray(phys.tracker_pos0, dtype=np.float64)
            rad = np.asarray(phys.tracker_radius)
            rl = np.asarray(phys.tracker_reflevel)
            px, py, pz = pos[:, 0], pos[:, 1], pos[:, 2]
            cx = np.clip(px[None, :], x1min[:, None], x1max[:, None])
            cy = np.clip(py[None, :], x2min[:, None], x2max[:, None])
            cz = np.clip(pz[None, :], x3min[:, None], x3max[:, None])
            dmin2 = ((px[None] - cx) ** 2 + (py[None] - cy) ** 2
                     + (pz[None] - cz) ** 2)
            contained = ((px[None] >= x1min[:, None])
                         & (px[None] <= x1max[:, None])
                         & (py[None] >= x2min[:, None])
                         & (py[None] <= x2max[:, None])
                         & (pz[None] >= x3min[:, None])
                         & (pz[None] <= x3max[:, None]))
            hit = (dmin2 < rad[None] ** 2) | contained
            lv = lev[:, None]
            per = np.where(
                hit,
                np.where((rl[None] < 0) | (lv < rl[None]), 1,
                         np.where(lv == rl[None], 0, -1)),
                -1)
            flags = per.max(axis=1).astype(flags.dtype)

        if self.radius:
            corners = [x1min ** 2 + x2min ** 2 + x3min ** 2]
            for cx in (x1min, x1max):
                for cy in (x2min, x2max):
                    for cz in (x3min, x3max):
                        corners.append(cx ** 2 + cy ** 2 + cz ** 2)
            rmin2 = np.min(np.stack(corners), axis=0)
            for r, rl in zip(self.radius, self.reflevel):
                sel = rmin2 < r * r
                flags[sel & (lev < rl)] = 1
                flags[sel & (lev == rl) & (flags == -1)] = 0
        return flags
