"""The face field and the edge EMFs on a statically refined mesh.

Counterpart of the multilevel methods of ``athenak_tpu/physics/mhd.py``
(``_ml_fc_override`` 556-825, ``_emf_sync`` 826-910, ``_emf_correct``
911-1025, ``_fc_fill_corners`` 1086-1249; reference:
src/bvals/bvals_fc.cpp restriction + prolongation.hpp
ProlongFCShared/ProlongFCInternal, src/bvals/flux_correction_fc.cpp).
On a fine/coarse face the fine side owns the shared face: the coarse
block's copy of it is the area average of the fine faces, and the
coarse block's edge EMFs on the level boundary are the line averages of
the fine ones, so the CT updates of the shared face agree and div(B)
stays at round-off on both levels.

The JAX package writes these functionally; here each function updates
its array in place, reading every donor before it writes the region the
donor feeds, and ``ml_fc_override`` reads its donors from ``src``, the
array as it stood before the sweep.  The operation order is the JAX
package's, so in float64 the results agree bit for bit.
"""

from __future__ import annotations

import torch

from ..bvals import _AXIS_OF
from ..refinement import (_interleave, box, derived, donor_columns,
                          mixed_level, pair_merge, parity,
                          prolong_cc, restrict_cc)

_AXES = ("x1", "x2", "x3")


def _set(region, mask, value) -> None:
    """region <- value on the masked blocks, in place."""
    region.copy_(torch.where(mask, value, region))


def _nx(mesh):
    mbi = mesh.mb_indcs
    return {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}


class DonorBands:
    """The planes of a face-field component that ``ml_fc_override`` reads
    as donors, copied before an axis sweep writes any of them: the bands
    [0, w) and [n - w, n) along the sweep axis, w = 3 ng + 1 (the whole
    array where the two bands meet)."""

    def __init__(self, arr, axis4: int, ng: int):
        n, w = arr.shape[axis4], 3 * ng + 1
        self.axis4 = axis4
        if 2 * w >= n:
            self.data, self.w, self.shift = arr.clone(), n, 0
        else:
            self.data = torch.cat([arr.narrow(axis4, 0, w),
                                   arr.narrow(axis4, n - w, w)], dim=axis4)
            self.w, self.shift = w, n - 2 * w

    def slab(self, lo: int, hi: int, step: int = 1):
        """Planes lo:hi:step of the array as it stood at the copy."""
        if hi <= self.w:
            off = 0
        elif lo - self.shift >= self.w:
            off = self.shift
        else:
            raise ValueError(f"planes [{lo}, {hi}) are not in a donor band")
        return box(self.data, {self.axis4: (lo - off, hi - off, step)})


def ml_fc_override(mesh, active_axes, arr, src, ax: str, comp: str) -> None:
    """Mixed-level overrides for one face-field component in one axis
    sweep, in place on ``arr`` (whose same-level ghosts the sweep has
    written): area-average restriction from finer donors (including the
    shared face, which the fine side owns) and linear prolongation from a
    coarser donor (transverse min-mod on aligned planes, averages on
    internal planes).  Donors are read from ``src``, the ``DonorBands``
    of the pre-sweep array, so donor ghost cells hold the previous
    sweep's values."""
    mbi = mesh.mb_indcs
    tables = mesh.tables
    ng, h = mbi.ng, mbi.ng // 2
    axis4 = _AXIS_OF[ax] - 1
    caxis4 = _AXIS_OF[comp[:2]] - 1  # the component's face-normal axis
    normal = caxis4 == axis4
    nx_of = _nx(mesh)
    nxa = nx_of[ax]
    n4 = arr.shape[axis4]
    active4 = {_AXIS_OF[a] - 1 for a in active_axes}
    dev = arr.device

    for side in ("m", "p"):
        t = mesh.ml[f"{ax}{side}"]
        tn = t["t_names"]
        if not (t["any_fine"] or t["any_coarse"]):
            continue
        # mixed-level blocks: reset the ghost region to the pre-sweep
        # values, so corner rings outside the override write regions keep
        # what earlier sweeps copied (their same-level gather is garbage)
        mlm4 = tables.mask(mixed_level(t), 4, dev)
        if side == "m":
            gspan = (0, ng)
        else:
            gspan = (ng + nxa + 1, n4) if normal else (n4 - ng, n4)
        _set(box(arr, {axis4: gspan}), mlm4, src.slab(*gspan))

        # ---------------- restriction from finer donors ----------------
        if t["any_fine"]:
            fmask = tables.mask(t["fine_mask"], 4, dev)
            cols = donor_columns(t)
            if normal:
                # the plane set includes the shared face (fine-owned)
                if side == "m":
                    planes = (0, ng + 1)
                    dn = (nxa - ng, nxa + ng + 1, 2)
                else:
                    planes = (ng + nxa, n4)
                    dn = (ng, ng + 2 * (n4 - ng - nxa) - 1, 2)
                slab = src.slab(*dn)
                parts = [restrict_cc(tables.gather(slab, col),
                                     [_AXIS_OF[a] - 5 for a in tn])
                         for col in cols]
                for a2 in tn:
                    parts = pair_merge(parts, _AXIS_OF[a2] - 1,
                                   nx_of[a2] // 2 + h, h)
                assembled = parts[0]
                # write the transverse INTERIOR only: the ghost-column
                # parts of the shared plane stay what the sweeps copied
                # from the face's other owner
                spans = {axis4: planes}
                for a2 in tn:
                    ta = _AXIS_OF[a2] - 1
                    assembled = assembled.narrow(ta, ng - h, nx_of[a2])
                    spans[ta] = (ng, ng + nx_of[a2])
                _set(box(arr, spans), fmask, assembled)
            else:
                # transverse component: ghost cells along the sweep axis
                if side == "m":
                    cells, dnc = (0, ng), (n4 - 3 * ng, n4 - ng)
                else:
                    cells, dnc = (n4 - ng, n4), (ng, 3 * ng)
                slab = src.slab(*dnc)
                # pair-average along the sweep axis (cells)
                parts = [restrict_cc(tables.gather(slab, col), [axis4 - 4])
                         for col in cols]
                for a2 in tn:
                    ta = _AXIS_OF[a2] - 1
                    nxt = nx_of[a2]
                    if ta == caxis4:
                        # face axis: stride-2 plane select over
                        # [ng-2h, ng+nxt+2h]
                        parts = [box(p, {ta: (ng - 2 * h,
                                               ng + nxt + 2 * h + 1, 2)})
                                 for p in parts]
                    else:
                        parts = [restrict_cc(p, [ta - 4]) for p in parts]
                    parts = pair_merge(parts, ta, nxt // 2 + h, h)
                spans = {axis4: cells}
                for a2 in tn:
                    ta = _AXIS_OF[a2] - 1
                    spans[ta] = (h, arr.shape[ta] - h)
                _set(box(arr, spans), fmask, parts[0])

        # ---------------- prolongation from a coarser donor ------------
        if t["any_coarse"]:
            cmask = tables.mask(t["coarse_mask"], 4, dev)
            # corner-strip guard: where the diagonal neighbour is
            # same-level or finer the sweeps already copied the true
            # values there (concave trees; see build_ml_tables pkeep)
            for a2 in tn:
                ta = _AXIS_OF[a2] - 1
                ncc = arr.shape[ta]
                shp = [1] * 4
                shp[ta] = ncc
                pos = torch.arange(ncc, device=dev).reshape(shp)
                km = tables.mask(t["pkeep"][a2]["m"], 4, dev)
                kp = tables.mask(t["pkeep"][a2]["p"], 4, dev)
                cmask = cmask & ((pos >= ng) | km) & ((pos < ncc - ng) | kp)

            def window(d, a2, guard):
                """Parity window along cell axis a2: two slices and a
                per-block select."""
                ta = _AXIS_OF[a2] - 1
                half = nx_of[a2] // 2
                ln = half + ng + 2 * guard
                s0 = ng - h - guard
                sel = tables.mask(parity(t, a2), 4, dev)
                return torch.where(sel, d.narrow(ta, s0 + half, ln),
                                   d.narrow(ta, s0, ln))

            if normal:
                if side == "m":
                    planes = range(0, ng)
                    win = (ng + nxa - h, ng + nxa + 1)

                    def off(f):
                        return ng - f

                    def pidx(m):
                        return h - m
                else:
                    planes = range(ng + nxa + 1, n4)
                    win = (ng, ng + h + 1)

                    def off(f):
                        return f - ng - nxa

                    def pidx(m):
                        return m
                d = tables.gather(src.slab(*win), t["coarse"])
                for a2 in tn:
                    d = window(d, a2, 1)
                pro = prolong_cc(d, [_AXIS_OF[a2] - 5 for a2 in tn])

                def plane(m):
                    return pro.narrow(axis4, pidx(m), 1)

                outs = []
                for f in planes:
                    o = off(f)
                    if o % 2 == 0:
                        outs.append(plane(o // 2))
                    else:
                        outs.append(0.5 * (plane((o - 1) // 2)
                                           + plane((o + 1) // 2)))
                _set(box(arr, {axis4: (planes[0], planes[-1] + 1)}), cmask,
                     torch.cat(outs, dim=axis4))
            else:
                if side == "m":
                    cells = (0, ng)
                    dnc = (n4 - ng - h - 1, n4 - ng + 1)
                else:
                    cells = (n4 - ng, n4)
                    dnc = (ng - 1, ng + h + 1)
                d = tables.gather(src.slab(*dnc), t["coarse"])
                cell_axes = [axis4 - 4]
                for a2 in tn:
                    ta = _AXIS_OF[a2] - 1
                    if ta == caxis4:
                        # aligned-plane window along the face axis
                        half = nx_of[a2] // 2
                        ln = half + ng + 1
                        s0 = ng - h
                        sel = tables.mask(parity(t, a2), 4, dev)
                        d = torch.where(sel, d.narrow(ta, s0 + half, ln),
                                        d.narrow(ta, s0, ln))
                    else:
                        d = window(d, a2, 1)
                        cell_axes.append(ta - 4)
                pro = prolong_cc(d, cell_axes)
                if caxis4 in active4:
                    # interleave aligned planes with internal averages
                    w = pro.shape[caxis4]
                    aligned = pro.narrow(caxis4, 0, w - 1)
                    internal = 0.5 * (aligned + pro.narrow(caxis4, 1, w - 1))
                    pro = torch.cat([_interleave(aligned, internal, caxis4),
                                     pro.narrow(caxis4, w - 1, 1)],
                                    dim=caxis4)
                _set(box(arr, {axis4: cells}), cmask, pro)


def emf_sync(mesh, active_axes, es):
    """Average the edge EMFs with every SAME-LEVEL neighbour sharing the
    edge (faces and edge diagonals), so each shared edge is single-valued
    before the fine-replacement pass (reference: flux_correct_fc.cpp
    SumBoundaryFluxes/AverageBoundaryFluxes).  Returns new tensors."""
    mbi = mesh.mb_indcs
    tables = mesh.tables
    ng = mbi.ng
    nx_of = _nx(mesh)
    out = {}
    for c in _AXES:
        e = es[c]
        dev = e.device
        ac = _AXIS_OF[c] - 1
        sum_e = e.clone()
        cnt = torch.ones_like(e)
        dims = [d for d in active_axes if d != c]
        # ---- shared planes with same-level face neighbours
        for d in dims:
            ad = _AXIS_OF[d] - 1
            nxd = nx_of[d]
            for side, my_idx, dn_idx in (("m", ng, ng + nxd),
                                         ("p", ng + nxd, ng)):
                t = mesh.ml[f"{d}{side}"]
                msk = derived(t, "same_level", lambda: ~(
                    t["fine_mask"] | t["coarse_mask"] | t["phys"]))
                span = {ad: (my_idx, my_idx + 1)}
                dspan = {ad: (dn_idx, dn_idx + 1)}
                for o in _AXES:
                    if o not in (c, d) and o in active_axes:
                        ao = _AXIS_OF[o] - 1
                        span[ao] = dspan[ao] = (ng, ng + nx_of[o] + 1)
                if c in active_axes:
                    span[ac] = dspan[ac] = (ng, ng + nx_of[c])
                donor = tables.gather(box(e, dspan), t["same"])
                mb = tables.mask(msk, 4, dev)
                box(sum_e, span).add_(torch.where(mb, donor, 0.0))
                box(cnt, span).add_(
                    torch.where(mb, torch.ones_like(donor), 0.0))
        # ---- shared corner edges with same-level diagonal neighbours
        if len(dims) == 2:
            d1, d2 = dims
            a1, a2 = _AXIS_OF[d1] - 1, _AXIS_OF[d2] - 1
            for s1 in ("m", "p"):
                for s2 in ("m", "p"):
                    t = mesh.ml.get(f"e_{d1}{s1}{d2}{s2}")
                    if t is None or not t["any_same"]:
                        continue
                    my1 = ng if s1 == "m" else ng + nx_of[d1]
                    my2 = ng if s2 == "m" else ng + nx_of[d2]
                    dn1 = ng + nx_of[d1] if s1 == "m" else ng
                    dn2 = ng + nx_of[d2] if s2 == "m" else ng
                    span = {a1: (my1, my1 + 1), a2: (my2, my2 + 1)}
                    dspan = {a1: (dn1, dn1 + 1), a2: (dn2, dn2 + 1)}
                    if c in active_axes:
                        span[ac] = dspan[ac] = (ng, ng + nx_of[c])
                    donor = tables.gather(box(e, dspan), t["same_gid"])
                    mb = tables.mask(t["same_mask"], 4, dev)
                    box(sum_e, span).add_(torch.where(mb, donor, 0.0))
                    box(cnt, span).add_(
                        torch.where(mb, torch.ones_like(donor), 0.0))
        out[c] = sum_e / cnt
    return out


def emf_correct(mesh, active_axes, e1, e2, e3):
    """SMR EMF correction: on every level-boundary plane, the coarse
    block's edge EMFs become the line averages of the fine donors' edge
    EMFs (reference: src/bvals/flux_correction_fc.cpp).  Returns new
    tensors (e1, e2, e3)."""
    mbi = mesh.mb_indcs
    tables = mesh.tables
    ng = mbi.ng
    nx_of = _nx(mesh)
    es = emf_sync(mesh, active_axes, {"x1": e1, "x2": e2, "x3": e3})
    dev = e1.device
    for d in active_axes:
        axis_d = _AXIS_OF[d] - 1
        nxa = nx_of[d]
        for side in ("m", "p"):
            t = mesh.ml[f"{d}{side}"]
            if not t["any_fine"]:
                continue
            my_idx = ng if side == "m" else ng + nxa
            dn_idx = ng + nxa if side == "m" else ng
            fmask = tables.mask(t["fine_mask"], 4, dev)
            for c in _AXES:
                if c == d:
                    continue
                e = es[c]
                plane = e.narrow(axis_d, dn_idx, 1)
                parts = [tables.gather(plane, col)
                         for col in donor_columns(t)]
                span = {axis_d: (my_idx, my_idx + 1)}
                for a2 in t["t_names"]:
                    ta = _AXIS_OF[a2] - 1
                    nxt = nx_of[a2]
                    if a2 == c:
                        # along the edge direction: line-average pairs
                        # over the donor interior
                        parts = [restrict_cc(p.narrow(ta, ng, nxt), [ta - 4])
                                 for p in parts]
                        parts = [torch.cat([parts[b], parts[b + 1]], dim=ta)
                                 for b in range(0, len(parts), 2)]
                        span[ta] = (ng, ng + nxt)
                    else:
                        # corner-aligned: the even donor corners
                        parts = [box(p, {ta: (ng, ng + nxt + 1, 2)})
                                 for p in parts]
                        parts = [torch.cat([parts[b].narrow(ta, 0, nxt // 2),
                                            parts[b + 1]], dim=ta)
                                 for b in range(0, len(parts), 2)]
                        span[ta] = (ng, ng + nxt + 1)
                _set(box(e, span), fmask, parts[0])

    # ---- edge-diagonal corners: a coarse block touching finer blocks
    # only DIAGONALLY still shares the corner edge with them; give it the
    # same restricted fine EMF so the edge is single-valued mesh-wide
    pairs = [(d1, d2) for i, d1 in enumerate(_AXES) for d2 in _AXES[i + 1:]
             if d1 in active_axes and d2 in active_axes]
    for d1, d2 in pairs:
        for s1 in ("m", "p"):
            for s2 in ("m", "p"):
                t = mesh.ml.get(f"e_{d1}{s1}{d2}{s2}")
                if t is None or not t["any"]:
                    continue
                c = _AXES[t["edge_axis"]]
                e = es[c]
                a1, a2 = _AXIS_OF[d1] - 1, _AXIS_OF[d2] - 1
                ac = _AXIS_OF[c] - 1
                my1 = ng if s1 == "m" else ng + nx_of[d1]
                my2 = ng if s2 == "m" else ng + nx_of[d2]
                dn1 = ng + nx_of[d1] if s1 == "m" else ng
                dn2 = ng + nx_of[d2] if s2 == "m" else ng
                line = e.narrow(a1, dn1, 1).narrow(a2, dn2, 1)
                parts = [tables.gather(line, col) for col in donor_columns(t)]
                span = {a1: (my1, my1 + 1), a2: (my2, my2 + 1)}
                if c in active_axes:
                    nxc = nx_of[c]
                    assembled = torch.cat(
                        [restrict_cc(p.narrow(ac, ng, nxc), [ac - 4])
                         for p in parts], dim=ac)
                    span[ac] = (ng, ng + nxc)
                else:
                    assembled = parts[0]
                _set(box(e, span), tables.mask(t["mask"], 4, dev), assembled)
    return es["x1"], es["x2"], es["x3"]


def fc_fill_corners(mesh, active_axes, bfc) -> None:
    """Direct diagonal-donor fill of the face-field edge/corner ghost
    patches, in place (the face counterpart of
    ``BoundaryValues._fill_corners``; reference: the face edge/corner
    buffers of src/bvals/bvals_fc.cpp).  Copies from same-level diagonal
    donors; restricts (even-face subsample + transverse averages) from
    finer diagonal donors."""
    mbi = mesh.mb_indcs
    tables = mesh.tables
    ng, h = mbi.ng, mbi.ng // 2
    nx_of = _nx(mesh)
    act = list(active_axes)

    def cell_slices(s, n):
        """(ghost, same-donor, fine-donor) cell spans on one side."""
        if s == "m":
            return (0, ng), (n - 2 * ng, n - ng), (n - 3 * ng, n - ng)
        return (n - ng, n), (ng, 2 * ng), (ng, 3 * ng)

    def face_slices(s, nxa):
        """(ghost, same-donor, fine-donor) face spans; the fine donor
        faces are the even (coarse-coincident) ones."""
        if s == "m":
            return (0, ng), (nxa, nxa + ng), (nxa - ng, nxa + ng, 2)
        return ((nxa + ng + 1, nxa + 2 * ng + 1), (ng + 1, 2 * ng + 1),
                (ng + 2, 3 * ng + 1, 2))

    pairs = [(d1, d2) for i, d1 in enumerate(act) for d2 in act[i + 1:]]
    for comp, arr in bfc.items():
        dev = arr.device
        nrm = comp[:2]
        cax = _AXIS_OF[nrm] - 1

        def spans_of(d, a, s):
            return face_slices(s, nx_of[d]) if d == nrm \
                else cell_slices(s, arr.shape[a])

        for d1, d2 in pairs:
            a1, a2 = _AXIS_OF[d1] - 1, _AXIS_OF[d2] - 1
            rest = [a for a in act if a not in (d1, d2)]
            for s1 in ("m", "p"):
                for s2 in ("m", "p"):
                    t = mesh.ml.get(f"e_{d1}{s1}{d2}{s2}")
                    if t is None or not (t["any_same"] or t["any"]):
                        continue
                    my, dn, fn = {}, {}, {}
                    for d, a, s in ((d1, a1, s1), (d2, a2, s2)):
                        my[a], dn[a], fn[a] = spans_of(d, a, s)
                    if t["any_same"]:
                        donor = tables.gather(box(arr, dn), t["same_gid"])
                        _set(box(arr, my),
                             tables.mask(t["same_mask"], 4, dev), donor)
                    if t["any"]:
                        caxes = [a for a in (a1, a2) if a != cax]
                        rrest = None
                        if rest:
                            rrest = _AXIS_OF[rest[0]] - 1
                            if rrest != cax:
                                caxes.append(rrest)
                        src = box(arr, fn)
                        parts = []
                        for col in donor_columns(t):
                            d = tables.gather(src, col)
                            if rrest is not None and rrest == cax:
                                # edge axis is the face axis: even-face
                                # subsample over the guarded span
                                d = box(d, {cax: (
                                    ng - 2 * h, ng + nx_of[nrm] + 2 * h + 1,
                                    2)})
                            parts.append(restrict_cc(d, [a - 4
                                                         for a in caxes]))
                        spans = dict(my)
                        if rrest is not None:
                            assembled = pair_merge(
                                parts, rrest, nx_of[rest[0]] // 2 + h, h)[0]
                            spans[rrest] = (h, arr.shape[rrest] - h)
                        else:
                            assembled = parts[0]
                        _set(box(arr, spans), tables.mask(t["mask"], 4, dev),
                             assembled)
        if len(act) != 3:
            continue
        axs = [_AXIS_OF[d] - 1 for d in _AXES]
        for s1 in ("m", "p"):
            for s2 in ("m", "p"):
                for s3 in ("m", "p"):
                    t = mesh.ml.get(f"v_{s1}{s2}{s3}")
                    if t is None or not (t["any_same"] or t["any_fine"]):
                        continue
                    my, dn, fn = {}, {}, {}
                    for d, a, s in zip(_AXES, axs, (s1, s2, s3)):
                        my[a], dn[a], fn[a] = spans_of(d, a, s)
                    region = box(arr, my)
                    if t["any_same"]:
                        donor = tables.gather(box(arr, dn), t["same_gid"])
                        _set(region, tables.mask(t["same_mask"], 4, dev),
                             donor)
                    if t["any_fine"]:
                        d = restrict_cc(
                            tables.gather(box(arr, fn), t["fine_gid"]),
                            [a - 4 for a in axs if a != cax])
                        _set(region, tables.mask(t["fine_mask"], 4, dev), d)
