"""Adaptive mesh refinement: the refinement criteria, the tree update and
the remap of the evolved state onto the new tree.

Counterpart of ``athenak_tpu/amr.py`` (reference:
src/mesh/mesh_refinement.cpp:142-610, src/mesh/refinement_criteria.cpp).

  * The criteria are per-block reductions over each block's interior on
    the device; only the [nmb] flag vector comes back to the host.
  * The tree update (``update_tree``: the refine queue with the 2:1
    ripple, the derefinement of complete families, the z-order) is the
    JAX package's host code, copied, so the two packages number the new
    leaves alike.
  * The remap is vectorised over the blocks of the new tree: each takes
    the same-gid copy, the min-mod prolongation of its old parent's
    octant (with the Toth & Roe 2002 divergence-free interior faces,
    ``fc_internal``) or the restriction of its old children, selected
    per block.  No per-block host loop, no read-back of field data.
  * After a tree change ``AMR.rebuild`` makes the mesh, boundaries and
    physics anew (so every kernel gate is decided again on the new tree),
    drops the driver's cycle, re-points the outputs, and refills the
    ghosts twice around the face repair, as the reference's
    InitBoundaryValuesAndPrimitives + RepairAMRFC + second fill do.

The JAX package's fixed-capacity block pool (``amr_pool.py``: padded
tables that spare XLA a recompile at each tree update) and its
device-mesh branch are not ported; the pool's choice of route is kept
(``mesh.py``).
"""

from __future__ import annotations

import time as _time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from .comm import use_comm
from .indices import IDN
from .refinement import prolong_cc, restrict_cc

# mesh axis name -> cell axis in [nmb, nvar, n3, n2, n1]
_AXIS5 = {"x1": 4, "x2": 3, "x3": 2}
_BIT = {"x1": 0, "x2": 1, "x3": 2}
_FLT_MAX = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# refinement criteria (device)
# ---------------------------------------------------------------------------
class Criterion:
    """One parsed <amr_criterionN> block (reference:
    refinement_criteria.cpp:33-65)."""

    def __init__(self, pin, block: str) -> None:
        self.method = pin.get_string(block, "method")
        if self.method not in ("min_max", "slope", "second_deriv",
                               "location", "user"):
            raise ValueError(f"<{block}> method={self.method} unknown")
        self.variable = None
        if self.method not in ("location", "user"):
            self.variable = pin.get_string(block, "variable")
        self.value_min = pin.get_or_add_real(block, "value_min", -_FLT_MAX)
        self.value_max = pin.get_or_add_real(block, "value_max", _FLT_MAX)
        self.loc_x1 = pin.get_or_add_real(block, "location_x1", 0.0)
        self.loc_x2 = pin.get_or_add_real(block, "location_x2", 0.0)
        self.loc_x3 = pin.get_or_add_real(block, "location_x3", 0.0)
        self.loc_rad = pin.get_or_add_real(block, "location_rad", 0.0)


def _crit_data(crit: Criterion, state, phys):
    """The [nmb, n3, n2, n1] tensor a criterion reduces over (reference:
    SetRefinementData, refinement_criteria.cpp:120-175).  A state on
    kernel A's route carries no primitives; they are made for it."""
    v = crit.variable
    if v in ("hydro_u_d", "mhd_u_d"):
        return state["u"][:, IDN]
    if v in ("hydro_w_d", "mhd_w_d"):
        if "w" not in state:
            state = phys.unpack_state(state)
        return state["w"][:, IDN]
    if v == "rad_coord_e":
        # the coordinate-frame energy density R^00 (radiation AMR)
        return phys.coord_energy_density(state)
    raise ValueError(f"unknown refinement variable '{v}'")


def _active(mbi):
    """(tensor axis, interior width) of every axis of a [nmb, n3, n2, n1]
    field that has ghosts."""
    return [(ax, nx) for ax, nx in ((3, mbi.nx1), (2, mbi.nx2),
                                    (1, mbi.nx3)) if nx > 1]


def block_interior(q, mbi):
    """The interior cells of a [nmb, n3, n2, n1] field."""
    for ax, nx in _active(mbi):
        q = q.narrow(ax, mbi.ng, nx)
    return q


def centred_diff_sq(q, mbi):
    """The sum over the active axes of (q[i+1] - q[i-1])^2 of a
    [nmb, n3, n2, n1] field (the wrapped ends land in the ghosts)."""
    d2 = 0.0
    for ax, _ in _active(mbi):
        d2 = d2 + (torch.roll(q, -1, dims=ax)
                   - torch.roll(q, 1, dims=ax)) ** 2
    return d2


def make_flag_fn(criteria: List[Criterion], phys, mesh,
                 z4c_amr=None) -> Callable:
    """flags(state) -> int32 [nmb] on the state's device: +1 refine, -1
    derefinable, 0 keep (reference: CheckMinMax/CheckSlope/
    CheckSecondDeriv kernels)."""
    mbi = mesh.mb_indcs
    act = _active(mbi)
    red = (1, 2, 3)

    def interior(q):
        return block_interior(q, mbi)

    def mark(flag, q, crit):
        qmax = torch.amax(interior(q), dim=red)
        flag = torch.where(qmax > crit.value_max, 1, flag)
        return torch.where((qmax < crit.value_max) & (flag == 0), -1, flag)

    def flags(state):
        u = state["u"]
        flag = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
        if z4c_amr is not None and z4c_amr.method in ("chi", "dchi"):
            flag = z4c_amr.device_flags(u, mesh)
        for crit in criteria:
            if crit.method in ("location", "user"):
                continue  # host-side / hook
            q = _crit_data(crit, state, phys)
            if crit.method == "min_max":
                if crit.value_max < _FLT_MAX:
                    flag = mark(flag, q, crit)
                if crit.value_min > -_FLT_MAX:
                    qmin = torch.amin(interior(q), dim=red)
                    flag = torch.where(qmin < crit.value_min, 1, flag)
                    flag = torch.where(
                        (qmin > crit.value_min) & (flag == 0), -1, flag)
            elif crit.method == "slope":
                # max |dq|/q with centred differences (reference:
                # CheckSlope, refinement_criteria.cpp:240-280)
                flag = mark(flag, 0.5 * torch.sqrt(centred_diff_sq(q, mbi))
                            / q, crit)
            elif crit.method == "second_deriv":
                d2q = 0.0
                for ax, _ in act:
                    d2q = d2q + (torch.roll(q, -1, dims=ax) - 2.0 * q
                                 + torch.roll(q, 1, dims=ax))
                flag = mark(flag, torch.abs(d2q) / q, crit)
        return flag.to(torch.int32)

    return flags


def location_flags(crit: Criterion, mesh) -> np.ndarray:
    """Host check: +1 for blocks overlapping the cube of half-width rad
    around (x1, x2, x3) (reference: CheckLocation,
    refinement_criteria.cpp:345-390)."""
    out = np.zeros(mesh.nmb_total, dtype=np.int32)
    sz = mesh.mb_size

    def overlaps(lo, hi, c, r):
        return ((lo < c + r) & (lo > c - r)) | ((hi < c + r) & (hi > c - r)) \
            | ((hi > c + r) & (lo < c - r))

    hit = overlaps(sz["x1min"], sz["x1max"], crit.loc_x1, crit.loc_rad)
    if mesh.multi_d:
        hit &= overlaps(sz["x2min"], sz["x2max"], crit.loc_x2, crit.loc_rad)
    if mesh.three_d:
        hit &= overlaps(sz["x3min"], sz["x3max"], crit.loc_x3, crit.loc_rad)
    out[hit] = 1
    return out


# ---------------------------------------------------------------------------
# tree update (host)
# ---------------------------------------------------------------------------
def _zorder(leaves, nrbx, active):
    max_lev = max((k[0] for k in leaves), default=0)
    nb = max(nrbx) << max_lev
    nbits = max(1, (nb - 1).bit_length())

    def zkey(key):
        lev, l1, l2, l3 = key
        s = max_lev - lev
        u1 = l1 << s
        u2 = (l2 << s) if active[1] else l2
        u3 = (l3 << s) if active[2] else l3
        out = 0
        for i in range(nbits):
            out |= ((u1 >> i) & 1) << (3 * i)
            out |= ((u2 >> i) & 1) << (3 * i + 1)
            out |= ((u3 >> i) & 1) << (3 * i + 2)
        return out

    return sorted(leaves, key=zkey)


def update_tree(leaves: List[Tuple[int, int, int, int]], flags: np.ndarray,
                nrbx, active, wraps, max_level: int):
    """Apply refine/derefine flags to the leaf list (reference:
    UpdateMeshBlockTree, mesh_refinement.cpp:274-415).

    Returns (new_leaves, prov) where prov[i] describes new leaf i:
      ("same", old_gid) | ("refined", old_parent_gid, (o1, o2, o3)) |
      ("derefined", [old_child_gids in x1-fast quadrant order]).
    Returns (None, None) when the tree is unchanged.
    """
    # keys are (lev, l1, l2, l3)
    old_gid = {}
    for gid, (l1, l2, l3, lev) in enumerate(leaves):
        old_gid[(lev, l1, l2, l3)] = gid
    S = set(old_gid)
    flag = {k: int(flags[g]) for k, g in old_gid.items()}

    def extent(lev):
        return (nrbx[0] << lev,
                (nrbx[1] << lev) if active[1] else nrbx[1],
                (nrbx[2] << lev) if active[2] else nrbx[2])

    def covering(lev, l1, l2, l3):
        for up in range(lev, -1, -1):
            s = lev - up
            key = (up, l1 >> s,
                   (l2 >> s) if active[1] else l2,
                   (l3 >> s) if active[2] else l3)
            if key in S:
                return key
        return None

    def neighbors(key):
        """26-neighbourhood cells of a leaf at its own level, with the
        periodic wrap; out-of-domain non-periodic cells skipped."""
        lev, l1, l2, l3 = key
        n = extent(lev)
        for d3 in ((-1, 0, 1) if active[2] else (0,)):
            for d2 in ((-1, 0, 1) if active[1] else (0,)):
                for d1 in (-1, 0, 1):
                    if d1 == d2 == d3 == 0:
                        continue
                    t = [l1 + d1, l2 + d2, l3 + d3]
                    ok = True
                    for ax, nm in ((0, "x1"), (1, "x2"), (2, "x3")):
                        if not (0 <= t[ax] < n[ax]):
                            if wraps[nm]:
                                t[ax] %= n[ax]
                            else:
                                ok = False
                    if ok:
                        yield (lev, t[0], t[1], t[2])

    parent_of: Dict[tuple, tuple] = {}   # new child key -> old parent key

    def split(key):
        lev, l1, l2, l3 = key
        S.discard(key)
        for o3 in range(2 if active[2] else 1):
            for o2 in range(2 if active[1] else 1):
                for o1 in range(2):
                    ck = (lev + 1, 2 * l1 + o1,
                          (2 * l2 + o2) if active[1] else l2,
                          (2 * l3 + o3) if active[2] else l3)
                    S.add(ck)
                    parent_of[ck] = key

    # ---- step 1: refinement + 2:1 ripple
    queue = [k for k in S if flag.get(k, 0) > 0 and k[0] < max_level]
    while queue:
        k = queue.pop()
        if k not in S:
            continue
        split(k)
        # any adjacent coarser leaf must now be at least level k.lev
        for nb in neighbors(k):
            cov = covering(*nb)
            if cov is not None and cov[0] < k[0]:
                queue.append(cov)

    nnew = len(parent_of)

    # ---- step 2: derefinement of complete families
    # group -1 leaves (not created this event) by parent key
    fams: Dict[tuple, list] = {}
    for k in S:
        if k in parent_of or flag.get(k, 0) >= 0 or k[0] == 0:
            continue
        lev, l1, l2, l3 = k
        pk = (lev - 1, l1 >> 1,
              (l2 >> 1) if active[1] else l2,
              (l3 >> 1) if active[2] else l3)
        fams.setdefault(pk, []).append(k)

    nq = 2 * (2 if active[1] else 1) * (2 if active[2] else 1)
    derefined: Dict[tuple, list] = {}     # parent key -> child keys (ordered)
    for pk, kids in fams.items():
        if len(kids) != nq:
            continue
        # 2:1 after coarsening: no leaf strictly finer than pk.lev+1 may
        # touch pk's neighbourhood
        plev = pk[0]
        ok = True
        for nb in neighbors(pk):
            nlev, t1, t2, t3 = nb
            for k2 in S:
                if k2[0] <= plev + 1:
                    continue
                s = k2[0] - plev
                if (k2[1] >> s) == t1 \
                        and ((k2[2] >> s) if active[1] else k2[2]) == t2 \
                        and ((k2[3] >> s) if active[2] else k2[3]) == t3:
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            continue
        # quadrant order: x1 fastest, then x2, then x3
        ordered = []
        for o3 in range(2 if active[2] else 1):
            for o2 in range(2 if active[1] else 1):
                for o1 in range(2):
                    ordered.append((plev + 1, 2 * pk[1] + o1,
                                    (2 * pk[2] + o2) if active[1] else pk[2],
                                    (2 * pk[3] + o3) if active[2]
                                    else pk[3]))
        for ck in ordered:
            S.discard(ck)
        S.add(pk)
        derefined[pk] = ordered

    if nnew == 0 and not derefined:
        return None, None

    new_leaves = _zorder(S, nrbx, active)
    prov = []
    for k in new_leaves:
        if k in old_gid:
            prov.append(("same", old_gid[k]))
        elif k in parent_of:
            pk = parent_of[k]
            o1 = k[1] & 1
            o2 = (k[2] & 1) if active[1] else 0
            o3 = (k[3] & 1) if active[2] else 0
            prov.append(("refined", old_gid[pk], (o1, o2, o3)))
        elif k in derefined:
            prov.append(("derefined",
                         [old_gid[ck] for ck in derefined[k]]))
        else:  # pragma: no cover
            raise RuntimeError(f"leaf {k} has no provenance")
    return [(l1, l2, l3, lev) for (lev, l1, l2, l3) in new_leaves], prov


# ---------------------------------------------------------------------------
# data remap (device, vectorised over the blocks)
# ---------------------------------------------------------------------------
def _prov_tables(prov) -> Dict[str, np.ndarray]:
    nmb_new = len(prov)
    nqmax = max((len(p[1]) for p in prov if p[0] == "derefined"),
                default=1)
    mode = np.zeros(nmb_new, dtype=np.int32)
    src = np.zeros(nmb_new, dtype=np.int32)
    octant = np.zeros((nmb_new, 3), dtype=np.int32)
    child = np.zeros((nmb_new, nqmax), dtype=np.int32)
    for i, p in enumerate(prov):
        if p[0] == "same":
            src[i] = p[1]
        elif p[0] == "refined":
            mode[i] = 1
            src[i] = p[1]
            octant[i] = p[2]
        else:
            mode[i] = 2
            child[i] = p[1]
    return {"mode": mode, "src": src, "octant": octant, "child": child}


def _rows(arr, idx):
    """arr[idx] along the block axis (a copy)."""
    return torch.index_select(
        arr, 0, torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                device=arr.device))


def _bmask(sel, nd: int, device):
    """A per-block boolean numpy vector as a [nmb, 1, ...] tensor."""
    return torch.as_tensor(np.asarray(sel, dtype=bool),
                           device=device).reshape((-1,) + (1,) * (nd - 1))


def _half_window(x, axis: int, s0: int, half: int, ln: int, bit):
    """Per block, the window [s0, s0 + ln) or [s0 + half, s0 + half + ln)
    of ``x`` along ``axis`` as the block's octant bit says."""
    return torch.where(_bmask(bit, x.dim(), x.device),
                       x.narrow(axis, s0 + half, ln), x.narrow(axis, s0, ln))


def _pad_edge(x, axes, ng: int):
    """Pad each of ``axes`` by ``ng`` copies of its edge values (numpy's
    mode="edge"); the ghost rings are refilled by the exchange."""
    for a in axes:
        n = x.shape[a]
        lo = x.narrow(a, 0, 1).expand(
            *[ng if d == a else -1 for d in range(x.dim())])
        hi = x.narrow(a, n - 1, 1).expand(
            *[ng if d == a else -1 for d in range(x.dim())])
        x = torch.cat([lo, x, hi], dim=a)
    return x


def remap_cc(arr, tbl, mbi, act_axes):
    """Remap a cell-centred tensor [nmb_old, C, n3, n2, n1] onto the new
    tree (reference: RefineCC + DerefineCCSameRank,
    mesh_refinement.cpp:560-740)."""
    ng = mbi.ng
    h = ng // 2
    nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
    nc_of = {"x1": mbi.ncells1, "x2": mbi.ncells2, "x3": mbi.ncells3}
    mode = tbl["mode"]
    nd = arr.dim()
    dev = arr.device
    cand = _rows(arr, tbl["src"])

    # ---- refined: min-mod prolongation of the parent octant
    if (mode == 1).any():
        win = cand  # refined slots hold the parent gid
        for ax in act_axes:
            win = _half_window(win, _AXIS5[ax], ng - h - 1, nx_of[ax] // 2,
                               nc_of[ax] // 2 + 2,
                               tbl["octant"][:, _BIT[ax]])
        pro = prolong_cc(win, [_AXIS5[ax] - 5 for ax in act_axes])
        cand = torch.where(_bmask(mode == 1, nd, dev), pro, cand)

    # ---- derefined: restrict + quadrant-assemble the old children
    if (mode == 2).any():
        caxes = [_AXIS5[ax] - 5 for ax in act_axes]
        parts = [restrict_cc(_rows(arr, tbl["child"][:, q]), caxes)
                 for q in range(tbl["child"].shape[1])]
        for ax in act_axes:
            half = nx_of[ax] // 2
            parts = [torch.cat([parts[b].narrow(_AXIS5[ax], h, half),
                                parts[b + 1].narrow(_AXIS5[ax], h, half)],
                               dim=_AXIS5[ax])
                     for b in range(0, len(parts), 2)]
        asm = _pad_edge(parts[0], [_AXIS5[ax] for ax in act_axes], ng)
        cand = torch.where(_bmask(mode == 2, nd, dev), asm, cand)
    return cand


# ---- face-centred ---------------------------------------------------------
_FC_NORMAL = {"x1f": "x1", "x2f": "x2", "x3f": "x3"}
# array axis of each mesh axis in a 4-D [nmb, n3, n2, n1(+1)] face array
_AXIS4 = {"x1": 3, "x2": 2, "x3": 1}


def remap_fc(bfc, tbl, mbi, act_axes):
    """Remap staggered face fields onto the new tree: area-average
    restriction on coarse faces, min-mod shared-face prolongation on
    refined blocks, whose odd interior faces ``fc_internal`` fills next
    (reference: RefineFC/DerefineFCSameRank + ProlongFCShared*,
    src/mesh/prolongation.hpp:62-240)."""
    ng = mbi.ng
    h = ng // 2
    nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
    nc_of = {"x1": mbi.ncells1, "x2": mbi.ncells2, "x3": mbi.ncells3}
    mode = tbl["mode"]
    out = {}
    for comp, arr in bfc.items():
        nrm = _FC_NORMAL[comp]
        na = _AXIS4[nrm]
        nd = arr.dim()
        dev = arr.device
        t_axes = [ax for ax in act_axes if ax != nrm]
        nx = nx_of[nrm]
        normal_active = nrm in act_axes
        cand = _rows(arr, tbl["src"])

        if (mode == 1).any():
            # shared planes: the parent faces of the octant, prolonged in
            # the transverse directions (ProlongFCShared*)
            win = cand
            if normal_active:
                # the active coarse faces of the octant (nx/2 + 1 planes)
                win = _half_window(win, na, ng, nx // 2, nx // 2 + 1,
                                   tbl["octant"][:, _BIT[nrm]])
            for ax in t_axes:
                win = _half_window(win, _AXIS4[ax], ng - h - 1,
                                   nx_of[ax] // 2, nc_of[ax] // 2 + 2,
                                   tbl["octant"][:, _BIT[ax]])
            shared = prolong_cc(win, [_AXIS4[ax] - 4 for ax in t_axes]) \
                if t_axes else win
            # the shared planes go onto the even fine faces; the odd
            # faces come from the internal Toth & Roe pass afterwards
            if normal_active:
                pro = torch.zeros_like(cand)
                pro[_slc4(na, slice(ng, ng + nx + 1, 2))] = shared
            else:
                pro = shared
            cand = torch.where(_bmask(mode == 1, nd, dev), pro, cand)

        if (mode == 2).any():
            ct_axes = [_AXIS4[ax] - 4 for ax in t_axes]
            parts = []
            for q in range(tbl["child"].shape[1]):
                ch = _rows(arr, tbl["child"][:, q])
                if normal_active:
                    # the even (coarse-coincident) active faces
                    ch = ch[_slc4(na, slice(ng, ng + nx + 1, 2))]
                parts.append(restrict_cc(ch, ct_axes) if ct_axes else ch)
            # assemble the quadrants, x1 fastest (update_tree's order)
            for ax in act_axes:
                if ax == nrm:
                    # along the normal: child 0's faces [0, nx/2), child
                    # 1's faces [nx/2, nx]
                    parts = [torch.cat([parts[b].narrow(na, 0, nx // 2),
                                        parts[b + 1]], dim=na)
                             for b in range(0, len(parts), 2)]
                else:
                    a = _AXIS4[ax]
                    half = nx_of[ax] // 2
                    parts = [torch.cat([parts[b].narrow(a, h, half),
                                        parts[b + 1].narrow(a, h, half)],
                                       dim=a)
                             for b in range(0, len(parts), 2)]
            asm = _pad_edge(parts[0], [_AXIS4[ax] for ax in act_axes], ng)
            cand = torch.where(_bmask(mode == 2, nd, dev), asm, cand)
        out[comp] = cand
    return out


def _slc4(axis, s):
    idx = [slice(None)] * 4
    idx[axis] = s
    return tuple(idx)


def fc_internal(bfc, mbi, act_axes, mask):
    """Recompute the fine faces interior to each coarse cell from the
    (even) shared planes with the divergence-preserving scheme of Toth &
    Roe, JCP 180, 736 (2002), on the ``mask``-flagged blocks (reference:
    ProlongFCInternal, src/mesh/prolongation.hpp:170-240; also the
    post-exchange RepairAMRFC pass).  Returns a new dict; the arrays it
    changes are new tensors, read from the given ones."""
    ng = mbi.ng
    nx1, nx2, nx3 = mbi.nx1, mbi.nx2, mbi.nx3
    x1f, x2f = bfc["x1f"], bfc["x2f"]
    x3f = bfc.get("x3f")
    dev = x1f.device
    three_d = "x3" in act_axes
    two_d = ("x2" in act_axes) and not three_d
    mb = _bmask(mask, 4, dev)

    def lt(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    if not ("x2" in act_axes or three_d):
        # 1-D: the internal x1-faces average the flanking shared faces
        ev = x1f[..., ng:ng + nx1 + 1:2]
        internal = 0.5 * (ev[..., :-1] + ev[..., 1:])
        new = x1f.clone()
        new[..., ng + 1:ng + nx1:2] = torch.where(
            mb, internal, x1f[..., ng + 1:ng + nx1:2])
        return dict(bfc, x1f=new)

    if two_d:
        # coarse cell (jc, ic) has its fine origin at (ng+2jc, ng+2ic)
        fi0 = lt(np.arange(ng, ng + nx1, 2))
        fj0 = lt(np.arange(ng, ng + nx2, 2))
        x1_l = x1f[..., fi0][:, :, fj0, :], x1f[..., fi0][:, :, fj0 + 1, :]
        x1_r = x1f[..., fi0 + 2][:, :, fj0, :], \
            x1f[..., fi0 + 2][:, :, fj0 + 1, :]
        x2_b = x2f[:, :, fj0, :]
        x2_t = x2f[:, :, fj0 + 2, :]
        tmp1 = 0.25 * (x2_t[..., fi0 + 1] - x2_b[..., fi0 + 1]
                       - x2_t[..., fi0] + x2_b[..., fi0])
        tmp2 = 0.25 * (x1_l[0] - x1_r[0] - x1_l[1] + x1_r[1])
        # x1f internal (odd columns), both fine rows
        v_r0 = 0.5 * (x1_l[0] + x1_r[0]) + tmp1
        v_r1 = 0.5 * (x1_l[1] + x1_r[1]) + tmp1
        cur = x1f[..., fi0 + 1]
        upd = cur.clone()
        upd[:, :, fj0, :] = v_r0
        upd[:, :, fj0 + 1, :] = v_r1
        new1 = x1f.clone()
        new1[..., fi0 + 1] = torch.where(mb, upd, cur)
        # x2f internal (odd rows), both fine columns
        w_c0 = 0.5 * (x2_b[..., fi0] + x2_t[..., fi0]) + tmp2
        w_c1 = 0.5 * (x2_b[..., fi0 + 1] + x2_t[..., fi0 + 1]) + tmp2
        cur = x2f[:, :, fj0 + 1, :]
        upd = cur.clone()
        upd[..., fi0] = w_c0
        upd[..., fi0 + 1] = w_c1
        new2 = x2f.clone()
        new2[:, :, fj0 + 1, :] = torch.where(mb, upd, cur)
        return dict(bfc, x1f=new1, x2f=new2)

    # ---- 3-D (reference: ProlongFCInternal three_d branch)
    fi0 = lt(np.arange(ng, ng + nx1, 2))
    fj0 = lt(np.arange(ng, ng + nx2, 2))
    fk0 = lt(np.arange(ng, ng + nx3, 2))

    def g(arr, r, c, off):   # arr at (fk0+r, fj0+c, fi0+off)
        return arr[:, fk0 + r][:, :, fj0 + c][..., fi0 + off]

    def g1(r, c, off):
        return g(x1f, r, c, off)

    def g2(r, c, off):
        return g(x2f, r, c, off)

    def g3(r, c, off):
        return g(x3f, r, c, off)

    Uxx = Vyy = Wzz = Uxyz = Vxyz = Wxyz = 0.0
    for jj in (0, 1):
        jsgn = 2 * jj - 1
        fjj, fjp = jj, 2 * jj
        for ii in (0, 1):
            isgn = 2 * ii - 1
            fii, fip = ii, 2 * ii
            Uxx = Uxx + isgn * (jsgn * (g2(0, fjp, fii) + g2(1, fjp, fii))
                                + (g3(2, fjj, fii) - g3(0, fjj, fii)))
            Vyy = Vyy + jsgn * ((g3(2, fjj, fii) - g3(0, fjj, fii))
                                + isgn * (g1(0, fjj, fip)
                                          + g1(1, fjj, fip)))
            Wzz = Wzz + isgn * (g1(1, fjj, fip) - g1(0, fjj, fip)) \
                + jsgn * (g2(1, fjp, fii) - g2(0, fjp, fii))
            Uxyz = Uxyz + isgn * jsgn * (g1(1, fjj, fip) - g1(0, fjj, fip))
            Vxyz = Vxyz + isgn * jsgn * (g2(1, fjp, fii) - g2(0, fjp, fii))
            Wxyz = Wxyz + isgn * jsgn * (g3(2, fjj, fii) - g3(0, fjj, fii))
    Uxx, Vyy, Wzz = 0.125 * Uxx, 0.125 * Vyy, 0.125 * Wzz
    Uxyz, Vxyz, Wxyz = 0.0625 * Uxyz, 0.0625 * Vxyz, 0.0625 * Wxyz

    nmb = lt(np.arange(x1f.shape[0]))

    def setmask(arr, k_off, j_off, i_off, vals):
        """Masked scatter of per-coarse-cell values at fine offsets."""
        ix = (nmb[:, None, None, None], (fk0 + k_off)[None, :, None, None],
              (fj0 + j_off)[None, None, :, None],
              (fi0 + i_off)[None, None, None, :])
        arr[ix] = torch.where(mb, vals, arr[ix])

    new1 = x1f.clone()
    for kk in (0, 1):
        for jj in (0, 1):
            sK = 1 if kk else -1
            sJ = 1 if jj else -1
            setmask(new1, kk, jj, 1, 0.5 * (g1(kk, jj, 0) + g1(kk, jj, 2))
                    + Uxx + sK * Vxyz + sJ * Wxyz)
    new2 = x2f.clone()
    for kk in (0, 1):
        for ii in (0, 1):
            sK = 1 if kk else -1
            sI = 1 if ii else -1
            setmask(new2, kk, 1, ii, 0.5 * (g2(kk, 0, ii) + g2(kk, 2, ii))
                    + Vyy + sK * Uxyz + sI * Wxyz)
    new3 = x3f.clone()
    for jj in (0, 1):
        for ii in (0, 1):
            sJ = 1 if jj else -1
            sI = 1 if ii else -1
            setmask(new3, 1, jj, ii, 0.5 * (g3(0, jj, ii) + g3(2, jj, ii))
                    + Wzz + sJ * Uxyz + sI * Vxyz)
    return dict(bfc, x1f=new1, x2f=new2, x3f=new3)


def _act_axes(mbi):
    return ["x1"] + (["x2"] if mbi.nx2 > 1 else []) \
        + (["x3"] if mbi.nx3 > 1 else [])


# ---------------------------------------------------------------------------
# the AMR orchestrator
# ---------------------------------------------------------------------------
class AMR:
    """Adaptive refinement: criteria -> tree update -> rebuild -> remap
    (reference: MeshRefinement::AdaptiveMeshRefinement,
    mesh_refinement.cpp:142-195).  ``updates`` holds a record of every
    tree update: its cycle, time and new leaves, the block count, and the
    host milliseconds of its four parts (the device work of the flags and
    the remap synchronised into them)."""

    def __init__(self, pin, mesh) -> None:
        self.pin = pin
        self.ncycle_check = int(pin.get_or_add_real(
            "mesh_refinement", "ncycle_check", 1))
        self.refinement_interval = int(pin.get_or_add_real(
            "mesh_refinement", "refinement_interval", 5))
        self.max_nmb = pin.get_or_add_integer(
            "mesh_refinement", "max_nmb_per_rank", 2 ** 16)
        self.criteria = [Criterion(pin, b) for b in pin.blocks
                         if b.startswith("amr_criterion")]
        # every adaptive Z4c deck gets a <z4c_amr> handler (default
        # method = trivial + radius shells), as the reference constructs
        # Z4c_AMR unconditionally (z4c.cpp)
        self.z4c_amr = None
        if "z4c" in pin.blocks or "z4c_amr" in pin.blocks:
            from .z4c.z4c_amr import Z4cAMR
            self.z4c_amr = Z4cAMR(pin)
        if not self.criteria and self.z4c_amr is None:
            raise ValueError("refinement=adaptive requires at least one "
                             "<amr_criterion> block")
        # pgen-enrolled hook: fn(state, mesh) -> int flags of the state's
        # blocks, [nmb] or, on one rank's blocks of a group, this rank's
        # [L] rows, all-gathered as the criteria's are (reference: pgen
        # user_ref_func, src/pgen/pgen.hpp)
        self.user_ref_func = None
        self.ncyc_since_ref = np.zeros(mesh.nmb_total, dtype=np.int64)
        self.nmb_created = 0
        self.nmb_deleted = 0
        self.updates: List[Dict] = []
        self._flag_fn = None

    # ------------------------------------------------------------------
    def check_flags(self, state, mesh, phys, comm=None) -> np.ndarray:
        """The flags [nmb] in gid order.  On one rank's blocks of a group
        (``comm``) each rank flags its own and the flags are all-gathered,
        so every rank updates the same tree (JAX amr.py:757)."""
        if self._flag_fn is None:
            self._flag_fn = make_flag_fn(self.criteria, phys, mesh,
                                         z4c_amr=self.z4c_amr)

        def whole(f):
            return f if comm is None else comm.whole_blocks(f)

        with use_comm(comm):
            f = self._flag_fn(state)
        flags = whole(f).cpu().numpy()[:mesh.nmb_total].copy()
        for crit in self.criteria:
            if crit.method == "location":
                flags = np.where(location_flags(crit, mesh) > 0, 1, flags)
            elif crit.method == "user":
                if self.user_ref_func is None:
                    raise ValueError("<amr_criterion> method=user needs an "
                                     "enrolled user_ref_func")
                with use_comm(comm):
                    uf = torch.as_tensor(self.user_ref_func(state, mesh))
                uf = whole(uf).cpu().numpy()[:mesh.nmb_total]
                flags = np.where(uf != 0, uf, flags)
        if self.z4c_amr is not None:
            flags = self.z4c_amr.host_flags(flags, state, mesh, phys)
        # vetoes (reference: CheckForRefinement tail,
        # mesh_refinement.cpp:244-256)
        lev = mesh.mb_lev
        flags[(lev >= mesh.max_allowed_level) & (flags > 0)] = 0
        flags[(lev == 0) & (flags < 0)] = 0
        flags[self.ncyc_since_ref < self.refinement_interval] = 0
        return flags

    # ------------------------------------------------------------------
    def step(self, driver, state, outputs=()):
        """One AMR pass after a cycle.  Returns (state, changed).  Under
        ranks it is also the blocks' redistribution (JAX amr.py:916-975;
        reference: RedistAndRefineMeshBlocks): every rank gathers the
        whole state, remaps it onto the new tree and keeps its rows of
        the new tree's cost-weighted layout; the routes are the new
        mesh's."""
        mesh = driver.mesh
        self.ncyc_since_ref += 1
        if mesh.ncycle % self.ncycle_check != 0:
            return state, False
        t0 = _time.perf_counter()
        flags = self.check_flags(state, mesh, driver.phys, comm=driver.comm)
        t1 = _time.perf_counter()
        wraps = {ax: mesh.mesh_bcs[f"i{ax}"] in ("periodic",
                                                 "shear_periodic")
                 for ax in ("x1", "x2", "x3")}
        leaves = [(int(l[0]), int(l[1]), int(l[2]), int(v)) for l, v in
                  zip(mesh.lloc_eachmb, mesh.mb_lev)]
        new_leaves, prov = update_tree(
            leaves, flags, mesh.tree_nrbx, mesh.tree_active, wraps,
            mesh.max_allowed_level)
        t2 = _time.perf_counter()
        if prov is None:
            return state, False
        if len(new_leaves) > self.max_nmb:
            raise RuntimeError(
                f"AMR grew to {len(new_leaves)} blocks > "
                f"<mesh_refinement>/max_nmb_per_rank={self.max_nmb}")
        if driver.comm is not None:
            state = driver.comm.collect(state, everywhere=True)
        state = self.rebuild(driver, state, new_leaves, prov, outputs)
        if driver.comm is not None:
            state = driver.shard(state)
        n_same = sum(1 for p in prov if p[0] == "same")
        self.nmb_created += len(prov) - n_same
        self.nmb_deleted += len(leaves) - n_same
        self.updates[-1].update(check_flags=1e3 * (t1 - t0),
                                update_tree=1e3 * (t2 - t1))
        return state, True

    # ------------------------------------------------------------------
    def rebuild(self, driver, state, new_leaves, prov, outputs=()):
        """Make mesh, boundaries and physics on the new tree and remap the
        evolved state onto it (reference: RedistAndRefineMeshBlocks,
        mesh_refinement.cpp:427-560)."""
        from .bvals import BoundaryValues
        from .main import make_physics
        from .mesh import Mesh

        t0 = _time.perf_counter()
        old_mesh = driver.mesh
        old_phys = driver.phys
        mesh = Mesh(self.pin, leaves=new_leaves)
        mesh.time = old_mesh.time
        mesh.dt = old_mesh.dt
        mesh.dtold = old_mesh.dtold
        mesh.ncycle = old_mesh.ncycle
        bvals = BoundaryValues(mesh)
        phys = make_physics(self.pin, mesh, bvals, old_phys.device,
                            old_phys.dtype)
        # carry the problem generator's hooks across the rebuild (the JAX
        # amr.py:845-848, 993-996)
        bvals.user_bc_func = old_phys.bvals.user_bc_func
        bvals.inflow_state = old_phys.bvals.inflow_state
        if hasattr(old_phys, "srcterms_func"):
            phys.srcterms_func = old_phys.srcterms_func
            # a hook that reads the cell coordinates moves to the new tree
            rebind = getattr(phys.srcterms_func, "rebind", None)
            if rebind is not None:
                rebind(mesh)
        # the user refinement function as `Driver` enrolled it, and a
        # prescribed spacetime rebound to the new tree's cells (the JAX
        # rebuild carries neither, ROADMAP F26)
        if getattr(old_phys, "user_refine_func", None) is not None:
            phys.user_refine_func = old_phys.user_refine_func
        if hasattr(phys, "adopt_spacetime"):
            phys.adopt_spacetime(old_phys)
        t1 = _time.perf_counter()

        mbi = mesh.mb_indcs
        act_axes = _act_axes(mbi)
        tbl = _prov_tables(prov)
        refined = tbl["mode"] == 1
        # the state's other entries ride along as they are.  A multigrid
        # run's potential ``phi`` is the first guess of the first solve on
        # the new tree, which reads the old tree's potential at the new
        # gids (clamped), as the JAX package's rebuild and warm start do:
        # that gather is made here, so that ``phi`` has the new tree's
        # blocks and is redistributed with the state under ranks
        new_state = dict(state)
        if "phi" in state:
            old = state["phi"]
            new_state["phi"] = old[torch.clamp(torch.arange(
                mesh.nmb_total, device=old.device), max=old.shape[0] - 1)]
        for key in ("u", "w", "z", "i0"):
            if key in state:
                new_state[key] = remap_cc(state[key], tbl, mbi, act_axes)
        if "T" in state:
            new_state["T"] = remap_cc(state["T"][:, None], tbl, mbi,
                                      act_axes)[:, 0]
        if "bfc" in state:
            bfc = remap_fc(state["bfc"], tbl, mbi, act_axes)
            new_state["bfc"] = fc_internal(bfc, mbi, act_axes, refined)

        # swap the objects into the driver and the outputs (which take
        # the mesh at every write)
        driver.mesh = mesh
        driver.phys = phys
        driver._cycle_fn = None
        # the criteria's closure holds the old physics
        self._flag_fn = None
        for out in outputs:
            out.phys = phys

        # ghost fill + c2p on the new tree, the face repair, a second
        # fill (reference: InitBoundaryValuesAndPrimitives + RepairAMRFC
        # + second fill)
        new_state = phys.init_ghosts(new_state)
        if "bfc" in new_state:
            bfc = fc_internal(new_state["bfc"], mbi, act_axes, refined)
            new_state = phys.init_ghosts(dict(new_state, bfc=bfc))
        if new_state["u"].is_cuda:
            torch.cuda.synchronize(new_state["u"].device)
        t2 = _time.perf_counter()

        counts = np.zeros(mesh.nmb_total, dtype=np.int64)
        for i, p in enumerate(prov):
            if p[0] == "same":
                counts[i] = self.ncyc_since_ref[p[1]]
        self.ncyc_since_ref = counts
        self.updates.append({"ncycle": mesh.ncycle, "time": mesh.time,
                             "leaves": list(mesh.leaves),
                             "nmb": mesh.nmb_total,
                             "rebuild": 1e3 * (t1 - t0),
                             "remap": 1e3 * (t2 - t1)})
        return new_state
