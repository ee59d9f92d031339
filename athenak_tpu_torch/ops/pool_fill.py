"""Ghost fill of a same-level periodic pool of blocks: kernel G and its
plain version.

Counterpart of ``athenak_tpu/ops/pallas_pool_fill.py`` (reference:
src/bvals/bvals_cc.cpp:42-289, bvals_fc.cpp).  On a same-level periodic
mesh every ghost element (face, edge or corner) is a copy of one interior
element of the block ``neighbor27`` names, so the fill is pure data
movement.  ``pool_fill_plain`` makes the ordered x3 -> x2 -> x1 slab
copies of the Pallas sweeps with tensor slicing; ``pool_fill`` launches
the CUDA kernel (``csrc/pool_fill.cu``), one gather of every ghost element
from its donor over a flat numbering of the call's ghosts
(``csrc/pool_fill.cuh``), for tensors on the card, raises on anything the
kernel does not take, and runs the plain version for CPU tensors.  Both fill
IN PLACE and return what they were given; the two are bitwise equal.

Gate (``supports_pool_fill``): same-level uniform mesh, nmb > 1, every
mesh face periodic, ng == 2.  The float32 and on-the-card parts of the
gate live in ``bvals.BoundaryValues.pool_fill_active``.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from .. import kernels as _k

_KINDS = ("cc", "x1f", "x2f", "x3f")


def neighbor27(mesh) -> np.ndarray:
    """[nmb, 27] donor-gid table over the (dz, dy, dx) direction cube,
    index 9*(dz+1) + 3*(dy+1) + (dx+1).  Diagonal donors are composed
    from the face-neighbor maps (exact on same-level periodic meshes)."""
    nmb = mesh.nmb_total
    step = {
        (+1, "x1"): np.asarray(mesh.nbr_gid["x1p"]),
        (-1, "x1"): np.asarray(mesh.nbr_gid["x1m"]),
        (+1, "x2"): np.asarray(mesh.nbr_gid["x2p"]),
        (-1, "x2"): np.asarray(mesh.nbr_gid["x2m"]),
        (+1, "x3"): np.asarray(mesh.nbr_gid["x3p"]),
        (-1, "x3"): np.asarray(mesh.nbr_gid["x3m"]),
    }
    out = np.empty((nmb, 27), dtype=np.int32)
    ident = np.arange(nmb)
    for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
        g = ident
        for d, ax in ((dx, "x1"), (dy, "x2"), (dz, "x3")):
            if d != 0:
                g = step[(d, ax)][g]
        out[:, 9 * (dz + 1) + 3 * (dy + 1) + (dx + 1)] = g
    return out


def supports_pool_fill(mesh) -> bool:
    """Same-level uniform, multi-block, fully periodic, ng == 2 (the
    f32/on-the-card parts of the gate live at the call sites)."""
    return (not getattr(mesh, "multilevel", False)
            and mesh.nmb_total > 1
            and mesh.mb_indcs.ng == 2
            and all(f == "periodic" for f in mesh.mesh_bcs.values()))


def _active_axes(mesh):
    mbi = mesh.mb_indcs
    return {ax for ax, nx in (("x1", mbi.nx1), ("x2", mbi.nx2),
                              ("x3", mbi.nx3)) if nx > 1}


def _ghost_cols(kind: str, ax: str, n: int, ng: int):
    """(hi_dst0, hi_src0, lo_dst0, lo_src0) start offsets of the ghost
    exchange along mesh axis ``ax`` with extent n.  On a face-centered
    array's normal axis the shared interface faces are owned
    identically by both blocks and are NOT exchanged (matching
    mhd.fill_ghosts_fc)."""
    if kind != "cc" and kind[:2] == ax:
        nxa = n - 2 * ng - 1
        return nxa + ng + 1, ng + 1, 0, nxa
    return n - ng, ng, 0, n - 2 * ng


def _nbr_idx(nbr27: np.ndarray, ax: str) -> np.ndarray:
    """[nmb, 2] (minus, plus) face-donor table for one axis."""
    off = {"x1": 1, "x2": 3, "x3": 9}[ax]
    return np.ascontiguousarray(
        np.stack([nbr27[:, 13 - off], nbr27[:, 13 + off]], axis=1))


_AXIS = {"x3": -3, "x2": -2, "x1": -1}


def pool_fill_plain(arrs, kinds, nbr27, mesh):
    """The Pallas sweeps' copies in their order (x3 slabs, then x2, then
    x1), each over the full current extent of the other axes, in place.
    Every sweep reads only donor cells that are interior along its own
    axis, so gathering both donor slabs before writing is exact.
    ``nbr27`` is the host table or a tensor copy of it."""
    if isinstance(nbr27, torch.Tensor):
        nbr27 = nbr27.cpu().numpy()
    ng = mesh.mb_indcs.ng
    active = _active_axes(mesh)
    for ax in ("x3", "x2", "x1"):
        if ax not in active:
            continue
        idx = torch.as_tensor(_nbr_idx(nbr27, ax), dtype=torch.long)
        axis = _AXIS[ax]
        for a, kind in zip(arrs, kinds):
            n = a.shape[axis]
            hi_d, hi_s, lo_d, lo_s = _ghost_cols(kind, ax, n, ng)
            ix = idx.to(a.device)
            lo = torch.index_select(a.narrow(axis, lo_s, ng), 0, ix[:, 0])
            hi = torch.index_select(a.narrow(axis, hi_s, ng), 0, ix[:, 1])
            a.narrow(axis, lo_d, ng).copy_(lo)
            a.narrow(axis, hi_d, ng).copy_(hi)
    return arrs


def call_dims(shapes, kinds, mesh):
    """(dims, ngs): the C entry's description of one fill of arrays of
    ``shapes`` and ``kinds``: dims[8 q .. 8 q + 7] = nc, n3, n2, n1,
    nint3, nint2, nint1, 0 for array q (nint the wrap distance along
    each axis) and the ghost width along x3, x2, x1 (0 on an inactive
    axis).  Raises on an array the kernel does not take."""
    return _call_dims(tuple(map(tuple, shapes)), tuple(kinds),
                      mesh.nmb_total, mesh.mb_indcs.ng,
                      frozenset(_active_axes(mesh)))[:2]


@functools.lru_cache(maxsize=64)
def _call_dims(shapes, kinds, nmb, ng, active):
    """(dims, ngs, dims as a ctypes array): made once for each set of
    shapes, since a fill runs twice a stage."""
    name = "pool_fill"
    dims = []
    for shape, kind in zip(shapes, kinds):
        if kind not in _KINDS:
            raise ValueError(f"{name}: unknown kind {kind!r}")
        if shape[0] != nmb or len(shape) != (5 if kind == "cc" else 4):
            raise ValueError(f"{name}: {kind} array of shape "
                             f"{tuple(shape)} for {nmb} blocks")
        nint = []
        for ax in ("x3", "x2", "x1"):
            n = shape[_AXIS[ax]]
            if ax in active and n < 3 * ng:
                raise ValueError(f"{name}: {kind} extent {n} too small")
            hi_d, hi_s, _, _ = _ghost_cols(kind, ax, n, ng)
            nint.append(hi_d - hi_s)
        nc = shape[1] if kind == "cc" else 1
        dims += [nc, *shape[-3:], *nint, 0]
    ngs = tuple(ng if ax in active else 0 for ax in ("x3", "x2", "x1"))
    return tuple(dims), ngs, (ctypes.c_int * len(dims))(*dims)


def _launch(arrs, kinds, table, mesh) -> None:
    """One launch of kernel G over up to three arrays; ``table`` is the
    [nmb, 27] int32 donor table on the arrays' device."""
    name = "pool_fill"
    first = arrs[0]
    if len(arrs) > 3:
        raise ValueError(f"{name}: at most 3 arrays a launch")
    nmb = mesh.nmb_total
    if not (isinstance(table, torch.Tensor) and table.dtype == torch.int32
            and table.device == first.device and table.is_contiguous()
            and tuple(table.shape) == (nmb, 27)):
        raise ValueError(f"{name}: the donor table must be a contiguous "
                         f"[{nmb}, 27] int32 tensor on {first.device}")
    for a in arrs:
        if not a.is_cuda or a.device != first.device:
            raise ValueError(f"{name}: every array must lie on "
                             f"{first.device}")
        if a.dtype != first.dtype:
            raise TypeError(f"{name}: arrays of mixed dtypes")
        if not a.is_contiguous():
            raise ValueError(f"{name}: the arrays must be contiguous")
    _, ngs, cdims = _call_dims(tuple(tuple(a.shape) for a in arrs),
                               tuple(kinds), nmb, mesh.mb_indcs.ng,
                               frozenset(_active_axes(mesh)))
    ptrs = [a.data_ptr() for a in arrs] + [0] * (3 - len(arrs))
    fn = _k.POOL_FILL.entry(first.dtype)
    rc = fn(*ptrs, len(arrs), ctypes.addressof(cdims), table.data_ptr(),
            nmb, *ngs, _k.stream_ptr(first.device))
    _k.check(rc, name)
    _k.POOL_FILL.launches += 1


def pool_fill(arrs, kinds, nbr27, mesh):
    """Fill the ghost shells of several arrays in place: kernel G in one
    launch for tensors on the card, the ordered sweeps for CPU tensors.

    arrs: list of tensors, each [nmb, C, n3, n2, n1] (cc) or
    [nmb, n3', n2', n1'] (fc); kinds: matching 'cc'/'x1f'/'x2f'/'x3f';
    nbr27: the ``neighbor27`` table, as an int32 tensor on the card for
    the kernel (``BoundaryValues.nbr27(device)`` keeps one)."""
    if arrs[0].is_cuda:
        _launch(arrs, kinds, nbr27, mesh)
        return list(arrs)
    return pool_fill_plain(list(arrs), kinds, nbr27, mesh)


def pool_fill_cc(u, nbr27, mesh):
    return pool_fill([u], ["cc"], nbr27, mesh)[0]


def pool_fill_fc(bfc, nbr27, mesh):
    ks = ("x1f", "x2f", "x3f") if "x3f" in bfc else ("x1f", "x2f")
    out = pool_fill([bfc[k] for k in ks], list(ks), nbr27, mesh)
    return {**bfc, **dict(zip(ks, out))}
