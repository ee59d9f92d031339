"""Periodic ghost fill of a single block: kernel B and its plain version.

Counterpart of ``athenak_tpu/ops/pallas_fill.py``.  Both functions fill
the ghosts of their arguments IN PLACE and return them; interior elements
are never written.  Tensors on the card go to the CUDA kernel
(``csrc/periodic_fill.cu``), one launch a call, which raises on anything
it does not take; tensors on the CPU go to the plain version, the
sequential x1 -> x2 -> x3 sweep fill of a block that is its own
neighbour on every side.
"""

from __future__ import annotations

import ctypes
import functools
import math

from .. import kernels as _k

NG = 2
_NORMAL_AXIS = {"x1f": 3, "x2f": 2, "x3f": 1}   # axis in [nmb, n3, n2, n1]


def shifts(shape, comp=None):
    """Wrap distance along the last three axes of ``shape``: the interior
    extent, or nx on the normal axis of face array ``comp``
    (n = nx + 2 ng + 1)."""
    nint = [n - 2 * NG for n in shape[-3:]]
    if comp is not None:
        nint[_NORMAL_AXIS[comp] - 1] -= 1
    return nint


def fill_plain(a, nint):
    """Sequential sweeps over the last three axes of ``a`` (any leading
    axes), in place: ghosts [0, ng) <- [nint, nint + ng) and
    [n - ng, n) <- [n - ng - nint, n - nint), with ``nint`` from
    ``shifts``."""
    for axis in (-1, -2, -3):
        n = a.shape[axis]
        s = nint[axis]
        lo = a.narrow(axis, s, NG).clone()
        hi = a.narrow(axis, n - NG - s, NG).clone()
        a.narrow(axis, 0, NG).copy_(lo)
        a.narrow(axis, n - NG, NG).copy_(hi)
    return a


@functools.lru_cache(maxsize=64)
def _call(kernel, shapes, comps, dtype):
    """(C entry, dims, address of dims, nmb): all that one launch over
    arrays of ``shapes`` and ``dtype`` needs besides its pointers and
    stream, made once for each set of shapes (a fill runs after every
    stage).  ``comps`` is (None,) for a cell array, else the face
    components; dims[8 q .. 8 q + 7] = nc, n3, n2, n1, nint3, nint2,
    nint1, 0 for array q (``pool_call`` in ``csrc/pool_fill.cuh``); the
    ctypes array rides along so that its address stays valid.  Raises on
    what the kernel does not take."""
    dims = []
    nmb = shapes[0][0]
    for shape, comp in zip(shapes, comps):
        if len(shape) != (5 if comp is None else 4) or (
                comp is not None and comp not in _NORMAL_AXIS):
            raise ValueError(f"periodic_fill: {comp} array of shape "
                             f"{tuple(shape)}")
        if any(n < 3 * NG for n in shape[-3:]):
            raise ValueError(f"periodic_fill: shape {tuple(shape)} too small")
        if shape[0] != nmb:
            raise ValueError(f"periodic_fill: arrays of {nmb} and "
                             f"{shape[0]} blocks in one call")
        if math.prod(shape) >= 2 ** 31:
            raise ValueError(f"periodic_fill: shape {tuple(shape)} too large")
        nc = shape[1] if comp is None else 1
        dims += [nc, *shape[-3:], *shifts(shape, comp), 0]
    arr = (ctypes.c_int * len(dims))(*dims)
    return kernel.entry(dtype), arr, ctypes.addressof(arr), nmb


def _launch(kernel, arrays, comps) -> None:
    """One launch of kernel B over ``arrays`` (all on one card, of one
    dtype, contiguous)."""
    first = arrays[0]
    dev, dtype = first.device, first.dtype
    for a in arrays:
        if not a.is_cuda or a.device != dev:
            raise ValueError(f"{kernel.name}: every array must lie on {dev}")
        if a.dtype != dtype:
            raise TypeError(f"{kernel.name}: {a.dtype} beside {dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{kernel.name}: the arrays must be contiguous")
    fn, _, dims, nmb = _call(kernel, tuple([a.shape for a in arrays]),
                             comps, dtype)
    ptrs = [a.data_ptr() for a in arrays] + [None] * (3 - len(arrays))
    rc = fn(*ptrs, len(arrays), dims, nmb, NG, _k.stream_ptr(dev))
    _k.check(rc, kernel.name)
    kernel.launches += 1


def periodic_fill_cc(u):
    """Fill all ghosts of ``u [nmb, C, n3, n2, n1]`` of a fully periodic
    single-block mesh, in place: one launch for every channel of every
    block."""
    if u.is_cuda:
        _launch(_k.PERIODIC_FILL_CC, [u], (None,))
        return u
    if u.dim() != 5:
        raise ValueError(f"periodic_fill_cc: expected 5-D, got {u.dim()}-D")
    return fill_plain(u, shifts(u.shape))


def periodic_fill_fc(bfc):
    """Face-field fill of a fully periodic single-block mesh, in place,
    for every face array in ``bfc`` (any of x1f, x2f, x3f): one launch
    for all of them.  On the normal axis the shared face is owned once,
    so the shift is nx about the (nx + 2 ng + 1)-face extent; transverse
    axes wrap like cell centres."""
    arrays = list(bfc.values())
    if arrays and arrays[0].is_cuda:
        _launch(_k.PERIODIC_FILL_FC, arrays, tuple(bfc))
        return bfc
    for comp, arr in bfc.items():
        if comp not in _NORMAL_AXIS or arr.dim() != 4:
            raise ValueError(f"periodic_fill_fc: {comp} must be a 4-D face "
                             "array")
        if arr.is_cuda:
            raise ValueError("periodic_fill_fc: face arrays on the CPU and "
                             "on the card in one call")
        fill_plain(arr, shifts(arr.shape, comp))
    return bfc
