"""Periodic ghost fill of a single block: kernel B and its plain version.

Counterpart of ``athenak_tpu/ops/pallas_fill.py``.  Both functions fill
the ghosts of their arguments IN PLACE and return them; interior elements
are never written.  A tensor on the card goes to the CUDA kernel
(``csrc/periodic_fill.cu``), which raises on anything it does not take;
a tensor on the CPU goes to the plain version, the sequential x1 -> x2 ->
x3 sweep fill of a block that is its own neighbour on every side.
"""

from __future__ import annotations

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


def _launch(kernel, a, nint) -> None:
    if not a.is_contiguous():
        raise ValueError("periodic_fill: the tensor must be contiguous")
    if any(n < 3 * NG for n in a.shape[-3:]):
        raise ValueError(f"periodic_fill: shape {tuple(a.shape)} too small")
    n3, n2, n1 = a.shape[-3:]
    nouter = a.numel() // (n3 * n2 * n1)
    fn = kernel.entry(a.dtype)
    rc = fn(a.data_ptr(), nouter, n3, n2, n1, nint[-3], nint[-2], nint[-1],
            NG, _k.stream_ptr(a.device))
    _k.check(rc, kernel.name)
    kernel.launches += 1


def periodic_fill_cc(u):
    """Fill all ghosts of ``u [nmb, C, n3, n2, n1]`` of a fully periodic
    single-block mesh, in place."""
    if u.dim() != 5:
        raise ValueError(f"periodic_fill_cc: expected 5-D, got {u.dim()}-D")
    nint = shifts(u.shape)
    if u.is_cuda:
        _launch(_k.PERIODIC_FILL_CC, u, nint)
        return u
    return fill_plain(u, nint)


def periodic_fill_fc(bfc):
    """Face-field fill of a fully periodic single-block mesh, in place.
    On the normal axis the shared face is owned once, so the shift is nx
    about the (nx + 2 ng + 1)-face extent; transverse axes wrap like cell
    centres."""
    for comp, arr in bfc.items():
        if arr.dim() != 4:
            raise ValueError(f"periodic_fill_fc: {comp} must be 4-D")
        nint = shifts(arr.shape, comp)
        if arr.is_cuda:
            _launch(_k.PERIODIC_FILL_FC, arr, nint)
        else:
            fill_plain(arr, nint)
    return bfc
