"""Cell-centred field + cons->prim after a stage: kernel F and its plain
version.

Counterpart of ``athenak_tpu/ops/pallas_stage.py::fused_aux3d``
(reference chain mhd.cpp bcc0 + ideal_c2p_mhd.hpp + the periodic BC
copies).  From ``u`` and the ghost-filled face field ``bfc`` it computes
bcc (faces i and i+1 of each axis), the primitives ``w`` and the floored
``u`` with the floor chain, the floor counts over the interior cells and,
when ``dxs`` is given, ``dtmin`` = min_d dx_d / max(|v_d| + c_f,d) over
the interior cells.  Returns ``(u_fixed, w, bcc, counters)``.

``wrap=True`` (a single fully periodic block): every ghost of u, w and bcc
comes out filled with the value of the interior cell it wraps to.  The
Pallas kernel fills the in-plane ghosts of the three and heals the x3
ghost planes of w alone, leaving those of u stale
(``pallas_stage.py:1135-1140, 1285-1290``); the port fills u's x3 ghost
planes too, so every consumer of the state, outputs included, reads
filled ghosts.  ``wrap=False`` (a pool, whose u the pool fill has
filled): pointwise, no fill.

``fused_aux3d`` launches the CUDA kernel (``csrc/fused_aux.cu``) for
tensors on the card, once a call: the kernel's last block writes the
counts and ``dtmin`` (as ``_dtmin`` computes it, bitwise) into the call's
fresh outputs.  It raises on anything the kernel does not take; for CPU tensors
it runs ``fused_aux3d_plain``.
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from .eos import EOSData, cons_to_prim_mhd
from .fill import fill_plain, shifts
from .stage import NG, _dtmin, check_tensor, face_shapes, interior_mask


def fused_aux3d_plain(u, bfc, eos: EOSData, dxs=None, wrap: bool = True):
    """bcc + c2p as plain tensor operations, then (wrap) the periodic
    fill of u, w and bcc; returns (u_fixed, w, bcc, counters)."""
    from ..physics.mhd import compute_bcc, signal_speeds

    bcc = compute_bcc(bfc)
    mask = interior_mask(u.shape, u.device)
    w, uf, counters = cons_to_prim_mhd(u, bcc, eos, interior=mask)
    if dxs is not None:
        dv = signal_speeds(eos, w, bcc)
        counters["dtmin"] = _dtmin(dxs, [d[:, mask].max() for d in dv])
    if wrap:
        for t in (uf, w, bcc):
            fill_plain(t, shifts(t.shape))
    return uf, w, bcc, counters


# The kernel's accumulators, zero between calls, one set for each card
# and stream (the last block of a launch zeroes them for the next one).
_WORK = {}


def _workspace(device):
    key = (device, _k.stream_ptr(device))
    work = _WORK.get(key)
    if work is None:
        work = _WORK[key] = torch.zeros(7, dtype=torch.int64, device=device)
    return key, work


def fused_aux3d(u, bfc, eos: EOSData, dxs=None, wrap: bool = True):
    """bcc + c2p + counters (+ dtmin): the CUDA kernel for tensors on the
    card (one launch, nothing before or after it), the plain version for
    tensors on the CPU."""
    if not u.is_cuda:
        return fused_aux3d_plain(u, bfc, eos, dxs, wrap)
    name = "fused_aux3d"
    if u.dim() != 5 or u.shape[1] != 5:
        raise ValueError(f"{name}: u must be [nmb, 5, n3, n2, n1], got "
                         f"{tuple(u.shape)}")
    nmb, _, n3, n2, n1 = u.shape
    if min(n3, n2, n1) < 3 * NG:
        raise ValueError(f"{name}: block {n3}x{n2}x{n1} too small")
    if not eos.is_ideal:
        raise ValueError(f"{name}: ideal-gas EOS only")
    check_tensor(name, "u", u, u.shape, u)
    for c, s in face_shapes(nmb, n3, n2, n1).items():
        check_tensor(name, f"bfc[{c}]", bfc[c], s, u)
    uo = torch.empty_like(u)
    w = torch.empty_like(u)
    bcc = torch.empty((nmb, 3, n3, n2, n1), dtype=u.dtype, device=u.device)
    counts = torch.empty(3, dtype=torch.int64, device=u.device)
    dtmin = None if dxs is None else torch.empty((), dtype=u.dtype,
                                                 device=u.device)
    key, work = _workspace(u.device)
    dx = [0.0] * 3 if dxs is None else [dxs[c] for c in ("x1", "x2", "x3")]
    rc = _k.FUSED_AUX3D.entry(u.dtype)(
        u.data_ptr(), bfc["x1f"].data_ptr(), bfc["x2f"].data_ptr(),
        bfc["x3f"].data_ptr(), uo.data_ptr(), w.data_ptr(), bcc.data_ptr(),
        work.data_ptr(), counts.data_ptr(),
        None if dtmin is None else dtmin.data_ptr(), nmb, n3, n2, n1, NG,
        int(wrap), int(dxs is not None), eos.gamma, eos.dfloor, eos.pfloor,
        eos.tfloor, eos.sfloor, eos.sigma_max, *dx, key[1])
    if rc != 0:
        _WORK.pop(key, None)   # never reuse accumulators a failed call saw
    _k.check(rc, name)
    _k.FUSED_AUX3D.launches += 1
    counters = dict(zip(("neos_dfloor", "neos_efloor", "neos_tfloor"),
                        counts.unbind()))
    if dtmin is not None:
        counters["dtmin"] = dtmin
    return uo, w, bcc, counters
