"""One RK stage of 3-D Newtonian ideal MHD from primitives: kernel E and
its plain version.

Counterpart of ``athenak_tpu/ops/pallas_stage.py::fused_mega_stage3d``
(the v1 stage; reference task chain mhd_fluxes.cpp -> mhd_update.cpp ->
mhd_corner_e.cpp -> mhd_ct.cpp).  From the ghost-filled primitives ``w``
and cell-centred field ``bcc``, the face field ``bfc``, the RK base
``u0`` and the RK register ``(u1, bfc_old)`` a stage computes PLM +
face-state floors + HLLD in x1/x2/x3, the update
``gam0*u0 + gam1*u1 - beta_dt*div(F)``, GS07 corner EMFs and constrained
transport, and returns ``(u', bfc')``.  No c2p, counters or dt: the
post-stage kernel F (``ops/aux.py``) does those after the face fill.
Ghosts of the outputs are stale; the caller fills them.  With
``gam1 == 0`` neither ``u1`` nor ``bfc_old`` is read.

``fused_mega_stage3d`` launches the CUDA kernel
(``csrc/mega_stage_v1.cu``) for tensors on the card and raises on
anything the kernel does not take; for CPU tensors it runs
``fused_mega_stage3d_plain``, a composition of the port's plain tensor
functions.  Like the Pallas kernel (``pallas_stage.py:648-649``), both
floor the PLM face states, which the general ``MHD.fluxes`` path does not
(see ``ops/stage.py``).
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from .eos import EOSData
from .fluid import rk_update
from .rsolvers_mhd import hlld
from .stage import NG, check_tensor, dirs3, face_shapes


def fused_mega_stage3d_plain(w, bcc, bfc, u0, u1, bfc_old, eos: EOSData,
                             gam0, gam1, beta_dt, dxs):
    """The stage as plain tensor operations; returns (u', bfc')."""
    from ..physics.mhd import corner_e, ct_update, face_fluxes

    if float(gam1) == 0.0:
        # the register is not read: 0 * u0 adds nothing to a finite sum
        u1, bfc_old = u0, bfc
    dirs = dirs3(dxs)
    flx, emf = face_fluxes(w, bcc, bfc, eos, hlld, dirs, floors=True)
    un = rk_update(u0, u1, flx, gam0, gam1, beta_dt, dirs)
    e1, e2, e3 = corner_e(w, bcc, {n: flx[n][:, 0] for n in flx}, emf, 3)
    bn = ct_update(bfc, bfc_old, e1, e2, e3, gam0, gam1, beta_dt, dxs, 3)
    return un, bn


def fused_mega_stage3d(w, bcc, bfc, u0, u1, bfc_old, eos: EOSData, gam0,
                       gam1, beta_dt, dxs):
    """One RK stage: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.  ``gam0`` and ``gam1`` are Python
    numbers; ``beta_dt`` is the step, a 0-d tensor of w's dtype or a
    Python number, which the kernel reads from device memory; ``dxs``
    maps x1/x2/x3 to the cell size."""
    if not w.is_cuda:
        return fused_mega_stage3d_plain(w, bcc, bfc, u0, u1, bfc_old, eos,
                                        gam0, gam1, beta_dt, dxs)
    name = "fused_mega_stage3d"
    if w.dim() != 5 or w.shape[1] != 5:
        raise ValueError(f"{name}: w must be [nmb, 5, n3, n2, n1], got "
                         f"{tuple(w.shape)}")
    nmb, _, n3, n2, n1 = w.shape
    if min(n3, n2, n1) < 2 * NG + 2:
        raise ValueError(f"{name}: block {n3}x{n2}x{n1} too small")
    if not eos.is_ideal:
        raise ValueError(f"{name}: ideal-gas EOS only")
    skip_old = float(gam1) == 0.0
    fshape = face_shapes(nmb, n3, n2, n1)
    check_tensor(name, "w", w, w.shape, w)
    check_tensor(name, "bcc", bcc, (nmb, 3, n3, n2, n1), w)
    check_tensor(name, "u0", u0, w.shape, w)
    if not skip_old:
        check_tensor(name, "u1", u1, w.shape, w)
    for c, s in fshape.items():
        check_tensor(name, f"bfc[{c}]", bfc[c], s, w)
        if not skip_old:
            check_tensor(name, f"bfc_old[{c}]", bfc_old[c], s, w)

    old = [0] * 4 if skip_old else [
        t.data_ptr() for t in (u1, bfc_old["x1f"], bfc_old["x2f"],
                               bfc_old["x3f"])]
    uo = torch.empty_like(u0)
    bn = {c: torch.empty_like(bfc[c]) for c in fshape}
    bdt = _k.step(beta_dt, w)
    fn = _k.MEGA_STAGE_V1.entry(w.dtype)
    rc = fn(w.data_ptr(), bcc.data_ptr(), bfc["x1f"].data_ptr(),
            bfc["x2f"].data_ptr(), bfc["x3f"].data_ptr(), u0.data_ptr(),
            *old, uo.data_ptr(),
            bn["x1f"].data_ptr(), bn["x2f"].data_ptr(), bn["x3f"].data_ptr(),
            nmb, n3, n2, n1, NG, int(skip_old), float(gam0), float(gam1),
            bdt.data_ptr(), float(dxs["x1"]), float(dxs["x2"]),
            float(dxs["x3"]),
            eos.gamma, eos.dfloor, eos.pfloor, eos.tfloor, eos.sfloor,
            eos.sigma_max, _k.stream_ptr(w.device))
    _k.check(rc, name)
    _k.MEGA_STAGE_V1.launches += 1
    return uo, bn
