"""The fluxes of one direction: kernel J and its plain version.

Counterpart of ``athenak_tpu/ops/pallas_flux.py::fused_flux_dir`` (and
its kernel ``fused_plm_hlld_lanes``; reference: src/mhd/mhd_fluxes.cpp,
src/reconstruct/plm.hpp, src/mhd/rsolvers/hlld_mhd.hpp).  From the
primitives ``w`` [nmb, 5, n3, n2, n1], the cell-centred field ``bcc``
[nmb, 3, ...] and the face array ``bnormal`` of the direction (x1f
[nmb, n3, n2, n1+1] for x1, and so on; entry i is the lower face of
cell i, the last face is not read) it reconstructs with PLM along the
direction, floors the density and the internal energy of both face
states and solves HLLD.  It returns
(flux [nmb, 5, n3, n2, n1], ey, ez [nmb, n3, n2, n1]) with ey = -F(B_y)
and ez = F(B_z) of the face's rotated frame; face i is the lower face
of cell i.  The stencils wrap circularly, so the first two and the last
face along the direction are garbage, as on the JAX package's paths.

``fused_flux_dir`` launches the CUDA kernel (``csrc/flux_dir.cu``) for
tensors on the card and raises on anything it does not take; for CPU
tensors it runs ``flux_dir_plain``.  On the card nothing falls back.
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from .eos import EOSData
from .recon import plm
from .rsolvers_mhd import hlld
from .fluid import face_floors
from .stage import check_tensor, face_shapes, pallas_physics

# direction -> (cell axis of the stencil, the kernel's direction number)
_DIRS = {"x1": (4, 0), "x2": (3, 1), "x3": (2, 2)}
_IVX = {"x1": 1, "x2": 2, "x3": 3}


def supports_flux_dir(phys) -> bool:
    """Gate of kernel J: the JAX ``use_pallas`` conditions
    (``stage.pallas_physics``) restricted to the Newtonian solver; SR
    decks keep their SR solver on the general path.  The
    float32-on-the-card condition is checked at each call."""
    return not phys.is_sr and pallas_physics(phys)


def flux_dir_plain(w, bcc, bnormal, eos: EOSData, name: str, ivx: int):
    """Kernel J's function as plain tensor operations (the general path's
    ``face_fluxes`` for one direction, with the face-state floors)."""
    axis = _DIRS[name][0]
    bface = bnormal.narrow(axis - 1, 0, bnormal.shape[axis - 1] - 1)
    wl, wr = plm(w, axis)
    bl, br = plm(bcc, axis)
    wl, wr = face_floors(wl, eos), face_floors(wr, eos)
    return hlld(wl, wr, bl, br, bface, eos, ivx)


def fused_flux_dir(w, bcc, bnormal, eos: EOSData, name: str, ivx: int):
    """Kernel J for tensors on the card, its plain version for tensors on
    the CPU.  ``name`` is x1, x2 or x3 and ``ivx`` its normal-velocity
    channel; returns (flux, ey, ez) as fresh contiguous tensors."""
    if not w.is_cuda:
        return flux_dir_plain(w, bcc, bnormal, eos, name, ivx)
    kname = "fused_flux_dir"
    if name not in _DIRS or ivx != _IVX[name]:
        raise ValueError(f"{kname}: direction {name!r} with ivx {ivx}")
    if not eos.is_ideal:
        raise ValueError(f"{kname}: ideal-gas EOS only")
    if w.dim() != 5 or w.shape[1] != 5:
        raise ValueError(f"{kname}: w must be [nmb, 5, n3, n2, n1], "
                         f"got {tuple(w.shape)}")
    nmb, _, n3, n2, n1 = w.shape
    axis, d = _DIRS[name]
    if w.shape[axis] < 4:
        raise ValueError(f"{kname}: {w.shape[axis]} cells along {name}, "
                         "fewer than the stencil's 4")
    check_tensor(kname, "w", w, w.shape, w)
    check_tensor(kname, "bcc", bcc, (nmb, 3, n3, n2, n1), w)
    check_tensor(kname, "bnormal", bnormal,
                 face_shapes(nmb, n3, n2, n1)[f"{name}f"], w)
    flx = torch.empty_like(w)
    ey = torch.empty((nmb, n3, n2, n1), dtype=w.dtype, device=w.device)
    ez = torch.empty_like(ey)
    rc = _k.FLUX_DIR.entry(w.dtype)(
        w.data_ptr(), bcc.data_ptr(), bnormal.data_ptr(), flx.data_ptr(),
        ey.data_ptr(), ez.data_ptr(), nmb, n3, n2, n1, d, eos.gamma,
        eos.dfloor, eos.pfloor, _k.stream_ptr(w.device))
    _k.check(rc, kname)
    _k.FLUX_DIR.launches += 1
    return flx, ey, ez
