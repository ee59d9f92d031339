"""The split MHD stage: kernels C and D and their plain versions.

Counterpart of ``athenak_tpu/ops/pallas_stage.py::fused_stage3d`` and
``fused_ct3d`` (reference task chain mhd_fluxes.cpp -> mhd_update.cpp ->
mhd_corner_e.cpp -> mhd_ct.cpp).  ``fused_stage3d`` reconstructs the
primitives and the cell-centred field with PLM, floors the face states,
solves the Riemann problem per direction (SR HLLE, SR LLF or Newtonian
HLLD) and returns the RK register ``gam0*u0 + gam1*u1 - beta_dt*div(F)``
with the mass flux and the two face EMFs of each direction.
``fused_ct3d`` turns those into GS07 corner EMFs (with the SR transport
velocity under SR) and returns the CT-updated face fields.  Ghosts of
all outputs are unspecified; the caller fills them.

Each wrapper launches its CUDA kernel (``csrc/fused_stage.cu``,
``csrc/fused_ct.cu``) for tensors on the card and raises on anything the
kernel does not take; for CPU tensors it runs the plain version, a
composition of the port's plain tensor functions.  Like the Pallas
kernel, the plain stage floors the PLM face states, which the general
``MHD.fluxes`` path does not (see ``ops/stage.py``).
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from .eos import EOSData
from .fluid import rk_update
from .rsolvers_mhd import hlld
from .rsolvers_srmhd import hlle_srmhd, llf_srmhd
from .stage import (NG, check_tensor, dirs3, face_shapes, no_stage_extras,
                    pallas_physics)

# solver key -> (its number in csrc/fused_stage.cu, the plain solver)
SOLVERS = {"hlld": (0, hlld), "sr_hlle": (1, hlle_srmhd),
           "sr_llf": (2, llf_srmhd)}


def solver_for(phys) -> str:
    """The stage's Riemann solver key (the JAX ``_solver_for``)."""
    return f"sr_{phys.rsolver}" if phys.is_sr else phys.rsolver


def supports_fused_stage(phys, mesh) -> bool:
    """Gate for kernel C: the physics conditions of the JAX
    ``supports_fused_stage`` (``pallas_physics``, 3-D, one level, two
    ghost cells, none of FOFC, source terms, self-gravity and diffusion:
    ``no_stage_extras``).  The
    TPU tile conditions (``pallas_stage.py:183-187``) have no
    counterpart: the kernel takes any block of at least 6 cells a side."""
    return (len(phys.dirs) == 3 and pallas_physics(phys)
            and no_stage_extras(phys)
            and not mesh.multilevel and mesh.mb_indcs.ng == NG)


def supports_fused_ct(phys, mesh) -> bool:
    """Gate for kernel D: the JAX ``use_pallas and psbox is None and
    supports_fused_ct`` (``athenak_tpu/physics/mhd.py:230-232``,
    ``pallas_stage.py:365``), that is ``pallas_physics``, not GR, no
    shearing box, no resistivity (D's corner EMFs have no resistive
    part), 3-D, one level and two ghost cells.  Like the JAX gate it
    admits FOFC, source terms, viscosity, conduction and self-gravity:
    D runs after them on the general path and reads the corrected mass
    flux."""
    return (len(phys.dirs) == 3 and pallas_physics(phys)
            and not getattr(phys, "is_gr", False)
            and getattr(phys, "psbox", None) is None
            and getattr(phys, "presist", None) is None
            and not mesh.multilevel and mesh.mb_indcs.ng == NG)


def fused_stage3d_plain(w, bcc, bfc, u0, u1, eos: EOSData, gam0, gam1,
                        beta_dt, dxs, solver: str = "hlld"):
    """Kernel C's function as plain tensor operations; returns
    (acc, fden, emf)."""
    from ..physics.mhd import face_fluxes
    dirs = dirs3(dxs)
    flx, emf = face_fluxes(w, bcc, bfc, eos, SOLVERS[solver][1], dirs,
                           floors=True)
    # u0 is not read when gam0 == 0, as in the kernel
    acc = rk_update(u1 if gam0 == 0.0 else u0, u1, flx, gam0, gam1,
                    beta_dt, dirs)
    return acc, {n: f[:, 0] for n, f in flx.items()}, emf


def fused_ct3d_plain(w, bcc, fden, emf, bfc, bfc_old, gam0, gam1, beta_dt,
                     dxs, is_sr: bool = False):
    """Kernel D's function as plain tensor operations; returns the new
    face fields."""
    from ..physics.mhd import corner_e, ct_update
    e1, e2, e3 = corner_e(w, bcc, fden, emf, 3, is_sr=is_sr)
    return ct_update(bfc, bfc_old, e1, e2, e3, gam0, gam1, beta_dt, dxs, 3)


def _cell_shape(name, w):
    if w.dim() != 5 or w.shape[1] != 5:
        raise ValueError(f"{name}: w must be [nmb, 5, n3, n2, n1], "
                         f"got {tuple(w.shape)}")
    nmb, _, n3, n2, n1 = w.shape
    if min(n3, n2, n1) < 2 * NG + 2:
        raise ValueError(f"{name}: block {n3}x{n2}x{n1} too small")
    return nmb, n3, n2, n1


def fused_stage3d(w, bcc, bfc, u0, u1, eos: EOSData, gam0, gam1, beta_dt,
                  dxs, solver: str = "hlld"):
    """Kernel C for tensors on the card, its plain version for tensors on
    the CPU.  ``gam0`` and ``gam1`` are Python numbers, ``beta_dt`` the
    step (a 0-d tensor of w's dtype or a Python number; the kernel reads
    it from device memory), ``dxs`` maps x1/x2/x3 to the cell size and
    ``solver`` is a key of
    ``SOLVERS``.  Returns (acc, fden, emf): fden maps x1/x2/x3 to the
    mass flux and emf the six reference EMF names to the face EMFs, each
    [nmb, n3, n2, n1] and contiguous."""
    if not w.is_cuda:
        return fused_stage3d_plain(w, bcc, bfc, u0, u1, eos, gam0, gam1,
                                   beta_dt, dxs, solver)
    name = "fused_stage3d"
    if solver not in SOLVERS:
        raise ValueError(f"{name}: unknown solver {solver!r}")
    if not eos.is_ideal:
        raise ValueError(f"{name}: ideal-gas EOS only")
    nmb, n3, n2, n1 = _cell_shape(name, w)
    check_tensor(name, "w", w, w.shape, w)
    check_tensor(name, "bcc", bcc, (nmb, 3, n3, n2, n1), w)
    for c, s in face_shapes(nmb, n3, n2, n1).items():
        check_tensor(name, f"bfc[{c}]", bfc[c], s, w)
    check_tensor(name, "u1", u1, w.shape, w)
    if gam0 != 0.0:
        check_tensor(name, "u0", u0, w.shape, w)
    else:
        u0 = u1

    def empty(*shape):
        return torch.empty(shape, dtype=w.dtype, device=w.device)

    acc = torch.empty_like(w)
    fden = empty(3, nmb, n3, n2, n1)
    femf = empty(3, 2, nmb, n3, n2, n1)
    bdt = _k.step(beta_dt, w)
    rc = _k.FUSED_STAGE3D.entry(w.dtype)(
        w.data_ptr(), bcc.data_ptr(), bfc["x1f"].data_ptr(),
        bfc["x2f"].data_ptr(), bfc["x3f"].data_ptr(), u0.data_ptr(),
        u1.data_ptr(), acc.data_ptr(), fden.data_ptr(), femf.data_ptr(),
        nmb, n3, n2, n1, SOLVERS[solver][0],
        float(gam0), float(gam1), bdt.data_ptr(), float(dxs["x1"]),
        float(dxs["x2"]), float(dxs["x3"]), eos.gamma, eos.dfloor,
        eos.pfloor, _k.stream_ptr(w.device))
    _k.check(rc, name)
    _k.FUSED_STAGE3D.launches += 1
    return (acc, {"x1": fden[0], "x2": fden[1], "x3": fden[2]},
            {"e3x1": femf[0, 0], "e2x1": femf[0, 1],
             "e1x2": femf[1, 0], "e3x2": femf[1, 1],
             "e2x3": femf[2, 0], "e1x3": femf[2, 1]})


_EMF_NAMES = ("e3x1", "e2x1", "e1x2", "e3x2", "e2x3", "e1x3")


def fused_ct3d(w, bcc, fden, emf, bfc, bfc_old, gam0, gam1, beta_dt, dxs,
               is_sr: bool = False):
    """Kernel D for tensors on the card, its plain version for tensors on
    the CPU; ``beta_dt`` as for ``fused_stage3d``.  Returns the new face
    fields as fresh tensors."""
    if not w.is_cuda:
        return fused_ct3d_plain(w, bcc, fden, emf, bfc, bfc_old, gam0, gam1,
                                beta_dt, dxs, is_sr)
    name = "fused_ct3d"
    nmb, n3, n2, n1 = _cell_shape(name, w)
    cell = (nmb, n3, n2, n1)
    check_tensor(name, "w", w, w.shape, w)
    check_tensor(name, "bcc", bcc, (nmb, 3, n3, n2, n1), w)
    for d in ("x1", "x2", "x3"):
        check_tensor(name, f"fden[{d}]", fden[d], cell, w)
    for e in _EMF_NAMES:
        check_tensor(name, f"emf[{e}]", emf[e], cell, w)
    fshape = face_shapes(nmb, n3, n2, n1)
    for c, s in fshape.items():
        check_tensor(name, f"bfc[{c}]", bfc[c], s, w)
        check_tensor(name, f"bfc_old[{c}]", bfc_old[c], s, w)
    nb = {c: torch.empty_like(bfc[c]) for c in fshape}
    bdt = _k.step(beta_dt, w)
    rc = _k.FUSED_CT3D.entry(w.dtype)(
        w.data_ptr(), bcc.data_ptr(),
        *[fden[d].data_ptr() for d in ("x1", "x2", "x3")],
        *[emf[e].data_ptr() for e in _EMF_NAMES],
        *[bfc[c].data_ptr() for c in fshape],
        *[bfc_old[c].data_ptr() for c in fshape],
        *[nb[c].data_ptr() for c in fshape],
        nmb, n3, n2, n1, int(is_sr), float(gam0), float(gam1),
        bdt.data_ptr(), float(dxs["x1"]), float(dxs["x2"]),
        float(dxs["x3"]), _k.stream_ptr(w.device))
    _k.check(rc, name)
    _k.FUSED_CT3D.launches += 1
    return nb
