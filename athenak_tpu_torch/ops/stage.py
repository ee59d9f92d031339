"""One RK stage of 3-D Newtonian ideal MHD: kernel A and its plain version.

Counterpart of ``athenak_tpu/ops/pallas_stage.py::fused_mega_stage3d_v2``
(reference task chain mhd_fluxes.cpp -> mhd_update.cpp ->
mhd_corner_e.cpp -> mhd_ct.cpp + ideal_c2p_mhd + mhd_newdt.cpp).  From a
ghost-filled ``(u, bfc)`` and the RK register ``(u1, bfc_old)`` a stage
computes bcc and the primitives with the floors (the floored ``u`` is the
RK base), PLM + face-state floors + HLLD in x1/x2/x3, the update
``gam0*u + gam1*u1 - beta_dt*div(F)``, GS07 corner EMFs, constrained
transport, and the bcc + c2p of the new state, whose floored ``u'`` it
returns with the new face field and the counters.  Ghosts of the outputs
are stale; the caller fills them.

``mega_stage_v2`` launches the CUDA kernel (``csrc/mega_stage_v2.cu``:
one launch that marches tiles of columns through the planes with w, bcc,
the fluxes and the EMFs in shared memory, so the wrapper allocates only
the outputs and the 6-word reduction buffer) for tensors on the card and
raises on anything the kernel does not take;
for CPU tensors it runs ``mega_stage_v2_plain``, a composition of the
port's plain tensor functions.

Known differences from the JAX package's general path, kept on purpose:

  * PLM face-state floors.  Like the Pallas kernel
    (``pallas_stage.py:925-926, 933-934, 944-945``), the kernel and its
    plain version floor the reconstructed density and internal energy
    on both sides of every face.  The general ``MHD.fluxes`` path floors
    them only for ppmx/wenoz/teno, never for PLM
    (``recon.py:237``, ``mhd.py:320, 343``).  For states above the floors
    the two agree, since PLM face states lie between neighbouring cell
    values.
  * Floor counters.  The stage counts floor hits of the new state over
    the interior cells only, like the Pallas v2 kernel; the general path
    counts over whole arrays, ghosts included (``eos.py:161, 188-189``).
"""

from __future__ import annotations

import torch

from .. import kernels as _k
from ..ops.eos import EOSData, cons_to_prim_mhd

NG = 2


def pallas_physics(phys) -> bool:
    """The physics conditions of the JAX ``MHD.use_pallas``
    (``athenak_tpu/physics/mhd.py:127-146``): PLM, Newtonian HLLD or SR
    HLLE/LLF (never GR), the ideal gas, no passive scalars.  The JAX
    package takes none of its MHD stage kernels (A, C, D, E, J) without
    them; every kernel gate of the port's MHD stage starts from this
    one."""
    is_gr = getattr(phys, "is_gr", False)
    ok_solver = ((not (phys.is_sr or is_gr) and phys.rsolver == "hlld")
                 or (phys.is_sr and not is_gr
                     and phys.rsolver in ("hlle", "llf")))
    return (phys.recon_method == "plm" and ok_solver
            and phys.nscalars == 0 and phys.eos.is_ideal)


def no_stage_extras(phys) -> bool:
    """None of the physics that the JAX stage-kernel gates exclude
    (``pallas_stage.py:176-182, 564-573``, and the shearing box's
    ``psbox is None`` clauses of ``athenak_tpu/physics/mhd.py:225-236``):
    first-order flux correction, GR flux excision, ``<*_srcterms>``,
    self-gravity, viscosity, resistivity, conduction and the shearing
    box.  The stage kernels A, C and E have no room for the diffusive
    fluxes, the resistive EMFs, the potential solve or the sheared
    boundaries' remap between the fill and the c2p."""
    return (not phys.use_fofc
            and getattr(phys, "psbox", None) is None
            and getattr(phys, "fofc_excise_mask", None) is None
            and phys.srcterms is None
            and getattr(phys, "pgrav", None) is None
            and getattr(phys, "pvisc", None) is None
            and getattr(phys, "presist", None) is None
            and getattr(phys, "pcond", None) is None)


def supports_mega_stage(phys, mesh) -> bool:
    """Gate of the Newtonian stage kernels (A here, E in
    ``ops/stage_v1.py``): ``pallas_physics`` without SR, 3-D, one level,
    two ghost cells, no FOFC and no source terms (the JAX
    ``supports_mega_stage``)."""
    return (len(phys.dirs) == 3 and not phys.is_sr and pallas_physics(phys)
            and no_stage_extras(phys)
            and not getattr(mesh, "multilevel", False)
            and mesh.mb_indcs.ng == NG)


def supports_mega_v2(phys, mesh) -> bool:
    """Gate of kernel A: the stage-kernel gate, no turbulence driving,
    whose forcing reads the state's primitives between cycles, no test
    particles (``pallas_stage.py:788``), no problem generator's
    source-term hook or user boundary function and no prolongation in
    primitives (the JAX ``supports_mega_v2``).  The hooks arrive after
    the physics is built, so ``MHD.kernel_path`` checks them again at
    every stage."""
    return (getattr(phys, "pturb", None) is None
            and getattr(phys, "ppart", None) is None
            and getattr(phys, "srcterms_func", None) is None
            and phys.bvals.user_bc_func is None
            and not phys.bvals.prolong_prims
            and supports_mega_stage(phys, mesh))


def dirs3(dxs):
    """(name, axis, ivx, dx) of the three directions of a 3-D block."""
    return [("x1", 4, 1, dxs["x1"]), ("x2", 3, 2, dxs["x2"]),
            ("x3", 2, 3, dxs["x3"])]


def check_tensor(kernel, name, t, shape, like):
    """Raise unless ``t`` lies on ``like``'s card with its dtype, has
    ``shape`` and is contiguous: what a kernel's C entry point takes."""
    if not t.is_cuda or t.device != like.device:
        raise ValueError(f"{kernel}: {name} must lie on {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{kernel}: {name} is {t.dtype}, not {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")


def face_shapes(nmb, n3, n2, n1):
    return {"x1f": (nmb, n3, n2, n1 + 1), "x2f": (nmb, n3, n2 + 1, n1),
            "x3f": (nmb, n3 + 1, n2, n1)}


def interior_mask(shape, device):
    """[n3, n2, n1] boolean mask of the interior cells."""
    n3, n2, n1 = shape[-3:]
    m = torch.zeros((n3, n2, n1), dtype=torch.bool, device=device)
    m[NG:n3 - NG, NG:n2 - NG, NG:n1 - NG] = True
    return m


def _dtmin(dxs, vmax):
    """min over directions of dx / max(|v| + c_f), a 0-d tensor."""
    return torch.stack([dxs[n] / vmax[c]
                        for c, n in enumerate(("x1", "x2", "x3"))]).min()


def mega_stage_v2_plain(u, bfc, u1, bfc_old, eos: EOSData, gam0, gam1,
                        beta_dt, dxs):
    """The stage as plain tensor operations; returns (u', bfc', counters)
    with counters neos_dfloor/efloor/tfloor and dtmin."""
    from ..physics.mhd import (compute_bcc, corner_e, ct_update,
                               face_fluxes, rk_update, signal_speeds)
    from .rsolvers_mhd import hlld

    bcc = compute_bcc(bfc)
    w, u0, _ = cons_to_prim_mhd(u, bcc, eos)
    dirs = dirs3(dxs)
    flx, emf = face_fluxes(w, bcc, bfc, eos, hlld, dirs, floors=True)
    un = rk_update(u0, u1, flx, gam0, gam1, beta_dt, dirs)
    e1, e2, e3 = corner_e(w, bcc, {n: flx[n][:, 0] for n in flx}, emf, 3)
    bn = ct_update(bfc, bfc_old, e1, e2, e3, gam0, gam1, beta_dt, dxs, 3)
    bccn = compute_bcc(bn)
    mask = interior_mask(u.shape, u.device)
    wn, un, counters = cons_to_prim_mhd(un, bccn, eos, interior=mask)
    dv = signal_speeds(eos, wn, bccn)
    counters["dtmin"] = _dtmin(dxs, [d[:, mask].max() for d in dv])
    return un, bn, counters


def mega_stage_v2(u, bfc, u1, bfc_old, eos: EOSData, gam0, gam1, beta_dt,
                  dxs):
    """One RK stage: the CUDA kernel for tensors on the card, the plain
    version for tensors on the CPU.  ``gam0`` and ``gam1`` are Python
    numbers; ``beta_dt`` is the step, a 0-d tensor of u's dtype (the
    driver's) or a Python number, which the kernel reads from device
    memory; ``dxs`` maps x1/x2/x3 to the cell size."""
    if not u.is_cuda:
        return mega_stage_v2_plain(u, bfc, u1, bfc_old, eos, gam0, gam1,
                                   beta_dt, dxs)
    if u.dim() != 5 or u.shape[1] != 5:
        raise ValueError(f"mega_stage_v2: u must be [nmb, 5, n3, n2, n1], "
                         f"got {tuple(u.shape)}")
    nmb, _, n3, n2, n1 = u.shape
    if min(n3, n2, n1) < 2 * NG + 2:
        raise ValueError(f"mega_stage_v2: block {n3}x{n2}x{n1} too small")
    if not eos.is_ideal:
        raise ValueError("mega_stage_v2: ideal-gas EOS only")
    fshape = face_shapes(nmb, n3, n2, n1)
    name = "mega_stage_v2"
    check_tensor(name, "u", u, u.shape, u)
    check_tensor(name, "u1", u1, u.shape, u)
    for c, s in fshape.items():
        check_tensor(name, f"bfc[{c}]", bfc[c], s, u)
        check_tensor(name, f"bfc_old[{c}]", bfc_old[c], s, u)

    uo = torch.empty_like(u)
    bn = {c: torch.empty_like(bfc[c]) for c in fshape}
    red = torch.empty(6, dtype=torch.int64, device=u.device)
    bdt = _k.step(beta_dt, u)
    fn = _k.MEGA_STAGE_V2.entry(u.dtype)
    rc = fn(u.data_ptr(), bfc["x1f"].data_ptr(), bfc["x2f"].data_ptr(),
            bfc["x3f"].data_ptr(), u1.data_ptr(),
            bfc_old["x1f"].data_ptr(), bfc_old["x2f"].data_ptr(),
            bfc_old["x3f"].data_ptr(), uo.data_ptr(),
            bn["x1f"].data_ptr(), bn["x2f"].data_ptr(),
            bn["x3f"].data_ptr(), red.data_ptr(), nmb, n3, n2, n1, NG,
            float(gam0), float(gam1), bdt.data_ptr(),
            float(dxs["x1"]), float(dxs["x2"]), float(dxs["x3"]),
            eos.gamma, eos.dfloor, eos.pfloor, eos.tfloor, eos.sfloor,
            eos.sigma_max, _k.stream_ptr(u.device))
    _k.check(rc, "mega_stage_v2")
    _k.MEGA_STAGE_V2.launches += 1
    # red[3:6] hold the bit patterns of the positive maxima
    if u.dtype == torch.float32:
        vmax = red[3:6].to(torch.int32).view(torch.float32)
    else:
        vmax = red[3:6].view(torch.float64)
    counters = {"neos_dfloor": red[0], "neos_efloor": red[1],
                "neos_tfloor": red[2], "dtmin": _dtmin(dxs, vmax)}
    return uo, bn, counters
