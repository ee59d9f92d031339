"""The fused Z4c stage (kernel H) and the outflow fill it folds in
(kernel I), with their plain versions.

Counterpart of ``athenak_tpu/ops/pallas_z4c.py``.  ``fused_z4c_stage``
computes u' = AlgConstr(gam0 u + gam1 u1 + beta_dt RHS(u)) over the 22
Z4c channels in one launch of ``csrc/z4c_rhs.cuh`` (one instance file
a nghost and type, ``csrc/z4c_stage_ng*_f*.cu``), with the Sommerfeld
rows and the Kreiss-Oliger dissipation, and given the fluid's
stress-energy ``tmunu`` with its matter source (the instances
``csrc/z4c_matter_ng*_f*.cu``, counted apart as
``kernels.Z4C_STAGE_MATTER``); ``outflow_fill`` fills every
ghost of a block whose six faces are outflow in one launch of
``csrc/z4c_stage.cu``.  A
tensor on the card goes to the CUDA kernel, which raises on anything it
does not take; a tensor on the CPU goes to the plain version: the torch
RHS (``z4c/z4c.py``), the RK combine and ``alg_constr`` for the stage
(pointwise; its ghost cells hold wrapped stencils and mean nothing), and
the sweep fill ``bvals.fill_ghosts`` for the fill.

The stage kernel writes the interior of a fresh tensor (``torch.empty``):
its ghost cells are unspecified until the fill that follows.  It has
float32 and float64 instances; the run's gate (``Z4c.kernel_path``)
sends float32 only, as the JAX package sends only float32 to Pallas.

Left out as TPU layout: the row packing, the banded MXU matrices with
their split-bf16 products, the VMEM window sizing, the
``ATHENAK_Z4C_*`` switches and ablations, and the interpret hook.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels as _k
from ..z4c.z4c import NZ4C

# the stage's scalars, in the order of csrc/z4c_stage.cuh Z4cPrmIndex
# (the step is not one: the kernel reads it from device memory)
_PRM_NAMES = (
    "gam0", "gam1", "idx1", "idx2", "idx3", "idx1sq", "idx2sq",
    "idx3sq", "diss", "chi_div_floor", "chi_min_floor", "npow",
    "oopsi4_pow", "c6n", "k1", "k1f", "k2f", "use_z4c", "f0",
    "lapse_harmonic", "lapse_advect", "shift_ggamma", "shift_advect",
    "shift_eta", "shift_alpha2ggamma", "shift_hh")


def supports_z4c_stage(z, mesh) -> bool:
    """3-D meshes of one level, a single block or a pool (the JAX gate,
    ``pallas_z4c.py:342-346``: the kernel takes one inverse spacing for
    all blocks, and the blocks of a refined mesh have their own); the
    float32 and on-the-card part of the gate lives at the call site."""
    mbi = mesh.mb_indcs
    return mbi.nx2 > 1 and mbi.nx3 > 1 and not z.multilevel


def fold_bc_supported(bvals) -> bool:
    """True when the stage is followed by the outflow fill kernel: a
    single block whose six faces are all outflow (the NR production
    configuration) and no user boundary function (the JAX
    ``fold_bc_supported``, ``pallas_z4c.py:381``).  Any other mesh runs
    ``bvals.fill_ghosts``.  A hook installed after the physics is built
    is checked again at every stage (``Z4c.stage_update``)."""
    return (bvals.mesh.nmb_total == 1
            and all(f == "outflow" for f in bvals.flag.values())
            and bvals.user_bc_func is None)


def inverse_spacing(z):
    """The one inverse spacing (1/dx1, 1/dx2, 1/dx3) the kernel takes for
    every block: ``z.idx`` on a mesh of one level; on a refined mesh each
    block's own (``z.idx`` is then a tensor a block), which must be the
    same for all, as where every leaf lies on one level (the coupled TOV
    decks); raises where a block's spacing differs."""
    if not z.multilevel:
        return tuple(float(i) for i in z.idx)
    out = []
    for d in (1, 2, 3):
        dx = np.asarray(z.mesh.mb_size[f"dx{d}"], dtype=np.float64)
        if not (dx == dx[0]).all():
            raise ValueError(f"z4c_stage: the blocks' dx{d} differ "
                             f"({sorted(set(dx.tolist()))}); the kernel "
                             "takes one spacing for every block")
        out.append(float(1.0 / dx[0]))
    return tuple(out)


def stage_params(z, gam0, gam1):
    """The kernel's scalars as doubles, combined as the Python code
    combines them before they meet a tensor (rhs_core.py)."""
    o = z.opt
    k1, k2 = o.damp_kappa1, o.damp_kappa2
    idx = inverse_spacing(z)
    vals = {
        "gam0": gam0, "gam1": gam1,
        "idx1": idx[0], "idx2": idx[1], "idx3": idx[2],
        "idx1sq": idx[0] * idx[0], "idx2sq": idx[1] * idx[1],
        "idx3sq": idx[2] * idx[2],
        "diss": z.diss, "chi_div_floor": o.chi_div_floor,
        "chi_min_floor": o.chi_min_floor, "npow": o.chi_psi_power,
        "oopsi4_pow": -4.0 / o.chi_psi_power,
        "c6n": (1.0 / 6.0) * o.chi_psi_power,
        "k1": k1, "k1f": k1 * (1.0 - k2), "k2f": (2.0 + k2) * k1,
        "use_z4c": o.use_z4c,
        "f0": o.lapse_oplog * o.lapse_harmonicf,
        "lapse_harmonic": o.lapse_harmonic, "lapse_advect": o.lapse_advect,
        "shift_ggamma": o.shift_ggamma, "shift_advect": o.shift_advect,
        "shift_eta": o.shift_eta,
        "shift_alpha2ggamma": o.shift_alpha2ggamma,
        "shift_hh": o.shift_hh}
    return [float(vals[n]) for n in _PRM_NAMES]


def _stack_tmunu(tmunu):
    """The stress-energy as the kernel reads it: E, S_d (3) and S_dd (xx
    xy xz yy yz zz), the order of ``pallas_z4c.py:434``, stacked into one
    contiguous [nmb, 10, n3, n2, n1] tensor."""
    return torch.stack([tmunu["E"], *tmunu["S_d"], *tmunu["S_dd"]], dim=1)


def fused_z4c_stage_plain(u, u1, z, gam0, gam1, beta_dt, tmunu=None):
    """rhs -> RK combine -> alg_constr on whole arrays; ``tmunu`` (a dict
    as ``DynGRMHD.set_tmunu`` returns it) adds the matter source."""
    rhs = z.rhs(u, tmunu=tmunu)
    return z.alg_constr(gam0 * u + gam1 * u1 + beta_dt * rhs)


def _check_stage(u, u1, z, mat=None) -> None:
    # the block count from the tensor: one rank's blocks of a group are
    # fewer than the mesh's
    if u.dim() != 5 or tuple(u.shape[1:]) != tuple(z.shape[1:]):
        raise ValueError(f"z4c_stage: u must be [nmb, {z.shape[1]}, "
                         f"{z.shape[2]}, {z.shape[3]}, {z.shape[4]}], got "
                         f"{tuple(u.shape)}")
    if u1.shape != u.shape or u1.dtype != u.dtype \
            or u1.device != u.device:
        raise ValueError("z4c_stage: u1 must match u in shape, dtype and "
                         "device")
    if not (u.is_contiguous() and u1.is_contiguous()):
        raise ValueError("z4c_stage: u and u1 must be contiguous")
    if mat is not None and (
            tuple(mat.shape) != (u.shape[0], 10) + tuple(u.shape[2:])
            or mat.dtype != u.dtype or mat.device != u.device
            or not mat.is_contiguous()):
        raise ValueError(f"z4c_stage: the stress-energy must be a "
                         f"contiguous [nmb, 10, n3, n2, n1] tensor of u's "
                         f"dtype and device, got {tuple(mat.shape)} "
                         f"{mat.dtype} on {mat.device}")
    if z.ng not in (2, 3, 4, 5):
        raise ValueError(f"z4c_stage: nghost {z.ng} not in 2..5")
    if any(n < 2 * z.ng + 1 for n in u.shape[-3:]):
        raise ValueError(f"z4c_stage: shape {tuple(u.shape)} too small")


def fused_z4c_stage(u, u1, z, gam0, gam1, beta_dt, tmunu=None):
    """u' = AlgConstr(gam0 u + gam1 u1 + beta_dt RHS(u)); ``z`` is the
    Z4c physics object (options, dissipation, nghost, 1/dx and the
    Sommerfeld geometry); ``beta_dt`` the step, a 0-d tensor of u's dtype
    or a Python number, which the kernel reads from device memory;
    ``tmunu`` the fluid's stress-energy, a dict as ``DynGRMHD.set_tmunu``
    returns it, stacked here into the ten channels the matter instance
    reads cell by cell.  Interior cells only on the card; see the module
    docstring."""
    if not u.is_cuda:
        return fused_z4c_stage_plain(u, u1, z, gam0, gam1, beta_dt, tmunu)
    mat = None if tmunu is None else _stack_tmunu(tmunu)
    return _launch_stage(u, u1, z, gam0, gam1, beta_dt, mat)


def _launch_stage(u, u1, z, gam0, gam1, beta_dt, mat):
    """One launch of the vacuum instance (``mat`` None) or the matter
    instance (``mat`` the stacked channels, ``_stack_tmunu``)."""
    _check_stage(u, u1, z, mat)
    sbc = z.sbc_channels(u.device, u.dtype) if z.sbc_mask is not None \
        else None
    out = torch.empty_like(u)
    prm = (ctypes.c_double * len(_PRM_NAMES))(
        *stage_params(z, gam0, gam1))
    bdt = _k.step(beta_dt, u)
    nmb, _, n3, n2, n1 = u.shape
    kern = _k.Z4C_STAGE if mat is None else _k.Z4C_STAGE_MATTER
    fn = kern.entry(u.dtype)
    rc = fn(u.data_ptr(), u1.data_ptr(),
            None if sbc is None else sbc.data_ptr(),
            None if mat is None else mat.data_ptr(), out.data_ptr(),
            nmb, n3, n2, n1, z.ng, ctypes.addressof(prm), bdt.data_ptr(),
            _k.stream_ptr(u.device))
    _k.check(rc, kern.name)
    kern.launches += 1
    return out


def outflow_fill(u, bvals):
    """Fill every ghost of ``u [1, nvar, n3, n2, n1]``, the one block of
    ``bvals``' mesh, whose six faces are outflow, in place; returns
    ``u``.  The plain version is ``bvals.fill_ghosts`` (the x1 -> x2 ->
    x3 sweeps)."""
    if not u.is_cuda:
        return bvals.fill_ghosts(u)
    if not fold_bc_supported(bvals):
        raise ValueError("outflow_fill: the mesh must be one block with "
                         "six outflow faces")
    ng = bvals.ng
    if u.dim() != 5 or u.shape[0] != 1 or not u.is_contiguous():
        raise ValueError("outflow_fill: u must be a contiguous "
                         "[1, nvar, n3, n2, n1] tensor")
    if any(n < 2 * ng + 1 for n in u.shape[-3:]):
        raise ValueError(f"outflow_fill: shape {tuple(u.shape)} too small "
                         f"for nghost {ng}")
    n3, n2, n1 = u.shape[-3:]
    fn = _k.Z4C_OUTFLOW_FILL.entry(u.dtype)
    rc = fn(u.data_ptr(), u.numel() // (n3 * n2 * n1), n3, n2, n1, ng,
            _k.stream_ptr(u.device))
    _k.check(rc, _k.Z4C_OUTFLOW_FILL.name)
    _k.Z4C_OUTFLOW_FILL.launches += 1
    return u
