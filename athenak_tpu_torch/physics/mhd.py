"""Ideal magnetohydrodynamics with constrained transport, Newtonian,
special- or general-relativistic.

Counterpart of ``athenak_tpu/physics/mhd.py`` (reference:
src/mhd/mhd.hpp, mhd_tasks.cpp:48-81, mhd_fluxes.cpp, mhd_corner_e.cpp,
mhd_ct.cpp).  Layouts are the JAX package's:

  * ``u``/``w`` are [nmb, nvar, n3, n2, n1] (ghosts included);
  * the face field is a dict x1f [nmb, n3, n2, n1+1], x2f [nmb, n3, n2+1,
    n1], x3f [nmb, n3+1, n2, n1];
  * edge EMFs are cell-indexed: entry (k, j, i) is the edge at the lower
    corner of cell (k, j, i).

A stage runs one of four paths.  On the card in float32:

  * a Newtonian 3-D PLM+HLLD deck takes the stage kernel
    (``ops/stage.py``, kernel A) and then the ghost fills (kernel B for
    a single periodic block, kernel G for a same-level periodic pool of
    blocks);
  * such a deck with turbulence driving, whose forcing reads the
    state's primitives, takes the v1 route instead: kernel E
    (``ops/stage_v1.py``, the stage from w and bcc), the face fill, then
    kernel F (``ops/aux.py``: bcc, c2p, floor counts and the new-dt
    maxima; with the periodic wrap on a single block, after the pool
    fill of u on a pool);
  * an SR 3-D PLM deck (HLLE or LLF) takes the split stage: kernel C
    (``ops/stage_split.py::fused_stage3d``: PLM, face floors, Riemann
    solve, RK update) and kernel D (``fused_ct3d``: GS07 corner EMFs +
    CT), then the fills, bcc and c2p.  Kernel C's HLLD instance serves
    the Newtonian decks its gate admits when kernel A's does not; the
    port has none yet;
  * every other deck takes the general path, the plain tensor functions
    below; a 3-D single-level deck whose physics the JAX ``use_pallas``
    admits (PLM, Newtonian HLLD or SR HLLE/LLF, the ideal gas, no
    scalars) still runs its CT through kernel D there, as the JAX
    package does, and a Newtonian PLM+HLLD deck (a statically refined
    mesh, a 1-D or 2-D deck) forms its fluxes with kernel J
    (``ops/flux.py``: PLM, face floors and HLLD, one launch per
    direction).  SR decks keep the SR solver there, never HLLD.
    Isothermal, passive-scalar, LLF/HLLE/advect and PPM/WENO decks take
    the general path throughout, with only the ghost fills' kernels.
    First-order flux correction (``<mhd>/fofc``) and ``<mhd_srcterms>``
    close the stage kernels A, C and E, as in the JAX package: such a
    deck takes the general path, with kernel J's fluxes and kernel D's
    CT where their gates admit it.  FOFC replaces the fluxes and face
    EMFs of the faces of flagged cells before the corner EMFs, so D
    reads the corrected mass flux.

Everywhere else (the CPU, float64) the general path runs throughout.
On a statically refined mesh the general path adds the JAX package's
three multilevel steps: the flux correction after the fluxes
(``refinement.flux_correct_cc``), the EMF correction after the corner
EMFs (``mhd_smr.emf_correct``) and the mixed-level fills; the cell sizes
are per block, [nmb, 1, 1, 1(, 1)] tensors on the run's device, and
``<mesh_refinement>/prolong_primitives`` prolongs the ghosts in primitive
variables after every c2p (``bvals.prolong_prims_fixup``).  An adaptive
mesh (``amr.py``) rebuilds the physics at every tree update, so these
routes follow the tree.
The deck option ``<mhd>/use_kernels = false`` keeps a run on the general
path and the sweep fills, for comparison.

GR MHD (``<coord>/general_rel``) takes none of the kernels, as in the
JAX package (``pallas_physics``): it runs the general path on the fixed
Kerr-Schild metric of ``coordinates.GRGeometry``, with the GR solvers on
the face metric, the GR cell-centred EMFs in ``corner_e``, the
coordinate source terms with the magnetic stress after the RK update,
the Lorentz ceiling and excision in the c2p, first-order fluxes on the
faces around the horizon (the flux-excision mask) and dt bounded by the
speed of light.  A problem generator may enroll ``srcterms_func(u, w,
beta_dt[, bcc=][, t=])`` (``needs_bcc``, ``needs_time``), called after
the source terms on every route (after kernel E on the v1 route and
kernel C on the split one), and ``bvals.user_bc_func``; either closes
kernel A at run time, and a user boundary function closes F's fill and
the pool route of the v1 stage, as in the JAX package (generators
install the hooks after the physics is built).

Test particles (``<particles>``) close kernel A alone, as in the JAX
package (``supports_mega_v2``): a deck of A's gate takes the v1 route E
+ F, with F's new-dt maxima off (the particles' crossing time bounds
dt); the driver pushes them once a cycle.  The shearing box
(``<shearing_box>``) closes A, C, D and E, as the JAX package's
``psbox`` clauses do, and leaves J open: a PLM + HLLD deck forms its
fluxes with J on the general path, whose stage adds the Coriolis and
tidal terms after the ``<mhd_srcterms>``, the 2-D r-z box's orbital
EMF before CT, and the sheared remap of the x1 ghosts after the fills;
the driver advects the orbits (cell and face variables) once a cycle.
A ``shear_periodic`` side closes the fills B and G (their gates want
every side periodic).

Viscosity, conduction and resistivity (``diffusion.py``) add their
fluxes into the Godunov fluxes on the general path, after kernel J's
where J forms them, and the resistive EMFs into the corner EMFs; they
bound dt.  Self-gravity (``<gravity>``; ``gravity.py``,
``multigrid.py``) solves for the potential from the stage's state
before the RK update and ``<mhd_srcterms>/self_gravity`` applies it.
Any of the four closes the stage kernels A, C and E (and F with E), as
in the JAX package; resistivity also closes D, whose corner EMFs have no
resistive part.  Kernel J stays open: its gate reads only the solver
physics.
A driven run (``<turb_driving>``) carries ``turb_force`` in its state;
the driver applies the forcing once a cycle before the stages.
"""

from __future__ import annotations

import torch

from ..bvals import _AXIS_OF, BoundaryValues, kernel_dtype_ok
from ..refinement import flux_correct_cc
from . import mhd_smr
from ..comm import LocalAttr
from ..coordinates import Coordinates, GRGeometry, excision_masks
from ..indices import IDN, IEN, IVX, IVY, IVZ, RECON_NGHOST
from ..mesh import Mesh
from ..ops import recon as recon_ops
from ..ops import rsolvers_mhd
from ..ops.eos import EOSData, cons_to_prim_mhd, prim_to_cons_mhd
from ..ops.fluid import face_floors, fofc_faces, rk_update, scalar_fluxes
from ..ops.eos_gr import (coord_src_terms, cons_to_prim_gr_mhd,
                          four_field, four_velocity, prim_to_cons_gr_mhd)
from ..ops.eos_sr import (cons_to_prim_sr_mhd, prim_to_cons_sr_mhd,
                          sr_mhd_fast_speeds)
from ..ops.rsolvers_grmhd import GR_MHD_RSOLVER_FNS, llf_grmhd
from ..ops.rsolvers_srmhd import SR_MHD_RSOLVER_FNS, llf_srmhd
from ..diffusion import Conduction, Resistivity, Viscosity
from ..gravity import make_gravity
from ..multigrid import MGPoisson
from ..particles import Particles
from ..shearing_box import ShearingBox
from ..srcterms import SourceTerms

# axes of the 4-D [nmb, n3, n2, n1] EMF / face arrays
KA, JA, IA = 1, 2, 3
# face-EMF names per direction: ey is -F(B_trans1), ez is +F(B_trans2)
EY_NAME = {"x1": "e3x1", "x2": "e1x2", "x3": "e2x3"}
EZ_NAME = {"x1": "e2x1", "x2": "e3x2", "x3": "e1x3"}


def _sh(a, s: int, axis: int):
    """a shifted so result[i] = a[i + s] (circular)."""
    return torch.roll(a, -s, dims=axis)


def compute_bcc(bfc):
    """Cell-centred field from the face averages."""
    b1 = 0.5 * (bfc["x1f"][..., :-1] + bfc["x1f"][..., 1:])
    b2 = 0.5 * (bfc["x2f"][..., :-1, :] + bfc["x2f"][..., 1:, :])
    b3 = 0.5 * (bfc["x3f"][..., :-1, :, :] + bfc["x3f"][..., 1:, :, :])
    return torch.stack([b1, b2, b3], dim=1)


def face_fluxes(w, bcc, bfc, eos: EOSData, solve, dirs, rec=recon_ops.plm,
                floors: bool = False, face_metric=None):
    """Reconstruct (w, bcc) and solve per direction; returns (flx, emf)
    with the reference EMF names (reference:
    src/mhd/mhd_fluxes.cpp:120-250).  ``floors`` applies the density and
    internal-energy floors to the face states, as the stage kernels do;
    ``dirs`` lists (name, axis, ivx, dx); ``face_metric(name)`` gives the
    GR solvers their face metric.  Passive scalars take the upwind flux
    on the mass flux."""
    bface = {"x1": bfc["x1f"][..., :-1],
             "x2": bfc["x2f"][..., :-1, :],
             "x3": bfc["x3f"][..., :-1, :, :]}
    flx, emf = {}, {}
    for name, axis, ivx, _dx in dirs:
        wl, wr = rec(w, axis)
        bl, br = rec(bcc, axis)
        if floors:
            wl, wr = face_floors(wl, eos), face_floors(wr, eos)
        extra = face_metric(name) if face_metric is not None else ()
        f, ey, ez = solve(wl, wr, bl, br, bface[name], eos, ivx, *extra)
        flx[name] = scalar_fluxes(f, wl, wr, eos.nfluid)
        emf[EY_NAME[name]] = ey
        emf[EZ_NAME[name]] = ez
    return flx, emf


def _gs07(e_cc, e_a, e_b, f_a, f_b, axa, axb):
    """Gardiner-Stone corner value of an EMF component lying along the
    remaining axis, from its face averages e_a (faces normal to axa) and
    e_b (normal to axb), upwinded by the mass fluxes f_a and f_b.  The
    corner sits at the lower corner in both transverse axes."""
    e_a_m = _sh(e_a, -1, axb)
    e_b_m = _sh(e_b, -1, axa)
    f_a_m = _sh(f_a, -1, axb)
    f_b_m = _sh(f_b, -1, axa)
    cc_mm = _sh(_sh(e_cc, -1, axa), -1, axb)
    cc_am = _sh(e_cc, -1, axa)
    cc_bm = _sh(e_cc, -1, axb)
    l_b = torch.where(f_a_m >= 0.0, e_b_m - cc_mm, e_b - cc_bm)
    r_b = torch.where(f_a >= 0.0, e_b_m - cc_am, e_b - e_cc)
    l_a = torch.where(f_b_m >= 0.0, e_a_m - cc_mm, e_a - cc_am)
    r_a = torch.where(f_b >= 0.0, e_a_m - cc_bm, e_a - e_cc)
    return 0.25 * (l_b + r_b + l_a + r_a + e_b_m + e_b + e_a_m + e_a)


def gr_cell_emfs(w, bcc, glower, gupper):
    """The GR cell-centred EMFs from the 4-velocity and the 4-field,
    (e1, e2, e3) = (b^2 u^3 - b^3 u^2, ...) (reference:
    mhd_corner_e.cpp:86-133, 243-293)."""
    uu, ul = four_velocity(w, glower, gupper)
    b = four_field(bcc, uu, ul)
    return (b[2] * uu[3] - b[3] * uu[2], b[3] * uu[1] - b[1] * uu[3],
            b[1] * uu[2] - b[2] * uu[1])


def corner_e(w, bcc, fden, emf, ndim: int, is_sr: bool = False,
             metric=None, ecc=None):
    """Edge EMFs by Gardiner-Stone (2005/07) upwinding (reference:
    src/mhd/mhd_corner_e.cpp).  ``fden`` holds the mass flux per direction
    ([nmb, n3, n2, n1]); returns cell-indexed e1, e2, e3.  SR primitives
    store u^i = gamma v^i, so under SR the transport velocity in
    E = -v x B is u^i / gamma (reference: mhd_corner_e.cpp:136-143);
    under GR (``metric`` the cell-centre (glower, gupper)) the cell EMFs
    are ``gr_cell_emfs``; ``ecc`` gives the cell EMFs (e1cc, e2cc, e3cc)
    from outside instead (dynamical GRMHD's transport velocity
    alpha v - beta, reference: mhd_corner_e.cpp ADM branch :66-84,
    218-240)."""
    if ndim == 1:
        e2 = emf["e2x1"]
        return torch.zeros_like(e2), e2, emf["e3x1"]
    if ecc is not None:
        e1cc, e2cc, e3cc = ecc
    elif metric is not None:
        e1cc, e2cc, e3cc = gr_cell_emfs(w, bcc, *metric)
    else:
        vx, vy, vz = w[:, IVX], w[:, IVY], w[:, IVZ]
        if is_sr:
            lor = torch.sqrt(1.0 + vx * vx + vy * vy + vz * vz)
            vx, vy, vz = vx / lor, vy / lor, vz / lor
        bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]
        e3cc = vy * bx - vx * by
        if ndim == 3:
            e1cc = vz * by - vy * bz
            e2cc = vx * bz - vz * bx
    e3 = _gs07(e3cc, emf["e3x1"], emf["e3x2"], fden["x1"], fden["x2"],
               IA, JA)
    if ndim == 2:
        return emf["e1x2"], emf["e2x1"], e3
    e1 = _gs07(e1cc, emf["e1x2"], emf["e1x3"], fden["x2"], fden["x3"],
               JA, KA)
    e2 = _gs07(e2cc, emf["e2x3"], emf["e2x1"], fden["x3"], fden["x1"],
               KA, IA)
    return e1, e2, e3


def _to_face(cell_arr, axis: int):
    """Extend a cell-indexed edge difference to face extent (+1) along
    ``axis`` by wrapping one slot (ghost data, refilled by the fill)."""
    return torch.cat([cell_arr, cell_arr.narrow(axis, 0, 1)], dim=axis)


def ct_update(bfc, bfc_old, e1, e2, e3, gam0, gam1, beta_dt, dxs,
              ndim: int):
    """Constrained-transport curl update (reference:
    src/mhd/mhd_ct.cpp:40-80); ``dxs`` maps x1/x2/x3 to the cell size."""
    b1 = gam0 * bfc["x1f"] + gam1 * bfc_old["x1f"]
    if ndim >= 2:
        de3 = (_sh(e3, 1, JA) - e3) / dxs["x2"]
        b1 = b1 - beta_dt * _to_face(de3, IA)
        if ndim == 3:
            de2 = (_sh(e2, 1, KA) - e2) / dxs["x3"]
            b1 = b1 + beta_dt * _to_face(de2, IA)
    b2 = gam0 * bfc["x2f"] + gam1 * bfc_old["x2f"]
    de3 = (_sh(e3, 1, IA) - e3) / dxs["x1"]
    b2 = b2 + beta_dt * _to_face(de3, JA)
    if ndim == 3:
        de1 = (_sh(e1, 1, KA) - e1) / dxs["x3"]
        b2 = b2 - beta_dt * _to_face(de1, JA)
    b3 = gam0 * bfc["x3f"] + gam1 * bfc_old["x3f"]
    de2 = (_sh(e2, 1, IA) - e2) / dxs["x1"]
    b3 = b3 - beta_dt * _to_face(de2, KA)
    if ndim >= 2:
        de1 = (_sh(e1, 1, JA) - e1) / dxs["x2"]
        b3 = b3 + beta_dt * _to_face(de1, KA)
    return {"x1f": b1, "x2f": b2, "x3f": b3}


def signal_speeds(eos: EOSData, w, bcc):
    """|v| + c_fast per direction (reference: src/mhd/mhd_newdt.cpp)."""
    d = w[:, IDN]
    p = eos.pressure(w[:, IEN]) if eos.is_ideal else None
    b1, b2, b3 = bcc[:, 0], bcc[:, 1], bcc[:, 2]
    return (torch.abs(w[:, IVX]) + eos.mhd_fast_speed(d, p, b1, b2, b3),
            torch.abs(w[:, IVY]) + eos.mhd_fast_speed(d, p, b2, b3, b1),
            torch.abs(w[:, IVZ]) + eos.mhd_fast_speed(d, p, b3, b1, b2))


def sr_signal_speeds(eos: EOSData, w, bcc):
    """max(|lambda_-|, lambda_+) per direction (reference: the SR branch
    of src/mhd/mhd_newdt.cpp)."""
    d = w[:, IDN]
    ux, uy, uz = w[:, IVX], w[:, IVY], w[:, IVZ]
    lor = torch.sqrt(1.0 + ux * ux + uy * uy + uz * uz)
    p = eos.pressure(w[:, IEN])
    # b^mu b_mu from the cell-centred field
    bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]
    b0 = bx * ux + by * uy + bz * uz
    b1 = (bx + b0 * ux) / lor
    b2 = (by + b0 * uy) / lor
    b3 = (bz + b0 * uz) / lor
    bsq = -b0 * b0 + b1 * b1 + b2 * b2 + b3 * b3
    out = []
    for uu in (ux, uy, uz):
        lp, lm = sr_mhd_fast_speeds(eos, d, p, uu, lor, bsq)
        out.append(torch.maximum(torch.abs(lm), lp))
    return tuple(out)


class MHD:
    """MHD configuration and the per-stage update on torch tensors."""

    # per-block tables read as the running cycle's rows (comm.LocalAttr):
    # the cell sizes of a refined mesh and the GR excision masks
    dxs = LocalAttr()
    dirs = LocalAttr()
    excise_mask = LocalAttr()
    fofc_excise_mask = LocalAttr()

    is_mhd = True

    def __init__(self, pin, mesh: Mesh, bvals: BoundaryValues,
                 device, dtype) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.device = torch.device(device)
        self.dtype = dtype
        self.coord = coord = Coordinates(pin)
        self.is_sr = coord.is_special_relativistic
        self.is_gr = coord.is_general_relativistic
        self.eos = EOSData.from_input(pin, "mhd")
        if (self.is_sr or self.is_gr) and not self.eos.is_ideal:
            raise ValueError("relativistic MHD requires the ideal-gas EOS")
        self.nmhd = self.eos.nfluid
        self.nscalars = pin.get_or_add_integer("mhd", "nscalars", 0)
        self.nvar = self.nmhd + self.nscalars
        self.recon_method = pin.get_or_add_string("mhd", "reconstruct",
                                                  "plm")
        if self.recon_method not in recon_ops.RECON_FNS:
            raise ValueError(f"mhd/reconstruct={self.recon_method} unknown")
        self.rsolver = pin.get_or_add_string("mhd", "rsolver", "llf")
        if self.is_sr:
            # SR runs map the solver names onto the SR variants
            # (reference: src/mhd/mhd.cpp solver dispatch)
            if self.rsolver not in SR_MHD_RSOLVER_FNS:
                raise ValueError(
                    f"mhd/rsolver={self.rsolver} not available in SR MHD")
            self._solve = SR_MHD_RSOLVER_FNS[self.rsolver]
        elif self.is_gr:
            if self.rsolver not in GR_MHD_RSOLVER_FNS:
                raise ValueError(
                    f"mhd/rsolver={self.rsolver} not available in GR MHD")
            self._solve = GR_MHD_RSOLVER_FNS[self.rsolver]
        else:
            if self.rsolver not in rsolvers_mhd.MHD_RSOLVER_FNS:
                raise ValueError(f"mhd/rsolver={self.rsolver} unknown")
            self._solve = rsolvers_mhd.MHD_RSOLVER_FNS[self.rsolver]
        ng_need = RECON_NGHOST[self.recon_method]
        if mesh.mb_indcs.ng < ng_need:
            raise ValueError(
                f"reconstruct={self.recon_method} requires nghost >= "
                f"{ng_need} but mesh/nghost={mesh.mb_indcs.ng}")
        # first-order flux correction (reference: src/mhd/mhd_fofc.cpp)
        self.use_fofc = pin.get_or_add_boolean("mhd", "fofc", False)
        # source terms of the <mhd_srcterms> block
        self.srcterms = SourceTerms("mhd_srcterms", pin, mesh, self.eos) \
            if pin.does_block_exist("mhd_srcterms") else None
        # test particles and the shearing box (reference: src/particles/,
        # src/shearing_box/shearing_box_fc.cpp, orbital_advection_fc.cpp)
        self.ppart = Particles(pin, mesh, device, dtype) \
            if pin.does_block_exist("particles") else None
        self.psbox = ShearingBox(pin, mesh, device, dtype) \
            if pin.does_block_exist("shearing_box") else None

        mbi = mesh.mb_indcs
        self.multilevel = mesh.multilevel
        if self.multilevel:
            bvals.prolong_prims = pin.get_or_add_boolean(
                "mesh_refinement", "prolong_primitives", False)
        if self.multilevel and (mbi.nx1 < 2 * mbi.ng or (
                mbi.nx2 > 1 and mbi.nx2 < 2 * mbi.ng)):
            raise ValueError("SMR requires meshblocks >= 2*nghost")
        n1, n2, n3 = mbi.ncells1, mbi.ncells2, mbi.ncells3
        self.fc_shapes = {
            "x1f": (mesh.nmb_total, n3, n2, n1 + 1),
            "x2f": (mesh.nmb_total, n3, n2 + 1, n1),
            "x3f": (mesh.nmb_total, n3 + 1, n2, n1),
        }
        # the cell size: a scalar on one level, per block on a refined
        # mesh ([nmb, 1, 1, 1] for the 4-D face and EMF arrays, with one
        # more axis in dirs for the 5-D cell arrays)
        ms = mesh.mesh_size
        if self.multilevel:
            self.dxs = {n: torch.as_tensor(
                mesh.mb_size[f"d{n}"], dtype=dtype,
                device=self.device).reshape(-1, 1, 1, 1)
                for n in ("x1", "x2", "x3")}
            dx5 = {n: d[..., None] for n, d in self.dxs.items()}
        else:
            self.dxs = {"x1": ms.dx1, "x2": ms.dx2, "x3": ms.dx3}
            dx5 = self.dxs
        self.dirs = [("x1", 4, IVX, dx5["x1"])]
        if mbi.nx2 > 1:
            self.dirs.append(("x2", 3, IVY, dx5["x2"]))
        if mbi.nx3 > 1:
            self.dirs.append(("x3", 2, IVZ, dx5["x3"]))
        self.time_evolution = pin.get_string("time", "evolution") \
            if pin.does_block_exist("time") else "dynamic"
        # turbulence driving (reference: src/srcterms/turb_driver.cpp),
        # applied by the driver once a cycle before the stages
        from ..turb_driver import TurbulenceDriver
        self.pturb = TurbulenceDriver(pin, mesh, self.device) \
            if pin.does_block_exist("turb_driving") else None
        # the metric, kept (GR), and the excision masks
        self.geom = GRGeometry(mesh, coord.coord_data, self.device, dtype,
                               faces=[d[0] for d in self.dirs]) \
            if self.is_gr else None
        self.excise_mask, self.fofc_excise_mask = \
            excision_masks(self.geom, mesh, self.device) if self.is_gr \
            else (None, None)
        # a problem generator's source-term hook, fn(u, w, beta_dt) -> u
        self.srcterms_func = None
        # diffusion, made only where a coefficient is given (reference:
        # src/mhd/mhd.cpp:103-131)
        self.pvisc = Viscosity("mhd", pin, mesh, self.eos, self.dxs) \
            if any(pin.does_parameter_exist("mhd", k)
                   for k in ("nu_iso", "nu_aniso")) else None
        self.presist = Resistivity(pin, mesh, self.eos, self.dxs) \
            if any(pin.does_parameter_exist("mhd", k)
                   for k in ("eta_ohm", "eta_ad")) else None
        self.pcond = Conduction("mhd", pin, mesh, self.eos, self.dxs) \
            if any(pin.does_parameter_exist("mhd", k)
                   for k in ("alpha_iso", "alpha_aniso", "alpha_spitzer")) \
            else None
        # self-gravity (reference: src/gravity/, src/multigrid/)
        self.pgrav = make_gravity(pin, mesh, self.device, dtype) \
            if pin.does_block_exist("gravity") else None

        use_kernels = pin.get_or_add_boolean("mhd", "use_kernels", True)
        from ..ops.flux import supports_flux_dir
        from ..ops.stage import supports_mega_stage, supports_mega_v2
        from ..ops.stage_split import (solver_for, supports_fused_ct,
                                       supports_fused_stage)
        self.use_mega_v2 = use_kernels and supports_mega_v2(self, mesh)
        self.use_mega_stage = (use_kernels and not self.use_mega_v2
                               and supports_mega_stage(self, mesh))
        self.use_fused_stage = (use_kernels and not self.use_mega_v2
                                and not self.use_mega_stage
                                and supports_fused_stage(self, mesh))
        self.use_fused_ct = use_kernels and supports_fused_ct(self, mesh)
        # kernel J: the fluxes of the general path
        self.use_flux_dir = (use_kernels and not self.use_mega_v2
                             and not self.use_mega_stage
                             and not self.use_fused_stage
                             and supports_flux_dir(self))
        self.stage_solver = solver_for(self)
        if not use_kernels:
            bvals.use_fill_kernel = False
            bvals.use_pool_fill = False

    def kernel_path(self, u) -> bool:
        """True when a stage on ``u`` runs the stage kernel A: its gate,
        re-checked for the hooks a problem generator installs after the
        physics is built (the JAX ``_mega_v2_active``)."""
        return (self.use_mega_v2 and self.srcterms_func is None
                and self.bvals.user_bc_func is None and kernel_dtype_ok(u))

    # ---------------------------------------------------------------- eos
    def compute_bcc(self, bfc):
        return compute_bcc(bfc)

    def cons_to_prim(self, u, bcc):
        if self.is_gr:
            cd = self.coord.coord_data
            gl, gu = self.geom.metric("cc")
            return cons_to_prim_gr_mhd(
                u, bcc, self.eos, gl, gu, excise_mask=self.excise_mask,
                dexcise=cd.dexcise, pexcise=cd.pexcise)
        if self.is_sr:
            return cons_to_prim_sr_mhd(u, bcc, self.eos)
        return cons_to_prim_mhd(u, bcc, self.eos)

    def prim_to_cons(self, w, bcc):
        if self.is_gr:
            return prim_to_cons_gr_mhd(w, bcc, self.eos,
                                       *self.geom.metric("cc"))
        if self.is_sr:
            return prim_to_cons_sr_mhd(w, bcc, self.eos)
        return prim_to_cons_mhd(w, bcc, self.eos)

    # ------------------------------------------------------------- fluxes
    def fluxes(self, w, bcc, bfc):
        """Per-direction fluxes and face EMFs with the deck's solver (the
        SR one under SR).  Kernel J forms them on the card in float32 where
        its gate admits the deck, with the face-state floors of the JAX
        package's ``pallas_flux`` route; elsewhere face-state floors only
        for ppmx, wenoz and teno, as on the JAX package's general path.
        The viscous, conductive and resistive fluxes are added after
        either (the JAX package's ``pallas_flux`` route leaves them out,
        ROADMAP F16)."""
        if self.use_flux_dir and kernel_dtype_ok(w):
            from ..ops.flux import fused_flux_dir
            flx, emf = {}, {}
            for name, _axis, ivx, _dx in self.dirs:
                f, ey, ez = fused_flux_dir(w, bcc, bfc[f"{name}f"],
                                           self.eos, name, ivx)
                flx[name] = f
                emf[EY_NAME[name]] = ey
                emf[EZ_NAME[name]] = ez
        else:
            flx, emf = face_fluxes(
                w, bcc, bfc, self.eos, self._solve, self.dirs,
                rec=recon_ops.RECON_FNS[self.recon_method],
                floors=self.recon_method in recon_ops.FLOORED_METHODS,
                face_metric=self.geom.metric if self.is_gr else None)
        if self.pvisc is not None:
            flx = self.pvisc.add_viscous_flux(w, flx, self.dirs)
        if self.pcond is not None:
            flx = self.pcond.add_heat_flux(w, flx, self.dirs)
        if self.presist is not None:
            flx = self.presist.add_resistive_flux(bfc, bcc, flx, self.dirs,
                                                  len(self.dirs))
        return flx, emf

    def rk_update(self, u0, u1, flx, gam0, gam1, beta_dt):
        return rk_update(u0, u1, flx, gam0, gam1, beta_dt, self.dirs)

    def _apply_fofc(self, u, u1, w, bcc, bfc, flx, emf, gam0, gam1,
                    beta_dt):
        """First-order flux correction (reference: MHD::FOFC,
        src/mhd/mhd_fofc.cpp): the cells whose trial update floors or
        fails in c2p (and under GR with excision the cells around the
        horizon) are flagged as in ``Hydro._apply_fofc``, and the faces
        on either side of a flagged cell take first-order LLF fluxes and
        face EMFs (the SR or GR LLF under SR or GR).  Returns
        (flx, emf, nfofc)."""
        c2p = (lambda ut: self.cons_to_prim(ut, bcc)[1]) if self.use_fofc \
            else None
        masks, nfofc = fofc_faces(c2p, u, u1, flx, gam0, gam1, beta_dt,
                                  self.dirs, excise=self.fofc_excise_mask)
        first_order = llf_grmhd if self.is_gr else \
            llf_srmhd if self.is_sr else rsolvers_mhd.llf
        bface = {"x1": bfc["x1f"][..., :-1],
                 "x2": bfc["x2f"][..., :-1, :],
                 "x3": bfc["x3f"][..., :-1, :, :]}
        out_f, out_e = dict(flx), dict(emf)
        for name, axis, ivx, _dx in self.dirs:
            wl = torch.roll(w, 1, dims=axis)   # cell i-1 at face i
            bl = torch.roll(bcc, 1, dims=axis)
            extra = self.geom.metric(name) if self.is_gr else ()
            f1, ey1, ez1 = first_order(wl, w, bl, bcc, bface[name],
                                       self.eos, ivx, *extra)
            f1 = scalar_fluxes(f1, wl, w, self.nmhd)
            fmask = masks[name]
            out_f[name] = torch.where(fmask.unsqueeze(1), f1, out_f[name])
            for key, e1 in ((EY_NAME[name], ey1), (EZ_NAME[name], ez1)):
                out_e[key] = torch.where(fmask, e1, out_e[key])
        return out_f, out_e, nfofc

    def corner_e(self, w, bcc, fden, emf, bfc=None, ecc=None):
        """The corner EMFs plus the resistive ones from the face field
        ``bfc`` (reference: Resistivity::AddResistiveEMFs, called from
        CornerE); ``ecc`` the cell EMFs given from outside."""
        e1, e2, e3 = corner_e(w, bcc, fden, emf, len(self.dirs),
                              is_sr=self.is_sr,
                              metric=self.geom.metric("cc") if self.is_gr
                              and ecc is None else None, ecc=ecc)
        if self.presist is None:
            return e1, e2, e3
        return self.presist.add_resistive_emf(bfc, bcc, e1, e2, e3,
                                              len(self.dirs))

    def _user_srcs(self, u, w, beta_dt, bcc, t=None):
        """The problem generator's source-term hook (the JAX
        ``_user_srcs``): a function with ``needs_bcc`` takes the cell
        field, one with ``needs_time`` the time (reference: user sources
        receive (Mesh*, time, dt); disk-magnetosphere.cpp)."""
        kw = {}
        if getattr(self.srcterms_func, "needs_bcc", False):
            kw["bcc"] = bcc
        if getattr(self.srcterms_func, "needs_time", False):
            kw["t"] = t
        return self.srcterms_func(u, w, beta_dt, **kw)

    def ct_update(self, bfc, bfc_old, e1, e2, e3, gam0, gam1, beta_dt):
        return ct_update(bfc, bfc_old, e1, e2, e3, gam0, gam1, beta_dt,
                         self.dxs, len(self.dirs))

    # ----------------------------------------------------- face-field halo
    def fill_ghosts_fc(self, bfc):
        """Halo exchange + physical BCs for the staggered field, in place
        (reference: src/bvals/bvals_fc.cpp).  On the normal axis of each
        component the shared face is owned by both blocks, so only the ng
        faces beyond it are exchanged."""
        bv = self.bvals
        if bv.use_fill_kernel and kernel_dtype_ok(bfc["x1f"]):
            from ..ops.fill import periodic_fill_fc
            return periodic_fill_fc(bfc)
        if bv.pool_fill_active(bfc["x1f"]):
            from ..ops.pool_fill import pool_fill_fc
            return pool_fill_fc(bfc, bv.nbr27(bfc["x1f"].device),
                                self.mesh)
        mbi = self.mesh.mb_indcs
        ng = mbi.ng
        nx_of = {"x1": mbi.nx1, "x2": mbi.nx2, "x3": mbi.nx3}
        # a refined mesh sweeps twice, like the cell-centred fill, and
        # then fills the edge and corner patches from diagonal donors
        for _ in range(2 if self.multilevel else 1):
            for ax in bv.active_axes:
                self._sweep_fc(bfc, ax, ng, nx_of[ax])
        if self.multilevel:
            mhd_smr.fc_fill_corners(self.mesh, bv.active_axes, bfc)
        return bfc

    def _sweep_fc(self, bfc, ax: str, ng: int, nxa: int) -> None:
        """One axis sweep of the face-field fill, in place."""
        bv = self.bvals
        axis4 = _AXIS_OF[ax] - 1
        for comp, arr in bfc.items():
            # the mixed-level overrides read their donors from the
            # array as it stood before the sweep
            src = mhd_smr.DonorBands(arr, axis4, ng) \
                if self.multilevel else None
            n = arr.shape[axis4]
            if comp == f"{ax}f":
                src_m, src_p = (nxa, ng + 1)
                dst_p = ng + nxa + 1
            else:
                src_m, src_p = (n - 2 * ng, ng)
                dst_p = n - ng
            donor_m = self.mesh.tables.gather(arr.narrow(axis4, src_m, ng),
                                    bv.nbr[f"{ax}m"]).clone()
            donor_p = self.mesh.tables.gather(arr.narrow(axis4, src_p, ng),
                                    bv.nbr[f"{ax}p"]).clone()
            arr.narrow(axis4, 0, ng).copy_(donor_m)
            arr.narrow(axis4, dst_p, ng).copy_(donor_p)
            if src is not None:
                mhd_smr.ml_fc_override(self.mesh, bv.active_axes, arr,
                                       src, ax, comp)
        self._phys_bc_fc(bfc, ax)

    def _phys_bc_fc(self, bfc, ax: str) -> None:
        """Physical BCs for the face field, in place (reference:
        src/bvals/physics/bfield_bcs.cpp:81-155)."""
        bv = self.bvals
        ng = self.mesh.mb_indcs.ng
        axis4 = _AXIS_OF[ax] - 1
        for side in ("m", "p"):
            key = f"{ax}{side}"
            flag = bv.flag[key]
            # a user side keeps the gathered faces, as the JAX package's
            if not bv.any_phys[key] or flag in ("periodic",
                                                "shear_periodic", "user"):
                continue
            for comp, arr in bfc.items():
                mask = bv.local_mask(key, 4, arr.device)
                n = arr.shape[axis4]
                normal = comp == f"{ax}f"
                g0 = 0 if side == "m" else n - ng
                ghost = arr.narrow(axis4, g0, ng)
                if flag in ("outflow", "diode", "vacuum"):
                    e0 = ng if side == "m" else n - ng - 1
                    bc = arr.narrow(axis4, e0, 1).expand(ghost.shape)
                else:  # reflect
                    if side == "m":
                        s0 = ng + 1 if normal else ng
                    else:
                        s0 = n - 2 * ng - 1 if normal else n - 2 * ng
                    bc = torch.flip(arr.narrow(axis4, s0, ng), (axis4,))
                    if normal:
                        bc = -bc
                ghost.copy_(torch.where(mask, bc, ghost))

    # ---------------------------------------------------------------- dt
    def new_dt(self, w, bcc):
        """min dx / (|v| + c_fast) over the interior (reference:
        src/mhd/mhd_newdt.cpp)."""
        mbi = self.mesh.mb_indcs
        sl = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
              slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
        wa, ba = w[sl], bcc[sl]
        if self.time_evolution == "kinematic":
            dv = (torch.abs(wa[:, IVX]), torch.abs(wa[:, IVY]),
                  torch.abs(wa[:, IVZ]))
        elif self.is_gr:
            # light speed bounds every signal (reference: mhd_newdt.cpp)
            dv = (torch.ones_like(wa[:, IVX]),) * 3
        elif self.is_sr:
            dv = sr_signal_speeds(self.eos, wa, ba)
        else:
            dv = signal_speeds(self.eos, wa, ba)
        dt = torch.min(self.dxs["x1"] / dv[0])
        if mbi.nx2 > 1:
            dt = torch.minimum(dt, torch.min(self.dxs["x2"] / dv[1]))
        if mbi.nx3 > 1:
            dt = torch.minimum(dt, torch.min(self.dxs["x3"] / dv[2]))
        return dt

    # ------------------------------------------------ state-dict interface
    def make_state(self, u, w, bfc, bcc=None):
        state = {"u": u, "w": w, "bfc": bfc,
                 "bcc": bcc if bcc is not None else compute_bcc(bfc)}
        if self.pturb is not None:
            state.update(self.pturb.init_state_entries(u.dtype))
        if self.ppart is not None:
            state.update(self.ppart.init_state_entries(u.dtype))
        if self.psbox is not None:
            state["t"] = torch.zeros((), dtype=u.dtype, device=u.device)
        if isinstance(self.pgrav, MGPoisson):
            # the multigrid's starting guess, carried from stage to stage
            state["phi"] = torch.zeros((u.shape[0], 1) + u.shape[2:],
                                       dtype=u.dtype, device=u.device)
        return state

    def save_state(self, state):
        return {"u1": state["u"], "bfc1": state["bfc"]}

    def accumulate_rk4(self, saved, state, delta):
        """The 2S register of RK4()4[2S] (the driver calls it before
        every stage after the first): u1 + delta u, and each face array
        alike."""
        return {"u1": saved["u1"] + delta * state["u"],
                "bfc1": {k: saved["bfc1"][k] + delta * state["bfc"][k]
                         for k in saved["bfc1"]}}

    def _fill_and_prims(self, state):
        """Fill the ghosts of (u, bfc), then bcc and c2p."""
        u = self.bvals.fill_ghosts(state["u"])
        bfc = self.fill_ghosts_fc(state["bfc"])
        bcc = compute_bcc(bfc)
        w, u, _ = self.cons_to_prim(u, bcc)
        return dict(state, u=u, w=w, bfc=bfc, bcc=bcc)

    def unpack_state(self, state):
        """Materialise w/bcc for outputs when the kernel path carries only
        (u, bfc)."""
        return state if "w" in state else self._fill_and_prims(state)

    def init_ghosts(self, state):
        out = self._fill_and_prims(state)
        if self.bvals.prolong_prims:
            bcc = out["bcc"]
            u, w = self.bvals.prolong_prims_fixup(
                out["u"], out["w"], lambda w2: self.prim_to_cons(w2, bcc))
            out = dict(out, u=u, w=w)
        if self.kernel_path(out["u"]):
            # the stage kernel computes primitives itself; the cycle state
            # carries only (u, bfc)
            del out["w"], out["bcc"]
        return out

    def restart_ghosts(self, state):
        """The state of a resumed run: ``init_ghosts``, but under GR the
        stored state as it is (see ``Hydro.restart_ghosts``)."""
        if self.is_gr and "w" in state and "bcc" in state:
            return state
        return self.init_ghosts(state)

    def stage_route(self, u) -> str:
        """The route a stage on ``u`` takes: "A" (kernel A), "E" (the v1
        route), "C" (the split stage) or "general".  Kernel A's gate
        admits E's too: a hook that closes A at run time leaves the stage
        to E, as in the JAX package's route order (``mhd.py:1577-1640``)."""
        if self.kernel_path(u):
            return "A"
        on_card = kernel_dtype_ok(u)
        if (self.use_mega_stage or self.use_mega_v2) and on_card:
            return "E"
        if self.use_fused_stage and on_card:
            return "C"
        return "general"

    def aux_route(self, u) -> str:
        """How the v1 route fills u and takes its primitives: "F" (kernel
        F with the periodic wrap), "G+F" (the pool's fill, then F) or
        "general"; a user boundary function closes both kernel routes
        (the JAX ``mhd.py:1601-1610``).  On one rank's blocks of a group
        the pool's fill is the exchange (G closes) and F still takes the
        primitives: F without its wrap is pointwise, so each rank's run
        stays bitwise the one-rank run."""
        bv = self.bvals
        if bv.user_bc_func is not None:
            return "general"
        if bv.use_fill_kernel:
            return "F"
        if bv.pool_route(u):
            return "G+F"
        return "general"

    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        """One RK stage (reference task chain mhd_tasks.cpp:48-81)."""
        route = self.stage_route(state["u"])
        if route == "A":
            from ..ops.stage import mega_stage_v2
            u, bfc, counters = mega_stage_v2(
                state["u"], state["bfc"], saved["u1"], saved["bfc1"],
                self.eos, gam0, gam1, beta_dt, self.dxs)
            if self.time_evolution != "dynamic":
                counters.pop("dtmin")
            bfc = self.fill_ghosts_fc(bfc)
            u = self.bvals.fill_ghosts(u)
            return dict(state, u=u, bfc=bfc), counters
        u, w, bfc, bcc = state["u"], state["w"], state["bfc"], state["bcc"]
        on_card = kernel_dtype_ok(u)
        do_fofc = self.use_fofc or self.fofc_excise_mask is not None
        phi = None
        if route == "E":
            return self._stage_v1(state, saved, gam0, gam1, beta_dt)
        if route == "C":
            # kernel C: the 5-channel fluxes stay in the kernel's shared
            # memory; only the mass flux and the face EMFs come back
            from ..ops.stage_split import fused_stage3d
            u, fden, emf = fused_stage3d(
                w, bcc, bfc, u, saved["u1"], self.eos, gam0, gam1,
                beta_dt, self.dxs, self.stage_solver)
            if self.srcterms_func is not None:
                u = self._user_srcs(u, w, beta_dt, bcc, t=state.get("t"))
        else:
            flx, emf = self.fluxes(w, bcc, bfc)
            if do_fofc:
                flx, emf, nfofc = self._apply_fofc(
                    u, saved["u1"], w, bcc, bfc, flx, emf, gam0, gam1,
                    beta_dt)
            if self.multilevel:
                flx = flux_correct_cc(flx, self.mesh,
                                      [d[0] for d in self.dirs])
            # the potential of the stage's state, before the update
            # (reference: driver.cpp:406-408)
            if self.pgrav is not None:
                phi = self.pgrav.solve(u, self.bvals,
                                       phi0=state.get("phi"))
            u = self.rk_update(u, saved["u1"], flx, gam0, gam1, beta_dt)
            if self.is_gr:
                u = coord_src_terms(u, w, self.eos, self.geom, beta_dt,
                                    bcc=bcc)
            if self.srcterms is not None and self.srcterms.any_enabled:
                u = self.srcterms.apply(u, w, beta_dt, flx=flx, phi=phi)
            if self.psbox is not None:
                u = self.psbox.src_terms(u, w, beta_dt, self.eos.is_ideal,
                                         bcc=bcc)
            if self.srcterms_func is not None:
                u = self._user_srcs(u, w, beta_dt, bcc, t=state.get("t"))
            # kernel D and corner_e read the corrected mass flux
            fden = {n: flx[n][:, IDN] for n in flx}
        if self.use_fused_ct and on_card:
            # kernel D: corner EMFs + CT (reference: mhd.py:1638-1642,
            # 1680-1686 of the JAX package)
            from ..ops.stage_split import fused_ct3d
            bfc = fused_ct3d(
                w, bcc, {n: f.contiguous() for n, f in fden.items()},
                {n: e.contiguous() for n, e in emf.items()}, bfc,
                saved["bfc1"], gam0, gam1, beta_dt, self.dxs,
                is_sr=self.is_sr)
        else:
            e1, e2, e3 = self.corner_e(w, bcc, fden, emf, bfc)
            if self.multilevel:
                e1, e2, e3 = mhd_smr.emf_correct(
                    self.mesh, self.bvals.active_axes, e1, e2, e3)
            if self.psbox is not None and not self.psbox.oa_active:
                # the 2-D r-z box: the orbital EMF as a source
                e1, e2 = self.psbox.src_terms_fc(e1, e2, bfc)
            bfc = self.ct_update(bfc, saved["bfc1"], e1, e2, e3,
                                 gam0, gam1, beta_dt)
        u = self.bvals.fill_ghosts(u)
        bfc = self.fill_ghosts_fc(bfc)
        if self.psbox is not None:
            u = self.psbox.remap_ghosts(u, state["t"])
            bfc = self.psbox.remap_ghosts_fc(bfc, state["t"])
        bcc = compute_bcc(bfc)
        w, u, counters = self.cons_to_prim(u, bcc)
        if self.bvals.prolong_prims:
            u, w = self.bvals.prolong_prims_fixup(
                u, w, lambda w2: self.prim_to_cons(w2, bcc))
        if do_fofc:
            counters = dict(counters, nfofc=nfofc)
        out = dict(state, u=u, w=w, bfc=bfc, bcc=bcc)
        if phi is not None and "phi" in state:
            out["phi"] = phi
        return out, counters

    def _stage_v1(self, state, saved, gam0, gam1, beta_dt):
        """The v1 stage route (JAX ``mhd.py:1586-1625``): kernel E from
        the state's primitives, the source-term hook, the face fill, then
        kernel F.  A single periodic block takes F with its periodic wrap;
        a pool takes the pool fill of u and F without it; any other mesh,
        or a user boundary function, the general fill, bcc and c2p.  F's
        new-dt maxima ride along in dynamic runs without particles."""
        from ..ops.aux import fused_aux3d
        from ..ops.stage_v1 import fused_mega_stage3d
        bv = self.bvals
        u, bfc = fused_mega_stage3d(
            state["w"], state["bcc"], state["bfc"], state["u"], saved["u1"],
            saved["bfc1"], self.eos, gam0, gam1, beta_dt, self.dxs)
        if self.srcterms_func is not None:
            u = self._user_srcs(u, state["w"], beta_dt, state["bcc"],
                                t=state.get("t"))
        bfc = self.fill_ghosts_fc(bfc)
        # no new-dt maxima under particles, whose crossing time bounds dt
        # in dt_from_state (the JAX ``fuse_dt``)
        dxs = self.dxs if (self.time_evolution == "dynamic"
                           and self.ppart is None) else None
        aux = self.aux_route(u)
        if aux == "F":
            u, w, bcc, counters = fused_aux3d(u, bfc, self.eos, dxs=dxs)
        elif aux == "G+F":
            u = bv.fill_ghosts(u)
            u, w, bcc, counters = fused_aux3d(u, bfc, self.eos, dxs=dxs,
                                              wrap=False)
        else:
            u = bv.fill_ghosts(u)
            bcc = compute_bcc(bfc)
            w, u, counters = self.cons_to_prim(u, bcc)
        return dict(state, u=u, w=w, bfc=bfc, bcc=bcc), counters

    def dt_from_state(self, state):
        if "w" not in state:
            state = self.unpack_state(state)
        dt = self.new_dt(state["w"], state["bcc"])
        ndim = len(self.dirs)
        if self.pvisc is not None:
            dt = torch.minimum(dt, self.pvisc.new_dt(ndim, dt))
        if self.pcond is not None:
            dt = torch.minimum(dt, self.pcond.new_dt(ndim, dt))
        if self.presist is not None:
            dt = torch.minimum(dt, self.presist.new_dt(state["bcc"], ndim,
                                                       dt))
        if self.srcterms is not None and self.srcterms.any_enabled:
            dt = torch.minimum(dt, self.srcterms.new_dt(state["w"]))
        if self.ppart is not None:
            dt = torch.minimum(dt, torch.tensor(
                self.ppart.new_dt(), dtype=dt.dtype, device=dt.device))
        return dt
