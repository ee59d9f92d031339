"""Hydrodynamics, Newtonian, special- or general-relativistic.

Counterpart of ``athenak_tpu/physics/hydro.py`` (reference:
src/hydro/hydro.hpp:67-158, hydro_tasks.cpp:48-80, hydro_fluxes.cpp,
hydro_fofc.cpp, hydro_update.cpp, hydro_newdt.cpp).  The task list
(copyu -> flux -> fofc -> rkupdate -> srcterms -> sendu/recvu -> bcs ->
c2p -> newdt) collapses into ``stage_update``, one function per RK stage
on torch tensors.  The conserved ``u`` and the primitive ``w`` are
``[nmb, nvar, n3, n2, n1]`` (ghosts included); the primitives store the
internal energy in the IEN slot (under SR: rho, u^i = gamma v^i, e).

The JAX package has no stage kernel for hydro, so the stage runs in
torch ops on every device.  Only the ghost fills take kernels on the
card in float32: kernel B on a single fully periodic 3-D block with two
ghost cells, kernel G on a same-level periodic pool (the fills of
``bvals.py``).  ``<hydro>/use_kernels = false`` keeps a run on the
sweep fills, for comparison.  On a refined mesh (static, or adaptive
once refined) the stage adds the flux correction after the fluxes
(``refinement.flux_correct_cc``) and the fills take the mixed-level
paths; with ``<mesh_refinement>/prolong_primitives`` the ghosts are
prolonged in primitive variables after every c2p
(``bvals.prolong_prims_fixup``).  Driven turbulence
(``<turb_driving>``) carries ``turb_force`` in the state; the driver
applies the forcing once a cycle before the stages.  First-order flux
correction (``<hydro>/fofc``) replaces the fluxes on the faces of cells
whose trial update would floor with first-order LLF fluxes, and
``<hydro_srcterms>`` adds its source terms after the RK update.
Viscosity and thermal conduction (``<hydro>/nu_iso``, ``alpha_iso``;
``diffusion.py``) add their fluxes into the Godunov fluxes, before FOFC
and the flux correction, and bound dt.  Self-gravity (``<gravity>``;
``gravity.py``, ``multigrid.py``) solves for the potential from the
stage's state before the RK update, and ``<hydro_srcterms>/self_gravity``
applies it; a multigrid run carries the potential in ``state["phi"]``,
the next solve's starting guess.

GR (``<coord>/general_rel``) runs on the fixed Cartesian Kerr-Schild
metric of ``coordinates.GRGeometry``, computed once: the GR solvers take
the face metric, the c2p the cell-centre one with the Lorentz ceiling
and the horizon excision, the stage adds the coordinate source terms
after the RK update, the faces around the horizon always take
first-order fluxes (the flux-excision mask, with or without
``<hydro>/fofc``) and dt is bounded by the speed of light.  A problem
generator may enroll ``srcterms_func(u, w, beta_dt[, t=])``, called
after the source terms (``needs_time``: the time the state carries in
``t``).

Test particles (``<particles>``, ``particles.py``) carry ``prtcl_x`` and
``prtcl_v`` in the state; the driver pushes them once a cycle and their
cell-crossing time bounds dt.  The shearing box (``<shearing_box>``,
``shearing_box.py``) carries the time ``t``; its Coriolis and tidal
terms follow the ``<hydro_srcterms>``, its sheared x1 ghosts are remapped
after every fill, and the driver advects the orbits once a cycle.
Neither has a kernel; the fills keep theirs where the boundaries admit
them (a ``shear_periodic`` side closes B and G, as in the JAX package).
"""

from __future__ import annotations

import torch

from ..bvals import BoundaryValues
from ..diffusion import Conduction, Viscosity
from ..gravity import make_gravity
from ..multigrid import MGPoisson
from ..comm import LocalAttr
from ..coordinates import Coordinates, GRGeometry, excision_masks
from ..indices import IDN, IEN, IVX, IVY, IVZ, RECON_NGHOST
from ..mesh import Mesh
from ..ops import recon as recon_ops
from ..ops import rsolvers
from ..ops.eos import EOSData, cons_to_prim_hydro, prim_to_cons_hydro
from ..ops.eos_gr import (coord_src_terms, cons_to_prim_gr_hydro,
                          prim_to_cons_gr_hydro)
from ..ops.eos_sr import (cons_to_prim_sr_hydro, prim_to_cons_sr_hydro,
                          sr_hydro_sound_speeds)
from ..ops.fluid import face_floors, fofc_faces, rk_update, scalar_fluxes
from ..ops.rsolvers_gr import GR_HYDRO_RSOLVER_FNS, llf_gr
from ..ops.rsolvers_sr import SR_HYDRO_RSOLVER_FNS, llf_sr
from ..particles import Particles
from ..refinement import flux_correct_cc
from ..shearing_box import ShearingBox
from ..srcterms import SourceTerms


class Hydro:
    """Hydro configuration and the per-stage update on torch tensors."""

    # per-block tables read as the running cycle's rows (comm.LocalAttr):
    # the cell sizes of a refined mesh and the GR excision masks
    dxs = LocalAttr()
    dirs = LocalAttr()
    excise_mask = LocalAttr()
    fofc_excise_mask = LocalAttr()

    is_mhd = False

    def __init__(self, pin, mesh: Mesh, bvals: BoundaryValues,
                 device, dtype) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.device = torch.device(device)
        self.dtype = dtype
        self.coord = coord = Coordinates(pin)
        self.is_sr = coord.is_special_relativistic
        self.is_gr = coord.is_general_relativistic
        self.eos = EOSData.from_input(pin, "hydro")
        if (self.is_sr or self.is_gr) and not self.eos.is_ideal:
            raise ValueError("relativistic hydro requires the ideal-gas EOS")
        self.nhydro = self.eos.nfluid
        self.nscalars = pin.get_or_add_integer("hydro", "nscalars", 0)
        self.nvar = self.nhydro + self.nscalars

        self.recon_method = pin.get_or_add_string("hydro", "reconstruct",
                                                  "plm")
        if self.recon_method not in recon_ops.RECON_FNS:
            raise ValueError(
                f"hydro/reconstruct={self.recon_method} unknown")
        self.rsolver = pin.get_or_add_string("hydro", "rsolver", "llf")
        if self.is_sr:
            # SR runs map the solver names onto their SR variants
            # (reference: src/hydro/hydro.cpp:207-230)
            if self.rsolver not in SR_HYDRO_RSOLVER_FNS:
                raise ValueError(
                    f"hydro/rsolver={self.rsolver} not available in SR")
            self._solve = SR_HYDRO_RSOLVER_FNS[self.rsolver]
        elif self.is_gr:
            if self.rsolver not in GR_HYDRO_RSOLVER_FNS:
                raise ValueError(
                    f"hydro/rsolver={self.rsolver} not available in GR")
            self._solve = GR_HYDRO_RSOLVER_FNS[self.rsolver]
        else:
            if self.rsolver not in rsolvers.HYDRO_RSOLVER_FNS:
                raise ValueError(f"hydro/rsolver={self.rsolver} unknown")
            self._solve = rsolvers.HYDRO_RSOLVER_FNS[self.rsolver]
        ng_need = RECON_NGHOST[self.recon_method]
        if mesh.mb_indcs.ng < ng_need:
            raise ValueError(
                f"reconstruct={self.recon_method} requires nghost >= "
                f"{ng_need} but mesh/nghost={mesh.mb_indcs.ng}")
        # first-order flux correction (reference: src/hydro/hydro_fofc.cpp)
        self.use_fofc = pin.get_or_add_boolean("hydro", "fofc", False)
        # source terms of the <hydro_srcterms> block (reference:
        # src/srcterms/srcterms.cpp:37-80)
        self.srcterms = SourceTerms("hydro_srcterms", pin, mesh, self.eos) \
            if pin.does_block_exist("hydro_srcterms") else None
        # test particles and the shearing box (reference: src/particles/,
        # src/shearing_box/)
        self.ppart = Particles(pin, mesh, device, dtype) \
            if pin.does_block_exist("particles") else None
        self.psbox = ShearingBox(pin, mesh, device, dtype) \
            if pin.does_block_exist("shearing_box") else None

        mbi = mesh.mb_indcs
        self.shape = (mesh.nmb_total, self.nvar, mbi.ncells3, mbi.ncells2,
                      mbi.ncells1)
        # the cell size: a scalar on one level, per block on a refined
        # mesh ([nmb, 1, 1, 1] for new_dt, one more axis in dirs)
        self.multilevel = mesh.multilevel
        if self.multilevel:
            bvals.prolong_prims = pin.get_or_add_boolean(
                "mesh_refinement", "prolong_primitives", False)
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
        # diffusion, made only where a coefficient is given (reference:
        # src/hydro/hydro.cpp:77-96)
        self.pvisc = Viscosity("hydro", pin, mesh, self.eos, self.dxs) \
            if any(pin.does_parameter_exist("hydro", k)
                   for k in ("nu_iso", "nu_aniso")) else None
        self.pcond = Conduction("hydro", pin, mesh, self.eos, self.dxs) \
            if any(pin.does_parameter_exist("hydro", k)
                   for k in ("alpha_iso", "alpha_aniso", "alpha_spitzer")) \
            else None
        # self-gravity (reference: src/gravity/, src/multigrid/)
        self.pgrav = make_gravity(pin, mesh, self.device, dtype) \
            if pin.does_block_exist("gravity") else None
        # the metric, kept (GR), and the excision masks
        self.geom = GRGeometry(mesh, coord.coord_data, self.device, dtype,
                               faces=[d[0] for d in self.dirs]) \
            if self.is_gr else None
        self.excise_mask, self.fofc_excise_mask = \
            excision_masks(self.geom, mesh, self.device) if self.is_gr \
            else (None, None)
        # a problem generator's source-term hook, fn(u, w, beta_dt) -> u
        self.srcterms_func = None
        # turbulence driving (reference: src/srcterms/turb_driver.cpp),
        # applied by the driver once a cycle before the stages
        from ..turb_driver import TurbulenceDriver
        self.pturb = TurbulenceDriver(pin, mesh, self.device) \
            if pin.does_block_exist("turb_driving") else None

        # the only kernels of a hydro run are the fills' (B, G)
        if not pin.get_or_add_boolean("hydro", "use_kernels", True):
            bvals.use_fill_kernel = False
            bvals.use_pool_fill = False

    # ------------------------------------------------------------- allocate
    def allocate(self, dtype):
        u = torch.zeros(self.shape, dtype=dtype, device=self.device)
        return u, torch.zeros_like(u)

    # ------------------------------------------------------------------ eos
    def cons_to_prim(self, u):
        if self.is_gr:
            cd = self.coord.coord_data
            gl, gu = self.geom.metric("cc")
            return cons_to_prim_gr_hydro(
                u, self.eos, gl, gu, excise_mask=self.excise_mask,
                dexcise=cd.dexcise, pexcise=cd.pexcise)
        if self.is_sr:
            return cons_to_prim_sr_hydro(u, self.eos)
        return cons_to_prim_hydro(u, self.eos)

    def prim_to_cons(self, w):
        if self.is_gr:
            return prim_to_cons_gr_hydro(w, self.eos,
                                         *self.geom.metric("cc"))
        if self.is_sr:
            return prim_to_cons_sr_hydro(w, self.eos)
        return prim_to_cons_hydro(w, self.eos)

    # --------------------------------------------------------------- fluxes
    def fluxes(self, w):
        """Reconstruct and solve in each active direction; entry i of a
        flux holds the flux through the lower face of cell i (reference:
        src/hydro/hydro_fluxes.cpp:78-120).  The face states of ppmx,
        wenoz and teno are floored; passive scalars take the upwind flux
        on the mass flux."""
        rec = recon_ops.RECON_FNS[self.recon_method]
        floors = self.recon_method in recon_ops.FLOORED_METHODS
        out = {}
        for name, axis, ivx, _dx in self.dirs:
            wl, wr = rec(w, axis)
            if floors:
                wl, wr = face_floors(wl, self.eos), face_floors(wr, self.eos)
            f = self._solve(wl, wr, self.eos, ivx, *self._face_metric(name))
            out[name] = scalar_fluxes(f, wl, wr, self.nhydro)
        if self.pvisc is not None:
            out = self.pvisc.add_viscous_flux(w, out, self.dirs)
        if self.pcond is not None:
            out = self.pcond.add_heat_flux(w, out, self.dirs)
        return out

    def _face_metric(self, name: str):
        """The solvers' extra arguments: the face metric under GR."""
        return self.geom.metric(name) if self.is_gr else ()

    def rk_update(self, u0, u1, flx, gam0, gam1, beta_dt):
        """gam0 * u0 + gam1 * u1 - beta_dt * div(F) over the whole array
        (reference: src/hydro/hydro_update.cpp:52-80); the ghosts are
        refilled right after."""
        return rk_update(u0, u1, flx, gam0, gam1, beta_dt, self.dirs)

    # ----------------------------------------------------------------- FOFC
    def _apply_fofc(self, u, u1, w, flx, gam0, gam1, beta_dt):
        """First-order flux correction (reference: Hydro::FOFC,
        src/hydro/hydro_fofc.cpp:30-200): a trial update and c2p flag the
        cells where a floor fired or the root find failed (``u_fixed``
        differs from the trial state), under GR with excision also the
        cells around the horizon, and the faces on either side of a
        flagged cell take first-order LLF fluxes from the cell-centred
        primitives.  Returns (flx, nfofc)."""
        c2p = (lambda ut: self.cons_to_prim(ut)[1]) if self.use_fofc \
            else None
        masks, nfofc = fofc_faces(c2p, u, u1, flx, gam0, gam1, beta_dt,
                                  self.dirs, excise=self.fofc_excise_mask)
        first_order = llf_gr if self.is_gr else \
            llf_sr if self.is_sr else rsolvers.llf
        out = dict(flx)
        for name, axis, ivx, _dx in self.dirs:
            wl = torch.roll(w, 1, dims=axis)   # cell i-1 at face i
            f1 = scalar_fluxes(first_order(wl, w, self.eos, ivx,
                                           *self._face_metric(name)),
                               wl, w, self.nhydro)
            out[name] = torch.where(masks[name].unsqueeze(1), f1, out[name])
        return out, nfofc

    # ---------------------------------------------------------------- newdt
    def new_dt(self, w):
        """min over the interior of dx / (|v| + c_s) per direction
        (reference: src/hydro/hydro_newdt.cpp:57-119); the driver applies
        the CFL number."""
        mbi = self.mesh.mb_indcs
        sl = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
              slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
        wa = w[sl]
        vx, vy, vz = wa[:, IVX], wa[:, IVY], wa[:, IVZ]
        if self.time_evolution == "kinematic":
            dv = (torch.abs(vx), torch.abs(vy), torch.abs(vz))
        elif self.is_gr:
            # light speed bounds every signal (reference:
            # hydro_newdt.cpp:85-88)
            dv = (torch.ones_like(vx),) * 3
        elif self.is_sr:
            lor = torch.sqrt(1.0 + vx * vx + vy * vy + vz * vz)
            p = self.eos.pressure(wa[:, IEN])
            dv = []
            for vel in (vx, vy, vz):
                lp, lm = sr_hydro_sound_speeds(self.eos, wa[:, IDN], p, vel,
                                               lor)
                dv.append(torch.maximum(torch.abs(lm), lp))
        else:
            if self.eos.is_ideal:
                p = self.eos.pressure(wa[:, IEN])
                cs = self.eos.hydro_sound_speed(wa[:, IDN], p)
            else:
                cs = self.eos.iso_cs
            dv = (torch.abs(vx) + cs, torch.abs(vy) + cs,
                  torch.abs(vz) + cs)
        dt = torch.min(self.dxs["x1"] / torch.clamp(dv[0], min=1e-300))
        if mbi.nx2 > 1:
            dt = torch.minimum(dt, torch.min(
                self.dxs["x2"] / torch.clamp(dv[1], min=1e-300)))
        if mbi.nx3 > 1:
            dt = torch.minimum(dt, torch.min(
                self.dxs["x3"] / torch.clamp(dv[2], min=1e-300)))
        return dt

    # ------------------------------------------------- state-dict interface
    def make_state(self, u, w):
        state = {"u": u, "w": w}
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
        return {"u1": state["u"]}

    def accumulate_rk4(self, saved, state, delta):
        return {"u1": saved["u1"] + delta * state["u"]}

    def unpack_state(self, state):
        """The state as outputs read it: hydro always carries w."""
        return state

    def init_ghosts(self, state):
        u = self.bvals.fill_ghosts(state["u"])
        w, u, _ = self.cons_to_prim(u)
        if self.bvals.prolong_prims:
            u, w = self.bvals.prolong_prims_fixup(u, w, self.prim_to_cons)
        return dict(state, u=u, w=w)

    def restart_ghosts(self, state):
        """The state of a resumed run: ``init_ghosts``, but under GR the
        stored state as it is.  It holds every ghost and the primitives
        of its last c2p, and a second GR c2p is not the identity on a
        floored state (the floors fire again on p2c's rounding), so
        refilling would part a resumed run from a straight one."""
        if self.is_gr and "w" in state:
            return state
        return self.init_ghosts(state)

    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        """One RK stage: fluxes -> (FOFC) -> (flux correction) -> update
        -> (coordinate and other source terms, the hook) -> fill -> c2p
        (reference task chain hydro_tasks.cpp:54-70); with FOFC or
        excision the counters carry ``nfofc``."""
        u, w = state["u"], state["w"]
        flx = self.fluxes(w)
        nfofc = None
        if self.use_fofc or self.fofc_excise_mask is not None:
            flx, nfofc = self._apply_fofc(u, saved["u1"], w, flx, gam0,
                                          gam1, beta_dt)
        if self.multilevel:
            flx = flux_correct_cc(flx, self.mesh, [d[0] for d in self.dirs])
        # the potential of the stage's state, before the update (the
        # reference solves before the stage's task list, driver.cpp:406-408)
        phi = self.pgrav.solve(u, self.bvals, phi0=state.get("phi")) \
            if self.pgrav is not None else None
        u = self.rk_update(u, saved["u1"], flx, gam0, gam1, beta_dt)
        if self.is_gr:
            u = coord_src_terms(u, w, self.eos, self.geom, beta_dt)
        if self.srcterms is not None and self.srcterms.any_enabled:
            u = self.srcterms.apply(u, w, beta_dt, flx=flx, phi=phi)
        if self.psbox is not None:
            u = self.psbox.src_terms(u, w, beta_dt, self.eos.is_ideal)
        if self.srcterms_func is not None:
            kw = {"t": state.get("t")} \
                if getattr(self.srcterms_func, "needs_time", False) else {}
            u = self.srcterms_func(u, w, beta_dt, **kw)
        u = self.bvals.fill_ghosts(u)
        if self.psbox is not None:
            u = self.psbox.remap_ghosts(u, state["t"])
        w, u, counters = self.cons_to_prim(u)
        if self.bvals.prolong_prims:
            u, w = self.bvals.prolong_prims_fixup(u, w, self.prim_to_cons)
        if nfofc is not None:
            counters = dict(counters, nfofc=nfofc)
        out = dict(state, u=u, w=w)
        if phi is not None and "phi" in state:
            out["phi"] = phi
        return out, counters

    def dt_from_state(self, state):
        dt = self.new_dt(state["w"])
        ndim = len(self.dirs)
        if self.pvisc is not None:
            dt = torch.minimum(dt, self.pvisc.new_dt(ndim, dt))
        if self.pcond is not None:
            dt = torch.minimum(dt, self.pcond.new_dt(ndim, dt))
        if self.srcterms is not None and self.srcterms.any_enabled:
            dt = torch.minimum(dt, self.srcterms.new_dt(state["w"]))
        if self.ppart is not None:
            dt = torch.minimum(dt, torch.tensor(
                self.ppart.new_dt(), dtype=dt.dtype, device=dt.device))
        return dt
