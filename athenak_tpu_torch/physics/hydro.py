"""Newtonian hydrodynamics.

Counterpart of ``athenak_tpu/physics/hydro.py`` (reference:
src/hydro/hydro.hpp:67-158, hydro_tasks.cpp:48-80, hydro_fluxes.cpp,
hydro_update.cpp, hydro_newdt.cpp).  The task list (copyu -> flux ->
rkupdate -> sendu/recvu -> bcs -> c2p -> newdt) collapses into
``stage_update``, one function per RK stage on torch tensors.  The
conserved ``u`` and the primitive ``w`` are
``[nmb, nvar, n3, n2, n1]`` (ghosts included); the primitives store the
internal energy in the IEN slot.

The JAX package has no stage kernel for hydro, so the stage runs in
torch ops on every device.  Only the ghost fills take kernels on the
card in float32: kernel B on a single fully periodic 3-D block with two
ghost cells, kernel G on a same-level periodic pool (the fills of
``bvals.py``).  ``<hydro>/use_kernels = false`` keeps a run on the
sweep fills, for comparison.  On a statically refined mesh the stage
adds the flux correction after the fluxes (``refinement.flux_correct_cc``)
and the fills take the mixed-level paths.  Driven turbulence
(``<turb_driving>``) carries ``turb_force`` in the state; the driver
applies the forcing once a cycle before the stages.  SR and GR hydro,
diffusion, first-order flux correction, ``<hydro_srcterms>``, gravity,
particles and the shearing box are not ported yet and raise.
"""

from __future__ import annotations

import torch

from ..bvals import BoundaryValues
from ..coordinates import Coordinates
from ..indices import IDN, IEN, IVX, IVY, IVZ, RECON_NGHOST
from ..mesh import Mesh
from ..ops import recon as recon_ops
from ..ops import rsolvers
from ..ops.eos import EOSData, cons_to_prim_hydro, prim_to_cons_hydro
from ..ops.fluid import face_floors, rk_update, scalar_fluxes
from ..refinement import flux_correct_cc
from ..utils import not_ported


class Hydro:
    """Hydro configuration and the per-stage update on torch tensors."""

    is_mhd = False

    def __init__(self, pin, mesh: Mesh, bvals: BoundaryValues,
                 device, dtype) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.device = torch.device(device)
        self.dtype = dtype
        coord = Coordinates(pin)
        if coord.is_general_relativistic:
            raise not_ported("general-relativistic hydro")
        if coord.is_special_relativistic:
            raise not_ported("special-relativistic hydro")
        self.eos = EOSData.from_input(pin, "hydro")
        self.nhydro = self.eos.nfluid
        self.nscalars = pin.get_or_add_integer("hydro", "nscalars", 0)
        self.nvar = self.nhydro + self.nscalars

        self.recon_method = pin.get_or_add_string("hydro", "reconstruct",
                                                  "plm")
        if self.recon_method not in recon_ops.RECON_FNS:
            raise ValueError(
                f"hydro/reconstruct={self.recon_method} unknown")
        self.rsolver = pin.get_or_add_string("hydro", "rsolver", "llf")
        if self.rsolver not in rsolvers.HYDRO_RSOLVER_FNS:
            raise ValueError(f"hydro/rsolver={self.rsolver} unknown")
        self._solve = rsolvers.HYDRO_RSOLVER_FNS[self.rsolver]
        ng_need = RECON_NGHOST[self.recon_method]
        if mesh.mb_indcs.ng < ng_need:
            raise ValueError(
                f"reconstruct={self.recon_method} requires nghost >= "
                f"{ng_need} but mesh/nghost={mesh.mb_indcs.ng}")
        for key in ("nu_iso", "nu_aniso", "alpha_iso", "alpha_aniso",
                    "alpha_spitzer"):
            if pin.does_parameter_exist("hydro", key):
                raise not_ported(f"diffusion (hydro/{key})")
        if pin.get_or_add_boolean("hydro", "fofc", False):
            raise not_ported("first-order flux correction")
        for block, what in (("hydro_srcterms", "hydro source terms"),
                            ("shearing_box", "the shearing box"),
                            ("particles", "particles"),
                            ("gravity", "self-gravity")):
            if pin.does_block_exist(block):
                raise not_ported(what)

        mbi = mesh.mb_indcs
        self.shape = (mesh.nmb_total, self.nvar, mbi.ncells3, mbi.ncells2,
                      mbi.ncells1)
        # the cell size: a scalar on one level, per block on a refined
        # mesh ([nmb, 1, 1, 1] for new_dt, one more axis in dirs)
        self.multilevel = mesh.multilevel
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
        return cons_to_prim_hydro(u, self.eos)

    def prim_to_cons(self, w):
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
            f = self._solve(wl, wr, self.eos, ivx)
            out[name] = scalar_fluxes(f, wl, wr, self.nhydro)
        return out

    def rk_update(self, u0, u1, flx, gam0, gam1, beta_dt):
        """gam0 * u0 + gam1 * u1 - beta_dt * div(F) over the whole array
        (reference: src/hydro/hydro_update.cpp:52-80); the ghosts are
        refilled right after."""
        return rk_update(u0, u1, flx, gam0, gam1, beta_dt, self.dirs)

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
        return dict(state, u=u, w=w)

    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        """One RK stage: fluxes -> (flux correction) -> update -> fill ->
        c2p (reference task chain hydro_tasks.cpp:54-70)."""
        flx = self.fluxes(state["w"])
        if self.multilevel:
            flx = flux_correct_cc(flx, self.mesh, [d[0] for d in self.dirs])
        u = self.rk_update(state["u"], saved["u1"], flx, gam0, gam1,
                           beta_dt)
        u = self.bvals.fill_ghosts(u)
        w, u, counters = self.cons_to_prim(u)
        return dict(state, u=u, w=w), counters

    def dt_from_state(self, state):
        return self.new_dt(state["w"])
