"""Radiation coupled to hydro or MHD.

Counterpart of ``athenak_tpu/radiation/rad_fluid.py`` (reference: the
rad_hydro and rad_mhd branches of MeshBlockPack::AddPhysics,
src/mesh/meshblock_pack.cpp, and the task order of
src/radiation/radiation_tasks.cpp: fluxes -> updates -> RadFluidCoupling
-> boundary exchange -> c2p).  A stage runs the intensity transport on
the stage's state, the fluid's own stage, then the implicit coupling
against the fluid's new primitives, and fills the ghosts of u (again,
after the coupling changed it) and of i0.  The coupling needs the GR
fluid's lowered-index energy convention, so the deck must set
``<coord>/general_rel`` (``minkowski = true`` for flat space), as in the
reference; GR closes kernels A, C, D, E and J, and the fills of u and i0
take B and G where ``bvals.py`` admits them.
"""

from __future__ import annotations

import torch

from .coupling import rad_fluid_coupling
from .radiation import Radiation


class RadiationFluid:
    """<radiation> with <hydro> or <mhd> (reference: rad_hydro, rad_mhd)."""

    def __init__(self, pin, mesh, bvals, device, dtype) -> None:
        from ..physics.hydro import Hydro
        from ..physics.mhd import MHD

        self.mesh = mesh
        self.bvals = bvals
        if pin.does_block_exist("mhd"):
            self.fluid = MHD(pin, mesh, bvals, device=device, dtype=dtype)
        else:
            self.fluid = Hydro(pin, mesh, bvals, device=device, dtype=dtype)
        self.rad = Radiation(pin, mesh, bvals, device, dtype)
        self.device, self.dtype = self.fluid.device, dtype
        self.is_mhd = self.fluid.is_mhd
        self.eos = self.fluid.eos
        if not self.eos.is_ideal:
            raise ValueError("radiation coupling requires the ideal EOS")
        self.nvar = self.fluid.nvar
        self.nhydro = self.nmhd = getattr(self.fluid, "nhydro",
                                          getattr(self.fluid, "nmhd", 5))
        self.shape = self.fluid.shape
        if not self.fluid.is_gr:
            # the angular coupling takes the GR fluid's energy convention;
            # flat runs set general_rel = true with minkowski = true, as
            # the reference does (radiation.cpp:46-52)
            raise ValueError(
                "radiation-fluid coupling requires <coord> "
                "general_rel=true (use minkowski=true for flat space)")
        self.pturb = self.ppart = self.psbox = self.pgrav = None
        self.user_hist_func = None
        if self.is_mhd:
            self.compute_bcc = self.fluid.compute_bcc
            self.fill_ghosts_fc = self.fluid.fill_ghosts_fc

    @property
    def srcterms_func(self):
        """The problem generator's source-term hook lives on the fluid."""
        return self.fluid.srcterms_func

    @srcterms_func.setter
    def srcterms_func(self, fn):
        self.fluid.srcterms_func = fn

    # ------------------------------------------------------------------
    def prim_to_cons(self, w, bcc=None):
        if self.is_mhd:
            return self.fluid.prim_to_cons(w, bcc)
        return self.fluid.prim_to_cons(w)

    # ------------------------------------------------------------------
    def make_state(self, u, w, i0, bfc=None):
        state = self.fluid.make_state(u, w, bfc) if self.is_mhd \
            else self.fluid.make_state(u, w)
        state["i0"] = i0
        return state

    def save_state(self, state):
        saved = self.fluid.save_state(state)
        saved["i1"] = state["i0"]
        return saved

    def accumulate_rk4(self, saved, state, delta):
        out = self.fluid.accumulate_rk4(saved, state, delta)
        out["i1"] = saved["i1"] + delta * state["i0"]
        return out

    def unpack_state(self, state):
        return self.fluid.unpack_state(state)

    def init_ghosts(self, state):
        out = self.fluid.init_ghosts(state)
        out["i0"] = self.bvals.fill_ghosts(state["i0"])
        return out

    def restart_ghosts(self, state):
        """A resumed run's state: the fluid's ``restart_ghosts`` (under
        GR the stored state as it is) and the stored intensities, whose
        ghosts the file holds."""
        out = self.fluid.restart_ghosts(state)
        out["i0"] = state["i0"]
        return out

    # ------------------------------------------------------------------
    def coupling_active(self) -> bool:
        rad = self.rad
        return (not rad.fixed_fluid or rad.kappa_a > 0.0
                or rad.kappa_s > 0.0 or rad.power_opacity)

    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        """The intensity transport on the stage's state, the fluid stage
        (fluxes, update, source terms, fill, c2p), then the implicit
        exchange against the new primitives and the fills (reference
        task order: radiation_tasks.cpp:45-90)."""
        rad = self.rad
        i0 = state["i0"]
        flx = rad.fluxes(i0)
        i0_new = rad.rk_update(i0, saved["i1"], flx, gam0, gam1, beta_dt)
        i0_new = rad.floor(rad.add_beam(i0_new, beta_dt))
        out, counters = self.fluid.stage_update(state, saved, gam0, gam1,
                                                beta_dt)
        if self.coupling_active():
            affect = rad.affect_fluid and not rad.fixed_fluid
            i0_new, u_new = rad_fluid_coupling(
                rad, i0_new, out["u"], out["w"], self.eos.gamma - 1.0,
                beta_dt, affect_fluid=affect)
            if affect:
                u_new = self.bvals.fill_ghosts(u_new)
                if self.is_mhd:
                    w_new, u_new, _ = self.fluid.cons_to_prim(u_new,
                                                              out["bcc"])
                else:
                    w_new, u_new, _ = self.fluid.cons_to_prim(u_new)
                out = dict(out, u=u_new, w=w_new)
        out["i0"] = self.bvals.fill_ghosts(i0_new)
        return out, counters

    # ------------------------------------------------------------------
    def dt_from_state(self, state):
        dt = self.fluid.dt_from_state(state)
        return torch.minimum(dt, self.rad.dt_from_state({"u": state["i0"]}))

    def coord_energy_density(self, state):
        return self.rad.coord_energy_density({"u": state["i0"]})
