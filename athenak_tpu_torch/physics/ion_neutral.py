"""Ion-neutral two-fluid coupling with ImEx time integration.

Counterpart of ``athenak_tpu/physics/ion_neutral.py`` (reference:
src/ion-neutral/ion-neutral.cpp:25-31, ion-neutral_tasks.cpp:95-295).
The neutrals evolve as ``Hydro`` (the ``<hydro>`` block), the ions as
``MHD`` (``<mhd>``), coupled by the stiff drag gamma_d rho_i rho_n
(v_n - v_i) and optional ionisation and recombination, under the
Pareschi & Russo ImEx-SSP schemes (``driver.make_integrator``: imex2,
imex2+, imex3): the coupling is solved analytically in the implicit
stages and the flux divergences are explicit.

``imex_cycle`` is one whole cycle: the two implicit pre-stages, then
each explicit stage (the hydro stage, the MHD stage, the explicit sum
of the earlier stiff residuals, the implicit solve, the residual of the
new state).  The state holds the neutrals in ``u``/``w``, the ions in
``ui``/``wi`` with ``bfc``/``bcc``, and the stiff residuals of the
implicit stages in ``ru`` [nmb, 4, 8, n3, n2, n1].

The ions' MHD never takes kernel A.  The A route keeps no primitives
between stages (its state is (u, bfc) alone), while the coupling reads
``wi`` and ``bcc`` after every stage; the JAX package's IonNeutral on
its A route would read primitives its stage did not write (ROADMAP
F20).  The ions take E + F instead where their gates admit the deck,
J and D on the general path, and the neutrals the fills B and G.
"""

from __future__ import annotations

import torch

from ..indices import IDN, IM1, IM2, IM3
from .hydro import Hydro
from .mhd import MHD


class IonNeutral:
    is_mhd = False  # the top-level u and w are the neutral fluid

    def __init__(self, pin, mesh, bvals, device, dtype) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.device = torch.device(device)
        self.dtype = dtype
        self.drag_coeff = pin.get_real("ion-neutral", "drag_coeff")
        if mesh.multilevel:
            raise NotImplementedError(
                "ion-neutral with static mesh refinement is not supported "
                "yet")
        self.xi = pin.get_or_add_real("ion-neutral", "ionization_coeff", 0.0)
        self.alpha = pin.get_or_add_real(
            "ion-neutral", "recombination_coeff", 0.0)
        self.phydro = Hydro(pin, mesh, bvals, device, dtype)   # neutrals
        self.pmhd = MHD(pin, mesh, bvals, device, dtype)       # ions
        # kernel A closed for the ions: E + F where A's gate admitted them
        self.pmhd.use_mega_stage = (self.pmhd.use_mega_stage
                                    or self.pmhd.use_mega_v2)
        self.pmhd.use_mega_v2 = False
        self.eos = self.phydro.eos
        self.nvar = self.phydro.nvar
        self.pturb = self.phydro.pturb

    # ---------------------------------------------------------------- state
    def make_state(self, un, wn, ui, wi, bfc):
        mbi = self.mesh.mb_indcs
        nimp = 4  # the most implicit stages (imex3); imex2 uses three
        ru = torch.zeros((self.mesh.nmb_total, nimp, 8, mbi.ncells3,
                          mbi.ncells2, mbi.ncells1), dtype=un.dtype,
                         device=un.device)
        return {"u": un, "w": wn, "ui": ui, "wi": wi, "bfc": bfc,
                "bcc": self.pmhd.compute_bcc(bfc), "ru": ru}

    @staticmethod
    def _hyd(state):
        return {"u": state["u"], "w": state["w"]}

    @staticmethod
    def _ion(state):
        return {"u": state["ui"], "w": state["wi"], "bfc": state["bfc"],
                "bcc": state["bcc"]}

    def unpack_state(self, state):
        return state

    def init_ghosts(self, state):
        h = self.phydro.init_ghosts(self._hyd(state))
        m = self.pmhd.init_ghosts(self._ion(state))
        return dict(state, u=h["u"], w=h["w"], ui=m["u"], wi=m["w"],
                    bfc=m["bfc"], bcc=m["bcc"])

    def dt_from_state(self, state):
        return torch.minimum(self.phydro.dt_from_state(self._hyd(state)),
                             self.pmhd.dt_from_state(self._ion(state)))

    # ------------------------------------------------------------- implicit
    def _stiff_residual(self, ui, un):
        """R(U): the drag, ionisation and recombination channels
        (reference: ion-neutral_tasks.cpp:259-288)."""
        g, xi, al = self.drag_coeff, self.xi, self.alpha
        di, dn = ui[:, IDN], un[:, IDN]
        out = []
        for im in (IM1, IM2, IM3):
            out.append(g * (di * un[:, im] - dn * ui[:, im])
                       + xi * un[:, im] - al * di * ui[:, im])
        for im in (IM1, IM2, IM3):
            out.append(g * (dn * ui[:, im] - di * un[:, im])
                       - xi * un[:, im] + al * di * ui[:, im])
        out.append(xi * dn - al * di * di)
        out.append(-xi * dn + al * di * di)
        return torch.stack(out, dim=1)  # [nmb, 8, n3, n2, n1]

    def _imp_update(self, state, istage: int, integ, dt):
        """One implicit stage (reference: IonNeutral::ImpRKUpdate,
        ion-neutral_tasks.cpp:145-290).  ``dt`` is the cycle's dt, a 0-d
        tensor at the state's dtype."""
        ui, un, ru = state["ui"].clone(), state["u"].clone(), state["ru"]

        # (a) the explicit sum of the earlier stages' stiff residuals
        if istage > 1:
            for s in range(istage - 1):
                if integ.a_twid[istage - 2][s] == 0.0:
                    continue
                adt = integ.a_twid[istage - 2][s] * dt
                r = ru[:, s]
                for c, im in ((0, IM1), (1, IM2), (2, IM3)):
                    ui[:, im] += adt * r[:, c]
                for c, im in ((3, IM1), (4, IM2), (5, IM3)):
                    un[:, im] += adt * r[:, c]
                ui[:, IDN] += adt * r[:, 6]
                un[:, IDN] += adt * r[:, 7]

        # (b) the analytic implicit solve of drag, ionisation and
        # recombination
        if istage <= integ.nimp_stages:
            g_adt = self.drag_coeff * integ.a_impl * dt
            xi_adt = self.xi * integ.a_impl * dt
            al_adt = self.alpha * integ.a_impl * dt
            rho_i = ui[:, IDN]
            if self.alpha > 0.0:
                d = (1.0 / (4.0 * al_adt ** 2)
                     + xi_adt / (2.0 * al_adt ** 2)
                     + xi_adt ** 2 / (4.0 * al_adt ** 2)
                     + ui[:, IDN] / al_adt
                     + xi_adt / al_adt * (ui[:, IDN] + un[:, IDN]))
                rho_i = (-1.0 / (2.0 * al_adt) - xi_adt / (2.0 * al_adt)
                         + torch.sqrt(d))
            rho_n = ui[:, IDN] + un[:, IDN] - rho_i
            ui[:, IDN] = rho_i
            un[:, IDN] = rho_n
            denom = 1.0 + g_adt * (rho_i + rho_n) + xi_adt + al_adt * rho_i
            for im in (IM1, IM2, IM3):
                tot = ui[:, im] + un[:, im]
                u_i = (ui[:, im] + (g_adt * rho_i + xi_adt) * tot) / denom
                ui[:, im] = u_i
                un[:, im] = tot - u_i
            # (c) the stiff residual of the new state
            ru = ru.clone()
            ru[:, istage - 1] = self._stiff_residual(ui, un)
        return dict(state, ui=ui, u=un, ru=ru)

    def _prims(self, state):
        """c2p of both fluids (the neutrals' and the ions' floors)."""
        wn, un, _ = self.phydro.cons_to_prim(state["u"])
        wi, ui, _ = self.pmhd.cons_to_prim(state["ui"], state["bcc"])
        return dict(state, w=wn, u=un, wi=wi, ui=ui)

    # ---------------------------------------------------------------- cycle
    def imex_cycle(self, state, dt, integ):
        """One ImEx cycle (reference: FirstTwoImpRK, then ImpRKUpdate
        after each explicit update); ``dt`` a 0-d tensor in the state's
        dtype (or a Python float, converted).  Returns (state, dtnew,
        counters)."""
        dtt = torch.as_tensor(dt, dtype=state["u"].dtype,
                              device=state["u"].device)
        if self.pturb is not None:
            state = self.pturb.apply(state, dtt, self.phydro)
        # the registers are copied before the implicit pre-stages
        # (reference: FirstTwoImpRK, ion-neutral_tasks.cpp:103-108)
        saved_h = self.phydro.save_state(self._hyd(state))
        saved_m = self.pmhd.save_state(self._ion(state))
        state = self._imp_update(state, 1, integ, dtt)
        state = self._imp_update(state, 2, integ, dtt)
        state = self._prims(state)
        counters_tot = None
        for s in range(integ.nexp_stages):
            bdt = integ.beta[s] * dtt
            hs, ch = self.phydro.stage_update(
                self._hyd(state), saved_h, integ.gam0[s], integ.gam1[s], bdt)
            ms, cm = self.pmhd.stage_update(
                self._ion(state), saved_m, integ.gam0[s], integ.gam1[s], bdt)
            state = dict(state, u=hs["u"], w=hs["w"], ui=ms["u"],
                         wi=ms["w"], bfc=ms["bfc"], bcc=ms["bcc"])
            # implicit stage s + 3, after the two pre-stages (reference:
            # istage = estage + 2 with estage from 1)
            state = self._imp_update(state, s + 3, integ, dtt)
            state = self._prims(state)
            # the floor counts of both fluids; a kernel F's new-dt maxima
            # (the ions on the v1 route) are not a count
            c = {f"n_{k}": v for k, v in {**ch, **cm}.items()
                 if k != "dtmin"}
            counters_tot = c if counters_tot is None else \
                {k: counters_tot[k] + v for k, v in c.items()}
        return state, self.dt_from_state(state), counters_tot
