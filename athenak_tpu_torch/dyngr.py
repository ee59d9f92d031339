"""Dynamical GRMHD: MHD on an evolving (or prescribed) ADM spacetime.

Counterpart of ``athenak_tpu/dyngr.py`` (reference: the
``DynGRMHD``/``DynGRMHDPS`` stack, src/dyn_grmhd/dyn_grmhd.{hpp,cpp},
dyn_grmhd_fluxes.cpp, rsolvers/{flux,llf,hlle}_dyn_grmhd.hpp,
z4c/tmunu.{hpp,cpp}):

  * the conserved state u is the sqrt(gamma)-densitised (D, S_i, tau);
    the face field bfc is the densitised B-tilde, so the CT machinery
    (corner EMFs, the curl update, the face-field fill) is the
    Newtonian MHD class's, borrowed as the JAX package borrows it; only
    the cell-centred transport EMF E = -(alpha v - beta) x B-tilde
    differs (mhd_corner_e.cpp ADM branch), passed to ``corner_e`` as
    ``ecc``;
  * the EOS is the primitive-solver framework (``eos_ps/``): ideal gas,
    piecewise polytrope, tabulated CompOSE or the hybrid, with the
    whole-tensor Kastaun mu-root c2p of fixed trip counts;
  * the spacetime: with a <z4c> block the coupled evolution runs, the
    stress-energy of the fluid entering the Z4c right-hand side and the
    ADM variables (gamma_ij, K_ij, alpha, beta) derived pointwise from
    the Z4c state at every stage (the reference's SetADMVariables);
    without <z4c> the problem generator's background stays fixed
    (``set_fixed_adm``, kept on the device), or a prescribed
    time-dependent one (``set_adm_fn``) is evaluated on the device at
    every stage with no host read.

No kernel runs here, as in the JAX package (``use_pallas`` and
``use_fused_stage`` are off): the stage is plain tensor code, the Z4c
stage with matter takes the plain path (kernel H is closed by
``tmunu``), and only the ghost fills of u, z and the faces may take the
fill kernels B and G where their gates admit the mesh.

State dict: {"u", "w", "T", "bfc", "bcc"[, "z"][, "co_pos"]}; w stores
[rho, Wv^x, Wv^y, Wv^z, P] (the utilde velocity) and T the temperature.
"""

from __future__ import annotations

import numpy as np
import torch

from .bvals import BoundaryValues
from .comm import LocalAttr, local_tree
from .eos_ps import (PrimitiveSolverPS, contract, lower, make_policy,
                     spatial_det, spatial_inv, sym6)
from .indices import IDN, IEN, IVX, RECON_NGHOST
from .mesh import Mesh
from .ops import recon as recon_ops
from .physics.mhd import MHD
from .z4c import fd
from .z4c.z4c import adm_from_z4c


class DynGRMHD:
    """Composed physics module: primitive-solver MHD (+ optional Z4c)."""

    # per-block tables read as the running cycle's rows (comm.LocalAttr;
    # JAX dyngr.py:151-154, 426)
    dxs = LocalAttr()
    dirs = LocalAttr()
    idx = LocalAttr()

    is_mhd = True

    # the CT, face-field and update machinery of Newtonian MHD
    compute_bcc = MHD.compute_bcc
    corner_e = MHD.corner_e
    ct_update = MHD.ct_update
    fill_ghosts_fc = MHD.fill_ghosts_fc
    _sweep_fc = MHD._sweep_fc
    _phys_bc_fc = MHD._phys_bc_fc
    rk_update = MHD.rk_update

    def __init__(self, pin, mesh: Mesh, bvals: BoundaryValues,
                 device, dtype) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.device = torch.device(device)
        self.dtype = dtype
        self.multilevel = mesh.multilevel
        if self.multilevel:
            bvals.prolong_prims = pin.get_or_add_boolean(
                "mesh_refinement", "prolong_primitives", False)
        self.is_sr = False
        self.is_gr = False          # the fixed Kerr-Schild machinery
        self.geom = None
        self.presist = None
        self.pvisc = None
        self.pcond = None
        self.pturb = None
        self.ppart = None
        self.psbox = None
        self.pgrav = None
        self.srcterms = None
        self.srcterms_func = None
        self.use_fofc = False
        self.fofc_excise_mask = None
        self.nscalars = 0
        self.nmhd = 5
        self.nvar = 5
        # every MHD kernel gate closed, as the JAX package's use_pallas
        # and use_fused_stage
        self.use_mega_v2 = self.use_mega_stage = False
        self.use_fused_stage = self.use_fused_ct = False
        self.use_flux_dir = False
        # <mhd>/use_kernels = false keeps the fills on their plain path
        if not pin.get_or_add_boolean("mhd", "use_kernels", True):
            bvals.use_fill_kernel = False
            bvals.use_pool_fill = False

        # EOS policy + primitive solver (reference: BuildDynGRMHD,
        # dyn_grmhd.cpp:78-120), read before the floors of EOSData so
        # that its defaults are the solver's
        self.policy = make_policy(pin, "mhd")
        self.ps = PrimitiveSolverPS.from_input(self.policy, pin, "mhd")
        from .ops.eos import EOSData
        self.eos = EOSData.from_input(pin, "mhd")

        self.recon_method = pin.get_or_add_string("mhd", "reconstruct",
                                                  "plm")
        if self.recon_method not in recon_ops.RECON_FNS:
            raise ValueError(f"mhd/reconstruct={self.recon_method} unknown")
        self.rsolver = pin.get_or_add_string("mhd", "rsolver", "llf")
        if self.rsolver not in ("llf", "hlle"):
            raise ValueError(
                f"mhd/rsolver={self.rsolver}: dynamical GRMHD supports "
                "llf and hlle (reference: DynGRMHD_RSolver)")
        ng_need = RECON_NGHOST[self.recon_method]
        if mesh.mb_indcs.ng < ng_need:
            raise ValueError(
                f"reconstruct={self.recon_method} needs nghost>={ng_need}")

        mbi = mesh.mb_indcs
        n1, n2, n3 = mbi.ncells1, mbi.ncells2, mbi.ncells3
        self.shape = (mesh.nmb_total, self.nvar, n3, n2, n1)
        self.fc_shapes = {
            "x1f": (mesh.nmb_total, n3, n2, n1 + 1),
            "x2f": (mesh.nmb_total, n3, n2 + 1, n1),
            "x3f": (mesh.nmb_total, n3 + 1, n2, n1),
        }
        # the cell size: a scalar on one level, per block on a refined
        # mesh ([nmb, 1, 1, 1] for 4-D arrays, one more axis in dirs)
        ms = mesh.mesh_size
        if self.multilevel:
            self.dxs = {n: torch.as_tensor(
                mesh.mb_size[f"d{n}"], dtype=dtype,
                device=self.device).reshape(-1, 1, 1, 1)
                for n in ("x1", "x2", "x3")}
            dx5 = {n: d[..., None] for n, d in self.dxs.items()}
            self.idx = tuple(torch.as_tensor(
                1.0 / np.asarray(mesh.mb_size[f"dx{d}"]), dtype=dtype,
                device=self.device).reshape(-1, 1, 1, 1) for d in (1, 2, 3))
        else:
            self.dxs = {"x1": ms.dx1, "x2": ms.dx2, "x3": ms.dx3}
            dx5 = self.dxs
            self.idx = (1.0 / ms.dx1, 1.0 / ms.dx2, 1.0 / ms.dx3)
        self.dirs = [("x1", 4, IVX, dx5["x1"])]
        if mbi.nx2 > 1:
            self.dirs.append(("x2", 3, IVX + 1, dx5["x2"]))
        if mbi.nx3 > 1:
            self.dirs.append(("x3", 2, IVX + 2, dx5["x3"]))
        self.time_evolution = pin.get_string("time", "evolution") \
            if pin.does_block_exist("time") else "dynamic"

        # the spacetime: evolved Z4c, or a fixed or prescribed background
        self.fixed_evolution = not pin.does_block_exist("z4c")
        self._fixed_adm = None      # set by the problem generator
        self._fixed_sampler = None  # mesh -> the background, for a rebuild
        self._adm_fn = None         # a prescribed ADM(t)
        self.user_refine_func = None
        if self.fixed_evolution:
            self.z4c = None
            self.nco = 0
        else:
            from .z4c.z4c import Z4c
            self.z4c = Z4c(pin, mesh, bvals, device, dtype)
            # compact-object trackers ride the Z4c shift
            self.nco = self.z4c.nco
            self.tracker_pos0 = self.z4c.tracker_pos0
            self.tracker_radius = self.z4c.tracker_radius
            self.tracker_reflevel = self.z4c.tracker_reflevel

    # ------------------------------------------------------------ spacetime
    def set_fixed_adm(self, g3d, alpha, beta_u, K_dd=None, sampler=None):
        """Install the static ADM background (the problem generator's
        hook; the reference's ADM::SetADMVariables without Z4c): host
        arrays [nmb, n3, n2, n1], moved once to the run's device at its
        dtype.  ``sampler(mesh) -> (g3d, alpha, beta_u, K_dd)`` samples
        the same background on another tree (an adaptive rebuild)."""
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                                   device=self.device)
        zeros = dev(np.zeros_like(np.asarray(alpha, dtype=np.float64)))
        self._fixed_adm = {
            "g3d": [dev(c) for c in g3d], "alpha": dev(alpha),
            "beta_u": [dev(c) for c in beta_u],
            "K_dd": [dev(c) for c in K_dd] if K_dd is not None
            else [zeros] * 6}
        self._fixed_sampler = sampler

    def set_adm_fn(self, fn):
        """A prescribed time-dependent ADM background: ``fn(t) -> adm``
        dict with g3d/alpha/beta_u/K_dd, evaluated on the device at every
        stage (the reference's padm->SetADMVariables hook re-evaluated
        each step, e.g. the superposed-BBH metric,
        src/pgen/dyn_grmhd/dynbbh.cpp:242-313).  A ``fn.rebind(mesh)``
        gives the same spacetime on another tree."""
        self._adm_fn = fn

    def adopt_spacetime(self, old) -> None:
        """Take the prescribed spacetime of ``old`` (the physics of the
        previous tree) onto this one's mesh: a time-dependent background
        is rebuilt for the new cells, a fixed one sampled anew (the JAX
        package's rebuild drops both, ROADMAP F26)."""
        if not (self.fixed_evolution and old.fixed_evolution):
            return
        if old._adm_fn is not None:
            rebind = getattr(old._adm_fn, "rebind", None)
            if rebind is None:
                raise RuntimeError("a prescribed ADM background without "
                                   "rebind(mesh) cannot follow a rebuild")
            self.set_adm_fn(rebind(self.mesh))
        elif old._fixed_sampler is not None:
            self.set_fixed_adm(*old._fixed_sampler(self.mesh),
                               sampler=old._fixed_sampler)
        elif old._fixed_adm is not None:
            raise RuntimeError("a fixed ADM background without a sampler "
                               "cannot follow a rebuild")

    def adm_of(self, state):
        if self.fixed_evolution:
            if self._adm_fn is not None:
                return self._adm_fn(state.get("t", 0.0))
            if self._fixed_adm is None:
                raise RuntimeError("fixed-spacetime DynGRMHD needs the "
                                   "pgen to call set_fixed_adm")
            # the running cycle's rows (JAX dyngr.py:208-211)
            return local_tree(self._fixed_adm)
        return adm_from_z4c(self.z4c, state["z"])

    # ------------------------------------------------------- prim <-> cons
    def prim_to_cons_state(self, w, T, bcc, adm):
        """Densitised conserved state from primitives (the pgen path)."""
        g3d = adm["g3d"]
        sdetg = torch.sqrt(spatial_det(g3d))
        n = w[:, IDN] / self.ps.mb
        Wv = [w[:, IVX + a] for a in range(3)]
        P = w[:, IEN]
        B_u = [bcc[:, a] / sdetg for a in range(3)]
        D, S_d, tau = self.ps.prim_to_con(n, Wv, P, T, B_u, g3d)
        return torch.stack([D * sdetg, S_d[0] * sdetg, S_d[1] * sdetg,
                            S_d[2] * sdetg, tau * sdetg], dim=1)

    def cons_to_prim(self, u, bcc, adm):
        g3d = adm["g3d"]
        g3u = spatial_inv(g3d)
        sdetg = torch.sqrt(spatial_det(g3d))
        isd = 1.0 / sdetg
        D = u[:, 0] * isd
        S_d = [u[:, 1 + a] * isd for a in range(3)]
        tau = u[:, 4] * isd
        B_u = [bcc[:, a] * isd for a in range(3)]
        out = self.ps.con_to_prim(D, S_d, tau, B_u, g3d, g3u)
        w = torch.stack([out["n"] * self.ps.mb, out["Wv_u"][0],
                         out["Wv_u"][1], out["Wv_u"][2], out["P"]], dim=1)
        u_fixed = torch.stack(
            [out["D"] * sdetg, out["S_d"][0] * sdetg,
             out["S_d"][1] * sdetg, out["S_d"][2] * sdetg,
             out["tau"] * sdetg], dim=1)
        counters = {"nfloor": out["nfloor"], "nfail_c2p": out["nfail"]}
        return w, out["T"], u_fixed, counters

    # --------------------------------------------------------------- fluxes
    @staticmethod
    def _face_adm(adm, axis: int):
        """Arithmetic face average of the ADM fields along a cell axis
        (entry i = the face between cells i-1 and i, as the fluxes)."""
        def favg(f):
            return 0.5 * (f + torch.roll(f, 1, dims=axis - 1))
        return {"g3d": [favg(c) for c in adm["g3d"]],
                "alpha": favg(adm["alpha"]),
                "beta_u": [favg(c) for c in adm["beta_u"]]}

    def _state_flux(self, prim, T, B_u_til, g3d, beta_u, alpha, isdetg,
                    iax):
        """One-sided flux (reference: flux_dyn_grmhd.hpp SingleStateFlux).
        ``prim``: [rho, Wv(3), P] channel list; B_u_til densitised."""
        n = prim[0] / self.ps.mb
        Wv = [prim[1], prim[2], prim[3]]
        P = prim[4]
        B_u = [b * isdetg for b in B_u_til]
        D, S_d, tau = self.ps.prim_to_con(n, Wv, P, T, B_u, g3d)
        ialpha = 1.0 / alpha
        Wv_d = lower(Wv, g3d)
        iWsq = 1.0 / (1.0 + contract(Wv, Wv_d))
        iW = torch.sqrt(iWsq)
        vc = Wv[iax] * iW - beta_u[iax] * ialpha
        bu0 = contract(B_u, Wv_d) * ialpha
        B_d = lower(B_u, g3d)
        b_d = [(alpha * bu0 * Wv_d[a] + B_d[a]) * iW for a in range(3)]
        bsq = (contract(B_u, B_d) + (alpha * bu0) ** 2) * iWsq
        ptot = P + 0.5 * bsq
        f = [D * vc,
             S_d[0] * vc - b_d[0] * B_u[iax] * iW,
             S_d[1] * vc - b_d[1] * B_u[iax] * iW,
             S_d[2] * vc - b_d[2] * B_u[iax] * iW,
             tau * vc - alpha * bu0 * B_u[iax] * iW + ptot * Wv[iax] * iW]
        f[1 + iax] = f[1 + iax] + ptot
        iby = (iax + 1) % 3
        ibz = (iax + 2) % 3
        bf = {iby: B_u[iby] * vc
              - B_u[iax] * (Wv[iby] * iW - beta_u[iby] * ialpha),
              ibz: B_u[ibz] * vc
              - B_u[iax] * (Wv[ibz] * iW - beta_u[ibz] * ialpha)}
        cons = [D, S_d[0], S_d[1], S_d[2], tau]
        return cons, f, bf, bsq, B_u

    def _fast_speeds(self, prim, T, bsq, g3d, beta_u, alpha, gii, iax):
        """GR fast magnetosonic speeds (reference:
        primitive_solver_hyd.hpp:575-611)."""
        n = prim[0] / self.ps.mb
        Wv = [prim[1], prim[2], prim[3]]
        usq = contract(Wv, lower(Wv, g3d))
        Wsq = 1.0 + usq
        ialpha = 1.0 / alpha
        W = torch.sqrt(Wsq)
        u0 = W * ialpha
        u1 = Wv[iax] - u0 * beta_u[iax]
        g00 = -ialpha * ialpha
        g01 = -g00 * beta_u[iax]
        g11 = gii - g01 * beta_u[iax]
        nf = torch.clamp(n, min=self.ps.n_atm)
        cs = self.policy.sound_speed(nf, T)
        csq = cs * cs
        H = self.ps.mb * n * self.policy.enthalpy(nf, T)
        vasq = bsq / (bsq + H)
        cmsq = csq + vasq - csq * vasq
        a = u0 * u0 - (g00 + u0 * u0) * cmsq
        b = -2.0 * (u0 * u1 - (g01 + u0 * u1) * cmsq)
        c = u1 * u1 - (g11 + u1 * u1) * cmsq
        a1 = b / a
        a0 = c / a
        s = torch.sqrt(torch.clamp(a1 * a1 - 4.0 * a0, min=0.0))
        lam_p = torch.where(a1 >= 0.0, -2.0 * a0 / (a1 + s),
                            0.5 * (-a1 + s))
        lam_m = torch.where(a1 >= 0.0, 0.5 * (-a1 - s),
                            -2.0 * a0 / (a1 - s))
        return lam_p, lam_m

    def fluxes(self, w, T, bcc, bfc, adm):
        """Per-direction reconstruction and the LLF/HLLE dyngr solve
        (reference: dyn_grmhd_fluxes.cpp + rsolvers/llf_dyn_grmhd.hpp).
        Returns (flx, fden, emf): the fluxes, the mass flux per direction
        and the face EMFs under the reference names."""
        rec = recon_ops.RECON_FNS[self.recon_method]
        floors = self.recon_method in recon_ops.FLOORED_METHODS
        wt = torch.cat([w, T[:, None]], dim=1)
        bface = {
            "x1": bfc["x1f"][..., :-1],
            "x2": bfc["x2f"][..., :-1, :],
            "x3": bfc["x3f"][..., :-1, :, :],
        }
        flx, emf, fden = {}, {}, {}
        ey_name = {"x1": "e3x1", "x2": "e1x2", "x3": "e2x3"}
        ez_name = {"x1": "e2x1", "x2": "e3x2", "x3": "e1x3"}
        diag = [0, 3, 5]
        off = [4, 2, 1]   # S23, S13, S12 channel ids in sym6 order
        rho_floor = self.ps.n_atm * self.ps.mb

        for name, axis, ivx, _dx in self.dirs:
            iax = ivx - IVX
            wl, wr = rec(wt, axis)
            bl, br = rec(bcc, axis)
            prim_l = [wl[:, c] for c in range(5)]
            prim_r = [wr[:, c] for c in range(5)]
            if floors:
                prim_l[IDN] = torch.clamp(prim_l[IDN], min=rho_floor)
                prim_r[IDN] = torch.clamp(prim_r[IDN], min=rho_floor)
            prim_l[IEN] = torch.clamp(prim_l[IEN], min=0.0)
            prim_r[IEN] = torch.clamp(prim_r[IEN], min=0.0)
            Tl = torch.clamp(wl[:, 5], min=self.policy.min_T)
            Tr = torch.clamp(wr[:, 5], min=self.policy.min_T)

            fadm = self._face_adm(adm, axis)
            g3d = fadm["g3d"]
            alpha = fadm["alpha"]
            beta_u = fadm["beta_u"]
            detg = spatial_det(g3d)
            sdetg = torch.sqrt(detg)
            isdetg = 1.0 / sdetg

            bx = bface[name]
            # the normal component is the shared staggered face field
            Bl = [bx if a == iax else bl[:, a] for a in range(3)]
            Br = [bx if a == iax else br[:, a] for a in range(3)]

            cons_l, fl, bfl, bsql, Bul = self._state_flux(
                prim_l, Tl, Bl, g3d, beta_u, alpha, isdetg, iax)
            cons_r, fr, bfr, bsqr, Bur = self._state_flux(
                prim_r, Tr, Br, g3d, beta_u, alpha, isdetg, iax)

            iby = (iax + 1) % 3
            ibz = (iax + 2) % 3
            gii = (g3d[diag[iby]] * g3d[diag[ibz]]
                   - g3d[off[iax]] * g3d[off[iax]]) * isdetg * isdetg
            lpl, lml = self._fast_speeds(prim_l, Tl, bsql, g3d, beta_u,
                                         alpha, gii, iax)
            lpr, lmr = self._fast_speeds(prim_r, Tr, bsqr, g3d, beta_u,
                                         alpha, gii, iax)

            if self.rsolver == "llf":
                lam = torch.maximum(torch.maximum(lpl, lpr),
                                    -torch.minimum(lml, lmr))
                chans = [0.5 * sdetg * (alpha * (fl[c] + fr[c])
                                        - lam * (cons_r[c] - cons_l[c]))
                         for c in range(5)]
                ey = -0.5 * sdetg * (alpha * (bfl[iby] + bfr[iby])
                                     - lam * (Bur[iby] - Bul[iby]))
                ez = 0.5 * sdetg * (alpha * (bfl[ibz] + bfr[ibz])
                                    - lam * (Bur[ibz] - Bul[ibz]))
            else:  # hlle (reference: hlle_dyn_grmhd.hpp)
                lam_r = torch.clamp(torch.maximum(lpl, lpr), min=0.0)
                lam_l = torch.clamp(torch.minimum(lml, lmr), max=0.0)
                idl = 1.0 / (lam_r - lam_l)
                chans = [sdetg * idl
                         * (alpha * (lam_r * fl[c] - lam_l * fr[c])
                            + lam_r * lam_l * (cons_r[c] - cons_l[c]))
                         for c in range(5)]
                ey = -sdetg * idl * (
                    alpha * (lam_r * bfl[iby] - lam_l * bfr[iby])
                    + lam_r * lam_l * (Bur[iby] - Bul[iby]))
                ez = sdetg * idl * (
                    alpha * (lam_r * bfl[ibz] - lam_l * bfr[ibz])
                    + lam_r * lam_l * (Bur[ibz] - Bul[ibz]))
            flx[name] = torch.stack(chans, dim=1)
            fden[name] = chans[0]
            emf[ey_name[name]] = ey
            emf[ez_name[name]] = ez
        return flx, fden, emf

    # ----------------------------------------------------------- sources
    def coord_src_terms(self, u, w, T, bcc, adm, beta_dt):
        """Geometric source terms (reference: DynGRMHDPS::AddCoordTermsEOS,
        dyn_grmhd.cpp), added in place to ``u`` (a fresh tensor of the
        stage), which is returned."""
        g3d = adm["g3d"]
        alpha = adm["alpha"]
        beta_u = adm["beta_u"]
        K_dd = adm["K_dd"]
        detg = spatial_det(g3d)
        vol = torch.sqrt(detg)
        g3u = spatial_inv(g3d, detg)
        ng = self.mesh.mb_indcs.ng
        ndim = len(self.dirs)

        def D1(f, d):
            return fd.d1(f, d, self.idx, ng) if d < ndim \
                else torch.zeros_like(f)

        dalpha = [D1(alpha, d) for d in range(3)]
        dbeta = [[D1(beta_u[a], d) for a in range(3)] for d in range(3)]
        dg = [[D1(g3d[c], d) for c in range(6)] for d in range(3)]

        n = w[:, IDN] / self.ps.mb
        nf = torch.clamp(n, min=self.ps.n_atm)
        Wv = [w[:, IVX + a] for a in range(3)]
        P = w[:, IEN]
        H = w[:, IDN] * self.policy.enthalpy(nf, T)
        Wv_d = lower(Wv, g3d)
        usq = contract(Wv, Wv_d)
        Wsq = 1.0 + usq
        W = torch.sqrt(Wsq)
        isd = 1.0 / vol
        B_u = [bcc[:, a] * isd for a in range(3)]
        Bv = contract(B_u, Wv_d) / W
        B_d = lower(B_u, g3d)
        Bsq = contract(B_u, B_d)
        bsq = Bv * Bv + Bsq / Wsq
        ptot = P + 0.5 * bsq

        E = (H * Wsq + Bsq) - P - 0.5 * bsq
        S_d = [sum(((H * Wsq + Bsq) * Wv[b] / W - Bv * B_u[b])
                   * g3d[sym6(a, b)] for b in range(3)) for a in range(3)]
        S_uu = {}
        for a in range(3):
            for b in range(a, 3):
                S_uu[(a, b)] = ((H + Bsq / Wsq) * Wv[a] * Wv[b]
                                - B_u[a] * B_u[b] / Wsq
                                - Bv * (B_u[a] * Wv[b]
                                        + B_u[b] * Wv[a]) / W
                                + ptot * g3u[sym6(a, b)])

        def suu(a, b):
            return S_uu[(a, b) if a <= b else (b, a)]

        # energy source
        den = sum((alpha * K_dd[sym6(a, b)] * suu(a, b)
                   - g3u[sym6(a, b)] * S_d[a] * dalpha[b])
                  for a in range(3) for b in range(3))
        u[:, 4] += beta_dt * vol * den
        # momentum sources
        for a in range(3):
            dm = sum(0.5 * alpha * suu(b, c) * dg[a][sym6(b, c)]
                     for b in range(3) for c in range(3))
            dm = dm + sum(S_d[b] * dbeta[a][b] for b in range(3))
            dm = dm - E * dalpha[a]
            u[:, 1 + a] += beta_dt * vol * dm
        return u

    # ------------------------------------------------------------- tmunu
    def set_tmunu(self, u, w, bcc, adm):
        """Undensitised stress-energy projections (reference:
        DynGRMHD::SetTmunu, dyn_grmhd.cpp:412-478)."""
        g3d = adm["g3d"]
        detg = spatial_det(g3d)
        ivol = 1.0 / torch.sqrt(detg)
        Wv = [w[:, IVX + a] for a in range(3)]
        v_d = lower(Wv, g3d)              # = W v_d
        iW = 1.0 / torch.sqrt(1.0 + contract(Wv, v_d))
        B_u = [bcc[:, a] * ivol for a in range(3)]
        B_d = lower(B_u, g3d)
        Bv = contract(B_u, v_d)           # W-weighted, as the reference
        Bsq = contract(B_u, B_d)
        bsq = (Bsq + Bv * Bv) * iW * iW
        E = (u[:, 4] + u[:, 0]) * ivol
        S_d = [u[:, 1 + a] * ivol for a in range(3)]
        S_dd = [u[:, 1 + a] * ivol * v_d[b] * iW
                - (B_d[a] + Bv * v_d[a]) * iW * iW * B_d[b]
                + (w[:, IEN] + 0.5 * bsq) * g3d[sym6(a, b)]
                for (a, b) in ((0, 0), (0, 1), (0, 2),
                               (1, 1), (1, 2), (2, 2))]
        return {"E": E, "S_d": S_d, "S_dd": S_dd}

    # --------------------------------------------------- state interface
    def make_state(self, u, w, bfc, T=None, z=None):
        state = {"u": u, "w": w, "bfc": bfc,
                 "bcc": self.compute_bcc(bfc)}
        state["T"] = T if T is not None \
            else torch.zeros(u.shape[:1] + u.shape[2:], dtype=u.dtype,
                             device=u.device)
        if not self.fixed_evolution:
            if z is None:
                raise ValueError("dynamical spacetime needs z4c state")
            state["z"] = z
            if self.nco > 0:
                state["co_pos"] = torch.as_tensor(
                    self.z4c.tracker_pos0, dtype=u.dtype, device=u.device)
        return state

    def post_cycle(self, state, dt):
        """Advance the compact-object trackers on the Z4c shift (see
        ``Z4c.post_cycle``; the tracked field is state['z'])."""
        if self.z4c is None or self.nco == 0 or "co_pos" not in state:
            return state
        from .z4c.z4c import I_BETAX
        from .z4c.z4c_amr import device_interp
        pos = state["co_pos"]
        beta = device_interp(self.mesh, state["z"],
                             [I_BETAX + a for a in range(3)], pos)
        return dict(state, co_pos=pos - dt * beta)

    def save_state(self, state):
        saved = {"u1": state["u"], "bfc1": state["bfc"]}
        if not self.fixed_evolution:
            saved["z1"] = state["z"]
        return saved

    def accumulate_rk4(self, saved, state, delta):
        out = {"u1": saved["u1"] + delta * state["u"],
               "bfc1": {k: saved["bfc1"][k] + delta * state["bfc"][k]
                        for k in saved["bfc1"]}}
        if not self.fixed_evolution:
            out["z1"] = saved["z1"] + delta * state["z"]
        return out

    def init_ghosts(self, state):
        u = self.bvals.fill_ghosts(state["u"])
        bfc = self.fill_ghosts_fc(state["bfc"])
        bcc = self.compute_bcc(bfc)
        out = dict(state)
        if not self.fixed_evolution:
            z = self.bvals.fill_ghosts(state["z"])
            out["z"] = self.z4c.alg_constr(z)
        adm = self.adm_of(out)
        w, T, u, _ = self.cons_to_prim(u, bcc, adm)
        out.update({"u": u, "w": w, "T": T, "bfc": bfc, "bcc": bcc})
        return out

    def restart_ghosts(self, state):
        """The state of a resumed run: the stored one as it is (its
        primitives and temperature are the last stage's; a fresh c2p of
        the re-synced floor cells would move them)."""
        if all(k in state for k in ("w", "T", "bcc")):
            return state
        return self.init_ghosts(state)

    def unpack_state(self, state):
        return state

    # --------------------------------------------------------------- stage
    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        """One interleaved RK stage (reference: QueueDynGRMHDTasks order,
        dyn_grmhd.cpp:150-260): the MHD fluxes -> Tmunu -> the MHD update
        and coordinate sources -> corner EMFs and CT -> the Z4c stage
        with matter -> the fills -> the ADM refresh -> c2p."""
        u, w, T = state["u"], state["w"], state["T"]
        bfc, bcc = state["bfc"], state["bcc"]
        adm = self.adm_of(state)

        flx, fden, emf = self.fluxes(w, T, bcc, bfc, adm)
        tmunu = None if self.fixed_evolution \
            else self.set_tmunu(u, w, bcc, adm)

        u_new = self.rk_update(u, saved["u1"], flx, gam0, gam1, beta_dt)
        u_new = self.coord_src_terms(u_new, w, T, bcc, adm, beta_dt)

        # the transport-velocity cell EMFs E = -(alpha v - beta) x B-tilde
        # (reference: mhd_corner_e.cpp ADM branch), in the Newtonian
        # e1cc = vz*by - vy*bz form
        Wv = [w[:, IVX + a] for a in range(3)]
        v_d = lower(Wv, adm["g3d"])
        iW = 1.0 / torch.sqrt(1.0 + contract(Wv, v_d))
        vt = [adm["alpha"] * Wv[a] * iW - adm["beta_u"][a]
              for a in range(3)]
        bt = [bcc[:, a] for a in range(3)]
        ecc = (bt[1] * vt[2] - bt[2] * vt[1],
               bt[2] * vt[0] - bt[0] * vt[2],
               bt[0] * vt[1] - bt[1] * vt[0])
        e1, e2, e3 = self.corner_e(w, bcc, fden, emf, bfc=bfc, ecc=ecc)
        bfc_new = self.ct_update(bfc, saved["bfc1"], e1, e2, e3,
                                 gam0, gam1, beta_dt)

        out = dict(state)
        if not self.fixed_evolution:
            zstate, _ = self.z4c.stage_update(
                {"u": state["z"]}, {"u1": saved["z1"]},
                gam0, gam1, beta_dt, tmunu=tmunu)
            out["z"] = zstate["u"]

        u_new = self.bvals.fill_ghosts(u_new)
        bfc_new = self.fill_ghosts_fc(bfc_new)
        bcc_new = self.compute_bcc(bfc_new)
        adm_new = self.adm_of(out)
        w_new, T_new, u_new, counters = self.cons_to_prim(
            u_new, bcc_new, adm_new)
        out.update({"u": u_new, "w": w_new, "T": T_new,
                    "bfc": bfc_new, "bcc": bcc_new})
        return out, counters

    # ----------------------------------------------------------------- dt
    def dt_from_state(self, state):
        """Light-speed CFL per direction (the reference's dyngr/GR newdt
        takes unit coordinate speeds, src/mhd/mhd_newdt.cpp GR branch),
        rounded to the state's dtype: a Python float, a mesh constant
        that needs no read from the card."""
        mbi = self.mesh.mb_indcs
        if self.multilevel:
            sz = self.mesh.mb_size
            dt = float(np.min(sz["dx1"]))
            if mbi.nx2 > 1:
                dt = min(dt, float(np.min(sz["dx2"])))
            if mbi.nx3 > 1:
                dt = min(dt, float(np.min(sz["dx3"])))
        else:
            ms = self.mesh.mesh_size
            dt = ms.dx1
            if mbi.nx2 > 1:
                dt = min(dt, ms.dx2)
            if mbi.nx3 > 1:
                dt = min(dt, ms.dx3)
        return torch.tensor(dt, dtype=state["u"].dtype).item()
