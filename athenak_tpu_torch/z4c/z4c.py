"""Z4c evolution system (vacuum) with puncture gauge.

Counterpart of ``athenak_tpu/z4c/z4c.py`` (reference: src/z4c/z4c.hpp,
z4c_calcrhs.cpp, z4c_gauge.cpp, z4c.cpp:254-310 AlgConstr,
z4c_newdt.cpp): the conformal Z4 formulation of Bernuzzi & Hilditch
(2010) with 22 evolved fields (chi, conformal metric, Khat = K - 2 Theta,
traceless A_ij, Gamma^i, Theta, 1+log lapse, gamma-driver shift),
Kreiss-Oliger dissipation, Sommerfeld rows on outflow-type faces and the
algebraic constraint projection.  ``u`` is [nmb, 22, n3, n2, n1] with
ghosts.

A stage runs one of two paths.  On the card in float32, on a uniform 3-D
mesh (``ops/z4c_stage.py``'s gate: one level), it takes the stage kernel
(``csrc/z4c_rhs.cuh``): RHS, RK combine and AlgConstr in one launch, then
the outflow fill kernel on a single block with six outflow faces, or the
general fill.  Everywhere else (the CPU, float64) the whole-array torch
path runs: ``rhs``, the combine, ``bvals.fill_ghosts``, ``alg_constr``.
``<z4c>/use_kernels = false`` keeps a run on the torch path.

On a refined mesh (static, or adaptive once its tree has refined) the
torch path runs with per-block inverse spacings ([nmb, 1, 1, 1] tensors,
``idx``), the mixed-level fills prolong with 4th-order Lagrange
(``bvals.prolong_order = 4``, which needs nghost >= 4) and dt comes from
the smallest block spacing.

The puncture trackers (``<z4c>/nco > 0``) are device state:
``state["co_pos"]`` is an [nco, 3] tensor at the state's dtype on the
run's device, moved once a cycle by ``post_cycle`` (dx/dt = -beta(x),
the shift interpolated trilinearly on the card by
``z4c_amr.device_interp``); only the AMR check and the outputs read it
back.  ``adm_constraints`` computes the Hamiltonian and momentum
constraint monitors in torch ops.

The matter coupling of dynamical GRMHD (``stage_update(tmunu=...)``)
takes the torch path whatever the gate, as the JAX package's does
(``athenak_tpu/z4c/z4c.py:496-497``): kernel H has no matter source.
The TPU's row packing is layout for the TPU's lanes and has no
counterpart here: the state is always the logical 5-D array.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..bvals import kernel_dtype_ok
from ..comm import LocalAttr, local_blocks
from ..graphs import Graphed
from . import fd

# evolved-variable channel indices (reference: z4c.hpp:46-56)
I_CHI = 0
I_GXX, I_GXY, I_GXZ, I_GYY, I_GYZ, I_GZZ = 1, 2, 3, 4, 5, 6
I_KHAT = 7
I_AXX, I_AXY, I_AXZ, I_AYY, I_AYZ, I_AZZ = 8, 9, 10, 11, 12, 13
I_GAMX, I_GAMY, I_GAMZ = 14, 15, 16
I_THETA = 17
I_ALPHA = 18
I_BETAX, I_BETAY, I_BETAZ = 19, 20, 21
NZ4C = 22

_SYM = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 1): 3, (1, 2): 4, (2, 2): 5}


def sym_idx(a, b):
    return _SYM[(a, b) if a <= b else (b, a)]


def _sym_pairs():
    return [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]


def spatial_det(g):
    """det of a symmetric 3x3 field given as list-of-lists of tensors."""
    return (g[0][0] * (g[1][1] * g[2][2] - g[1][2] * g[1][2])
            - g[0][1] * (g[0][1] * g[2][2] - g[0][2] * g[1][2])
            + g[0][2] * (g[0][1] * g[1][2] - g[0][2] * g[1][1]))


def spatial_inv(g, detg):
    """Inverse of a symmetric 3x3 field (list-of-lists)."""
    i = 1.0 / detg
    gu = [[None] * 3 for _ in range(3)]
    gu[0][0] = (g[1][1] * g[2][2] - g[1][2] * g[1][2]) * i
    gu[0][1] = (g[0][2] * g[1][2] - g[0][1] * g[2][2]) * i
    gu[0][2] = (g[0][1] * g[1][2] - g[0][2] * g[1][1]) * i
    gu[1][1] = (g[0][0] * g[2][2] - g[0][2] * g[0][2]) * i
    gu[1][2] = (g[0][1] * g[0][2] - g[0][0] * g[1][2]) * i
    gu[2][2] = (g[0][0] * g[1][1] - g[0][1] * g[0][1]) * i
    gu[1][0], gu[2][0], gu[2][1] = gu[0][1], gu[0][2], gu[1][2]
    return gu


def adm_from_z4c(z4c, u):
    """Pointwise ADM variables from the Z4c state (reference:
    Z4c::Z4cToADM, z4c_adm.cpp; the JAX package's
    ``dyngr.adm_from_z4c``): gamma_ij = g-tilde_ij / chi and K_ij =
    (A-tilde_ij + g-tilde_ij K / 3) / chi with chi = psi^-4, as lists of
    the six components (xx, xy, xz, yy, yz, zz), with alpha and beta^i."""
    chi, g, khat, A, gam, theta, alpha, beta = z4c.unpack(u)
    chi_g = torch.clamp(chi, min=z4c.opt.chi_min_floor)
    oopsi4 = chi_g ** (-4.0 / z4c.opt.chi_psi_power)   # = chi for -4
    K = khat + 2.0 * theta
    g3d = [g[a][b] / oopsi4 for (a, b) in _sym_pairs()]
    K_dd = [(A[a][b] + g[a][b] * K / 3.0) / oopsi4 for (a, b) in _sym_pairs()]
    return {"g3d": g3d, "alpha": alpha, "beta_u": beta, "K_dd": K_dd}


class Z4cOptions:
    def __init__(self, pin) -> None:
        gor = pin.get_or_add_real
        self.chi_psi_power = gor("z4c", "chi_psi_power", -4.0)
        self.chi_div_floor = gor("z4c", "chi_div_floor", -1000.0)
        self.chi_min_floor = gor("z4c", "chi_min_floor", 1e-12)
        self.diss = gor("z4c", "diss", 0.0)
        self.eps_floor = gor("z4c", "eps_floor", 1e-12)
        self.damp_kappa1 = gor("z4c", "damp_kappa1", 0.0)
        self.damp_kappa2 = gor("z4c", "damp_kappa2", 0.0)
        self.lapse_harmonicf = gor("z4c", "lapse_harmonicf", 1.0)
        self.lapse_harmonic = gor("z4c", "lapse_harmonic", 0.0)
        self.lapse_oplog = gor("z4c", "lapse_oplog", 2.0)
        self.lapse_advect = gor("z4c", "lapse_advect", 1.0)
        self.shift_ggamma = gor("z4c", "shift_Gamma", 1.0)
        self.shift_advect = gor("z4c", "shift_advect", 1.0)
        self.shift_alpha2ggamma = gor("z4c", "shift_alpha2Gamma", 0.0)
        self.shift_hh = gor("z4c", "shift_H", 0.0)
        self.shift_eta = gor("z4c", "shift_eta", 2.0)
        self.use_z4c = 1.0 if pin.get_or_add_boolean(
            "z4c", "use_z4c", True) else 0.0


class Z4c:
    """Vacuum Z4c evolution on the block-pool layout."""

    # the inverse cell sizes, per block on a refined mesh, read as the
    # running cycle's rows (comm.LocalAttr)
    idx = LocalAttr()

    def __init__(self, pin, mesh, bvals, device, dtype) -> None:
        self.mesh = mesh
        self.bvals = bvals
        self.device = torch.device(device)
        self.dtype = dtype
        self.opt = Z4cOptions(pin)
        self.multilevel = mesh.multilevel
        mbi = mesh.mb_indcs
        self.ng = mbi.ng
        if self.ng not in (2, 3, 4, 5):
            raise ValueError("Z4c requires nghost in {2,3,4,5} "
                             "(2nd/4th/6th/8th-order FD)")
        ms = mesh.mesh_size
        if self.multilevel:
            # per-block (level-dependent) inverse spacings, broadcast
            # against the [nmb, n3, n2, n1] channel fields
            self.idx = tuple(torch.as_tensor(
                1.0 / mesh.mb_size[f"dx{d}"], dtype=dtype,
                device=self.device).reshape(-1, 1, 1, 1) for d in (1, 2, 3))
            if self.ng < 4:
                raise ValueError(
                    "Z4c on refined meshes needs nghost >= 4 (4th-order "
                    "mixed-level prolongation; reference: "
                    "prolongation.hpp:247-283)")
            bvals.prolong_order = 4
        else:
            self.idx = (1.0 / ms.dx1, 1.0 / ms.dx2, 1.0 / ms.dx3)
        # dissipation scale (reference: z4c.cpp:158)
        self.diss = (self.opt.diss * 2.0 ** (-2.0 * self.ng)
                     * (-1.0 if self.ng % 2 == 0 else 1.0))
        self.shape = (mesh.nmb_total, NZ4C,
                      mbi.ncells3, mbi.ncells2, mbi.ncells1)
        # compact-object (puncture) trackers: positions are device state
        # (state["co_pos"]) moved on the device each cycle; radius and
        # reflevel feed the <z4c_amr> tracker criterion (reference:
        # src/z4c/compact_object_tracker.cpp:66-73)
        self.nco = pin.get_or_add_integer("z4c", "nco", 0)
        self.tracker_pos0 = np.array(
            [[pin.get_or_add_real("z4c", f"co_{n}_x", 0.0),
              pin.get_or_add_real("z4c", f"co_{n}_y", 0.0),
              pin.get_or_add_real("z4c", f"co_{n}_z", 0.0)]
             for n in range(self.nco)], dtype=np.float64).reshape(-1, 3)
        self.tracker_radius = np.array(
            [pin.get_or_add_real("z4c", f"co_{n}_radius", 0.0)
             for n in range(self.nco)])
        self.tracker_reflevel = np.array(
            [pin.get_or_add_integer("z4c", f"co_{n}_reflevel", -1)
             for n in range(self.nco)], dtype=np.int64)

        # Sommerfeld boundary mask: outermost active layer of blocks whose
        # mesh face is outflow/diode/vacuum/user (reference:
        # Z4c::Z4cBoundaryRHS, z4c_Sbc.cpp:127-210)
        sbc_flags = ("outflow", "diode", "vacuum", "user")
        mask = np.zeros((mesh.nmb_total, mbi.ncells3, mbi.ncells2,
                         mbi.ncells1), dtype=bool)
        any_sbc = False
        layers = {
            "x1m": (slice(None), slice(None), slice(mbi.is_, mbi.is_ + 1)),
            "x1p": (slice(None), slice(None), slice(mbi.ie, mbi.ie + 1)),
            "x2m": (slice(None), slice(mbi.js, mbi.js + 1), slice(None)),
            "x2p": (slice(None), slice(mbi.je, mbi.je + 1), slice(None)),
            "x3m": (slice(mbi.ks, mbi.ks + 1), slice(None), slice(None)),
            "x3p": (slice(mbi.ke, mbi.ke + 1), slice(None), slice(None)),
        }
        face_of = {"x1m": "ix1", "x1p": "ox1", "x2m": "ix2", "x2p": "ox2",
                   "x3m": "ix3", "x3p": "ox3"}
        for key, sl in layers.items():
            if mesh.mesh_bcs[face_of[key]] in sbc_flags:
                any_sbc = True
                for gid in np.where(mesh.phys_bc_mask[key])[0]:
                    mask[(gid,) + sl] = True
        self.sbc_mask = mask if any_sbc else None
        if self.sbc_mask is not None:
            # pseudo-radial unit vector and radius at cell centres
            nmb = mesh.nmb_total
            xc = np.empty((nmb, 1, 1, mbi.ncells1))
            yc = np.empty((nmb, 1, mbi.ncells2, 1))
            zc = np.empty((nmb, mbi.ncells3, 1, 1))
            for gid in range(nmb):
                x1v, x2v, x3v = mesh.cell_centers(gid)
                xc[gid, 0, 0, :] = x1v
                yc[gid, 0, :, 0] = x2v
                zc[gid, :, 0, 0] = x3v
            self._sbc_xyz = (xc, yc, zc)
        self._sbc_dev = {}

        # the stage kernel (ops/z4c_stage.py): the port's counterpart of
        # <z4c>/use_pallas; float32 on the card is checked per call
        use_kernels = pin.get_or_add_boolean("z4c", "use_kernels", True)
        from ..ops.z4c_stage import fold_bc_supported, supports_z4c_stage
        self.use_stage_kernel = use_kernels and supports_z4c_stage(self,
                                                                   mesh)
        self.fold_bc = self.use_stage_kernel and fold_bc_supported(bvals)
        if not use_kernels:
            bvals.use_fill_kernel = False
            bvals.use_pool_fill = False
        # the RHS with the matter source (the dyngr stage) is replayed
        # from a CUDA graph: bitwise the eager RHS, from one host launch
        self._matter_rhs = Graphed(
            lambda u, tmunu: self.rhs(u, tmunu=tmunu))

    def kernel_path(self, u) -> bool:
        """True when a stage on ``u`` runs the stage kernel."""
        return self.use_stage_kernel and kernel_dtype_ok(u)

    # ------------------------------------------------------------------
    @staticmethod
    def unpack(u):
        """Channel views as python structures of 4-D tensors."""
        chi = u[:, I_CHI]
        g = [[u[:, I_GXX + sym_idx(a, b)] for b in range(3)]
             for a in range(3)]
        khat = u[:, I_KHAT]
        A = [[u[:, I_AXX + sym_idx(a, b)] for b in range(3)]
             for a in range(3)]
        gam = [u[:, I_GAMX + a] for a in range(3)]
        theta = u[:, I_THETA]
        alpha = u[:, I_ALPHA]
        beta = [u[:, I_BETAX + a] for a in range(3)]
        return chi, g, khat, A, gam, theta, alpha, beta

    # ------------------------------------------------------------------
    def rhs(self, u, time=0.0, tmunu=None):
        """Full Z4c right-hand side (reference: Z4c::CalcRHS,
        z4c_calcrhs.cpp:180-590) on whole-array roll stencils."""
        from .rhs_core import rhs_core
        ops = _WholeArrayOps(self, [u[:, I_BETAX + a] for a in range(3)],
                             u.device, u.dtype)
        out = rhs_core(lambda c: u[:, c], ops, self.opt, self.diss,
                       tmunu=tmunu)
        return torch.stack(out, dim=1)

    # ------------------------------------------------------------------
    def alg_constr(self, u):
        """det(conformal g)=1 and tr A=0 projection, then the chi floor
        (reference: Z4c::AlgConstr, z4c.cpp:258-310).  Returns a new
        tensor.  torch has no cbrt: ``x ** (1/3)`` stands for it here,
        within an ulp or two of the cube root that the JAX package and
        the stage kernel take."""
        chi, g, khat, A, gam, theta, alpha, beta = self.unpack(u)
        detg = spatial_det(g)
        detg = torch.where(detg > 0.0, detg, torch.ones_like(detg))
        oopsi4 = (1.0 / detg) ** (1.0 / 3.0)
        gs = [[g[a][b] * oopsi4 for b in range(3)] for a in range(3)]
        gu = spatial_inv(gs, torch.ones_like(detg))
        trA = sum(gu[a][b] * A[a][b] for a in range(3) for b in range(3))
        out = u.clone()
        for a, b in _sym_pairs():
            out[:, I_GXX + sym_idx(a, b)] = gs[a][b]
            out[:, I_AXX + sym_idx(a, b)] = (
                A[a][b] - (1.0 / 3.0) * gs[a][b] * trA)
        out[:, I_CHI] = torch.clamp(chi, min=self.opt.chi_min_floor)
        return out

    # ------------------------------------------------------------------
    def coords_bcast(self):
        """Per-block cell-centre coordinates as broadcastable float64
        host arrays ([nmb, 1, 1, n1], [nmb, 1, n2, 1], [nmb, n3, 1, 1]),
        made once."""
        if getattr(self, "_coords_bcast", None) is None:
            mesh = self.mesh
            mbi = mesh.mb_indcs
            nmb = mesh.nmb_total
            xc = np.empty((nmb, 1, 1, mbi.ncells1))
            yc = np.empty((nmb, 1, mbi.ncells2, 1))
            zc = np.empty((nmb, mbi.ncells3, 1, 1))
            for gid in range(nmb):
                x1v, x2v, x3v = mesh.cell_centers(gid)
                xc[gid, 0, 0, :] = x1v
                yc[gid, 0, :, 0] = x2v
                zc[gid, :, 0, 0] = x3v
            self._coords_bcast = (xc, yc, zc)
        return self._coords_bcast

    # ------------------------------------------------------------------
    def adm_constraints(self, u, full: bool = False):
        """Hamiltonian and momentum constraint monitors (reference:
        z4c_calculate_adm_constraints.cpp; the JAX package's
        ``Z4c.adm_constraints``, term for term).  Returns (H, M2), M2 the
        squared norm of the momentum constraint; with ``full`` a dict that
        also holds the covariant momentum components M_d, the Z violation
        (z4c_adm.cpp:511-517) and the monitor C = H^2 + M^2 + Theta^2 +
        4Z (z4c_adm.cpp:519-520).  Valid on the interior."""
        opt = self.opt
        ng = self.ng
        idx = self.idx
        chi, g, khat, A, gam, theta, alpha, beta = self.unpack(u)

        def D1(f, d):
            return fd.d1(f, d, idx, ng)

        K = khat + 2.0 * theta
        detg = spatial_det(g)
        gu = spatial_inv(g, detg)
        dg = [[[D1(g[a][b], d) for b in range(3)] for a in range(3)]
              for d in range(3)]
        dchi = [D1(chi, d) for d in range(3)]
        dkhat = [D1(khat, d) for d in range(3)]
        dtheta = [D1(theta, d) for d in range(3)]
        dgam = [[D1(gam[a], d) for a in range(3)] for d in range(3)]
        Gddd = [[[0.5 * (dg[a][b][c] + dg[b][a][c] - dg[c][a][b])
                  for b in range(3)] for a in range(3)] for c in range(3)]
        Gudd = [[[sum(gu[c][d] * Gddd[d][a][b] for d in range(3))
                  for b in range(3)] for a in range(3)] for c in range(3)]
        gam_c = [sum(gu[b][c] * Gudd[a][b][c]
                     for b in range(3) for c in range(3)) for a in range(3)]

        chi_g = torch.clamp(chi, min=opt.chi_min_floor)
        oopsi4 = chi_g ** (-4.0 / opt.chi_psi_power)
        npow = opt.chi_psi_power
        dphi = [dchi[a] / (chi_g * npow) for a in range(3)]

        ddg = {}
        for a, b in itertools.combinations_with_replacement(range(3), 2):
            for c, d in _sym_pairs():
                if a == b:
                    ddg[(a, b, c, d)] = fd.d2(g[c][d], a, idx, ng)
                else:
                    ddg[(a, b, c, d)] = fd.d1d1(g[c][d], a, b, idx, ng)

        def DDg(a, b, c, d):
            a, b = (a, b) if a <= b else (b, a)
            c, d = (c, d) if c <= d else (d, c)
            return ddg[(a, b, c, d)]

        ddchi = [[fd.d2(chi, a, idx, ng) if a == b
                  else fd.d1d1(chi, min(a, b), max(a, b), idx, ng)
                  for b in range(3)] for a in range(3)]

        Rdd = [[None] * 3 for _ in range(3)]
        for a, b in _sym_pairs():
            # Gam^c (Gamma_{a,bc} + Gamma_{b,ac}): index placement of
            # rhs_core.py / z4c_calcrhs.cpp:309-311
            r = sum(0.5 * (g[c][a] * dgam[b][c] + g[c][b] * dgam[a][c]
                           + gam_c[c] * (Gddd[a][b][c] + Gddd[b][a][c]))
                    for c in range(3))
            r = r - sum(0.5 * gu[c][d] * DDg(c, d, a, b)
                        for c in range(3) for d in range(3))
            r = r + sum(gu[c][d] * (Gudd[e][c][a] * Gddd[b][e][d]
                                    + Gudd[e][c][b] * Gddd[a][e][d]
                                    + Gudd[e][a][d] * Gddd[e][c][b])
                        for c in range(3) for d in range(3)
                        for e in range(3))
            Rdd[a][b] = r
            Rdd[b][a] = r
        Ddphi = [[None] * 3 for _ in range(3)]
        for a, b in _sym_pairs():
            v = (ddchi[a][b] / (chi_g * npow) - npow * dphi[a] * dphi[b]
                 - sum(Gudd[c][a][b] * dphi[c] for c in range(3)))
            Ddphi[a][b] = v
            Ddphi[b][a] = v
        trDdphi = sum(gu[c][d] * (Ddphi[c][d] + 2.0 * dphi[c] * dphi[d])
                      for c in range(3) for d in range(3))
        Rphi = [[4.0 * dphi[a] * dphi[b] - 2.0 * Ddphi[a][b]
                 - 2.0 * g[a][b] * trDdphi for b in range(3)]
                for a in range(3)]

        AA = sum(gu[a][c] * gu[b][d] * A[a][b] * A[c][d]
                 for a in range(3) for b in range(3)
                 for c in range(3) for d in range(3))
        R = sum(oopsi4 * gu[a][b] * (Rdd[a][b] + Rphi[a][b])
                for a in range(3) for b in range(3))
        H = R + (2.0 / 3.0) * K * K - AA

        dA = [[[fd.d1(A[a][b], d, idx, ng) for b in range(3)]
               for a in range(3)] for d in range(3)]
        M = []
        for a in range(3):
            v = sum(gu[b][c] * (dA[b][c][a]
                                - sum(Gudd[e][b][c] * A[e][a]
                                      + Gudd[e][b][a] * A[c][e]
                                      for e in range(3)))
                    for b in range(3) for c in range(3))
            v = v - (3.0 / 2.0) * sum(
                gu[b][c] * A[c][a] * dchi[b] / chi_g for b in range(3)
                for c in range(3))
            v = v - (2.0 / 3.0) * (dkhat[a] + 2.0 * dtheta[a])
            M.append(v)
        M2 = sum(gu[a][b] * M[a] * M[b] for a in range(3) for b in range(3))
        if not full:
            return H, M2
        Z = 0.25 * sum(g[a][b] * (gam[a] - gam_c[a]) * (gam[b] - gam_c[b])
                       for a in range(3) for b in range(3))
        C = H * H + M2 + theta * theta + 4.0 * Z
        return {"H": H, "M2": M2, "M_d": M, "Z": Z, "C": C}

    # ------------------------------------------------- state-dict interface
    def make_state(self, u):
        state = {"u": u, "w": u}
        if self.nco > 0:
            state["co_pos"] = torch.as_tensor(self.tracker_pos0,
                                              dtype=u.dtype, device=u.device)
        return state

    def post_cycle(self, state, dt):
        """After the stages: advance the puncture trackers one Euler step
        of dx/dt = -beta(x) with the cycle's final shift (reference:
        CompactObjectTracker::InterpolateShift + EvolveTracker,
        compact_object_tracker.cpp:100-150), on the device; ``dt`` is the
        cycle's dt, a 0-d tensor in the state's dtype."""
        if self.nco == 0:
            return state
        if "co_pos" not in state:
            raise ValueError(
                f"<z4c>/nco = {self.nco} but the state holds no 'co_pos' "
                "(a restart file written without the trackers?)")
        from .z4c_amr import device_interp
        pos = state["co_pos"]
        beta = device_interp(self.mesh, state["u"],
                             [I_BETAX + a for a in range(3)], pos)
        return dict(state, co_pos=pos - dt * beta)

    def save_state(self, state):
        return {"u1": state["u"]}

    def accumulate_rk4(self, saved, state, delta):
        return {"u1": saved["u1"] + delta * state["u"]}

    def unpack_state(self, state):
        """The state as outputs read it: nothing is packed."""
        return state

    def init_ghosts(self, state):
        u = self.bvals.fill_ghosts(state["u"])
        u = self.alg_constr(u)
        return dict(state, u=u, w=u)

    def restart_ghosts(self, state):
        """The ghost fill of a resumed run.  A stored state ended its last
        stage projected and filled, and the projection is not idempotent
        to the last bit, so the restart fills without projecting again and
        continues the straight run bitwise (the JAX package projects
        again; ROADMAP F11)."""
        u = self.bvals.fill_ghosts(state["u"])
        return dict(state, u=u, w=u)

    def cons_to_prim(self, u):
        return u, u, {}

    def sbc_channels(self, device, dtype):
        """[nmb, 5, n3, n2, n1] (mask, r, s_x, s_y, s_z) Sommerfeld
        geometry on ``device`` at ``dtype``: made in float64 on the host
        and cast once, then kept.  The stage kernel and the torch path
        read the same tensor; the running cycle's rows (pads clone
        block 0's)."""
        key = (str(torch.device(device)), dtype)
        if key not in self._sbc_dev:
            xc, yc, zc = self._sbc_xyz
            r = np.sqrt(xc * xc + yc * yc + zc * zc)
            nmb, n3, n2, n1 = self.sbc_mask.shape
            ch = np.zeros((nmb, 5, n3, n2, n1))
            ch[:, 0] = self.sbc_mask
            ch[:, 1] = r
            ch[:, 2] = np.broadcast_to(xc / r, (nmb, n3, n2, n1))
            ch[:, 3] = np.broadcast_to(yc / r, (nmb, n3, n2, n1))
            ch[:, 4] = np.broadcast_to(zc / r, (nmb, n3, n2, n1))
            self._sbc_dev[key] = torch.as_tensor(ch, dtype=dtype,
                                                 device=device)
        return local_blocks(self._sbc_dev[key])

    def stage_update(self, state, saved, gam0, gam1, beta_dt, tmunu=None):
        """One RK stage: RHS -> update -> halo -> algebraic constraints
        (reference task chain: z4c_tasks.cpp:48-85).  On the kernel path
        the projection comes before the fill; it is pointwise, so the two
        orders agree on a uniform mesh.  ``tmunu`` (the fluid's
        stress-energy) closes the kernel path."""
        u = state["u"]
        if tmunu is None and self.kernel_path(u):
            from ..ops.z4c_stage import fused_z4c_stage, outflow_fill
            u = fused_z4c_stage(u, saved["u1"], self, gam0, gam1, beta_dt)
            # the user hook is checked again here: generators install it
            # after the physics is built (the JAX z4c.py:503)
            fold = self.fold_bc and self.bvals.user_bc_func is None
            u = outflow_fill(u, self.bvals) if fold \
                else self.bvals.fill_ghosts(u)
            return dict(state, u=u, w=u), {}
        rhs = self.rhs(u) if tmunu is None else self._matter_rhs(u, tmunu)
        u = gam0 * u + gam1 * saved["u1"] + beta_dt * rhs
        u = self.bvals.fill_ghosts(u)
        u = self.alg_constr(u)
        return dict(state, u=u, w=u), {}

    def dt_from_state(self, state):
        """dt = min cell size over the blocks (unit light speed,
        reference: z4c_newdt.cpp:26-60; a uniform mesh's ``mb_size``
        holds its spacing for every block), rounded to the
        state's dtype as the JAX package returns it.  A Python float: dt
        is a mesh constant, so the cycle needs no read-back from the
        card."""
        mbi = self.mesh.mb_indcs
        sz = self.mesh.mb_size
        dx = [float(np.min(sz[f"dx{d}"])) for d in (1, 2, 3)]
        dt = dx[0]
        if mbi.nx2 > 1:
            dt = min(dt, dx[1])
        if mbi.nx3 > 1:
            dt = min(dt, dx[2])
        return torch.tensor(dt, dtype=state["u"].dtype).item()


class _WholeArrayOps:
    """Whole-array FD backend for rhs_core: torch.roll stencils over
    [nmb, n3, n2, n1] channel fields (fd.py operators)."""

    def __init__(self, z, beta, device, dtype):
        self._z = z
        self._beta = beta
        self._idx = z.idx
        self._ng = z.ng
        self._device = device
        self._dtype = dtype

    def d1(self, f, d):
        return fd.d1(f, d, self._idx, self._ng)

    def d2(self, f, da, db):
        if da == db:
            return fd.d2(f, da, self._idx, self._ng)
        return fd.d1d1(f, min(da, db), max(da, db), self._idx, self._ng)

    def ladv(self, f):
        out = None
        for d in range(3):
            t = fd.adv(self._beta[d], f, d, self._idx, self._ng)
            out = t if out is None else out + t
        return out

    def ko(self, f):
        out = None
        for d in range(3):
            t = fd.ko_diss(f, d, self._idx, self._ng)
            out = t if out is None else out + t
        return out

    def d1_o2(self, f, d):
        return fd.d1(f, d, self._idx, 2)

    @staticmethod
    def center(f):
        return f

    def sbc(self):
        z = self._z
        if z.sbc_mask is None:
            return None
        ch = z.sbc_channels(self._device, self._dtype)
        return (ch[:, 0] != 0.0, ch[:, 1], (ch[:, 2], ch[:, 3], ch[:, 4]))
