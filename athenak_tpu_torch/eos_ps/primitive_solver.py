"""Relativistic primitive solver (Kastaun-style mu root) on whole tensors.

Counterpart of ``athenak_tpu/eos_ps/primitive_solver.py`` (reference:
``PrimitiveSolver<EOSPolicy, ErrorPolicy>``,
src/eos/primitive-solver/primitive_solver.hpp): the per-point
Anderson-Bjorck false-position root solve runs over whole tensors, every
cell stepping in lockstep for the same fixed trip counts as the JAX
package's ``lax.fori_loop``s (a bracketing Newton solve for the upper
bound, then false position, then bisection).  The loops never stop
early: bisection keeps narrowing a converged bracket, so only the fixed
trips give the JAX package's values.  The error policy is the
reference's ``ResetFloor`` (reset_floor.hpp): failed and atmosphere
cells get floor primitives and their conserved state is re-synced with
prim_to_con.

All geometry is given as 6-channel symmetric metrics
[g_xx, g_xy, g_xz, g_yy, g_yz, g_zz] broadcastable against the fields.
The velocity primitive is Wv^i = u^i (the reference's "utilde").

On CUDA tensors ``con_to_prim`` is replayed from a CUDA graph
(``graphs.Graphed``): its some 7,700 small launches a call make a small
grid's cycle host-bound, and the replay runs the same kernels, so the
values are bitwise the eager call's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graphs import Graphed
from .policies import clamp

SYM = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_IDX = {(0, 0): 0, (0, 1): 1, (0, 2): 2, (1, 0): 1, (1, 1): 3,
        (1, 2): 4, (2, 0): 2, (2, 1): 4, (2, 2): 5}


def sym6(a, b):
    return _IDX[(a, b)]


def lower(v_u, g3d):
    return [sum(g3d[sym6(a, b)] * v_u[b] for b in range(3))
            for a in range(3)]


def raise_(v_d, g3u):
    return [sum(g3u[sym6(a, b)] * v_d[b] for b in range(3))
            for a in range(3)]


def contract(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def spatial_det(g3d):
    gxx, gxy, gxz, gyy, gyz, gzz = g3d
    return (gxx * (gyy * gzz - gyz * gyz)
            - gxy * (gxy * gzz - gyz * gxz)
            + gxz * (gxy * gyz - gyy * gxz))


def spatial_inv(g3d, detg=None):
    gxx, gxy, gxz, gyy, gyz, gzz = g3d
    if detg is None:
        detg = spatial_det(g3d)
    i = 1.0 / detg
    return [(gyy * gzz - gyz * gyz) * i,
            (gxz * gyz - gxy * gzz) * i,
            (gxy * gyz - gyy * gxz) * i,
            (gxx * gzz - gxz * gxz) * i,
            (gxy * gxz - gxx * gyz) * i,
            (gxx * gyy - gxy * gxy) * i]


class PrimitiveSolverPS:
    """ConToPrim/PrimToCon on undensitised ADM-slice variables."""

    def __init__(self, policy, dfloor: float = 1e-12,
                 tfloor: float = 0.0, pfloor: Optional[float] = None,
                 v_max: float = 0.9999, threshold: float = 1.0,
                 n_newton: int = 20, n_falsepos: int = 30,
                 n_bisect: int = 30) -> None:
        self.eos = policy
        self.mb = policy.mb
        self.n_atm = dfloor / policy.mb
        self.threshold = threshold
        # temperature floor: from pfloor if given (ideal-like), else tfloor
        if pfloor is not None and tfloor == 0.0:
            self.t_atm_from_p = pfloor
        else:
            self.t_atm_from_p = None
        self.t_atm = tfloor
        self.v_max = v_max
        self.n_newton = n_newton
        self.n_falsepos = n_falsepos
        self.n_bisect = n_bisect
        self._c2p_graph = Graphed(self._con_to_prim)

    @classmethod
    def from_input(cls, policy, pin, block: str) -> "PrimitiveSolverPS":
        return cls(policy,
                   dfloor=pin.get_or_add_real(block, "dfloor", 1e-12),
                   tfloor=pin.get_or_add_real(block, "tfloor", 0.0),
                   pfloor=pin.get_or_add_real(block, "pfloor", 1e-15),
                   v_max=pin.get_or_add_real(block, "dyn_vmax", 0.9999),
                   threshold=pin.get_or_add_real(
                       block, "dthreshold", 1.0))

    # ------------------------------------------------------------------
    def _atm_T(self, n):
        if self.t_atm_from_p is not None:
            return self.eos.temperature_from_p(
                torch.clamp(n, min=self.n_atm), self.t_atm_from_p
                * torch.ones_like(n))
        return torch.full_like(n, self.t_atm)

    # ------------------------------------------------------------------
    def prim_to_con(self, n, Wv_u, P, T, B_u, g3d):
        """(reference: primitive_solver.hpp PrimToCon :553-616).
        Returns (D, S_d[3], tau), undensitised."""
        eos = self.eos
        Wv_d = lower(Wv_u, g3d)
        Wvsq = contract(Wv_u, Wv_d)
        Wsq = 1.0 + Wvsq
        W = torch.sqrt(Wsq)
        iW = 1.0 / W
        v_d = [Wv_d[a] * iW for a in range(3)]
        B_d = lower(B_u, g3d)
        Bsq = contract(B_u, B_d)
        Bv = contract(B_u, v_d)
        H = n * eos.enthalpy(n, T) * 1.0  # enthalpy density (mb inside)
        HWsq = H * Wsq
        D = n * self.mb * W
        HWsqpb = HWsq + Bsq
        S_d = [HWsqpb * v_d[a] - Bv * B_d[a] for a in range(3)]
        tau = HWsqpb - P - 0.5 * (Bv * Bv + Bsq * iW * iW) - D
        return D, S_d, tau

    # ------------------------------------------------------------------
    def _root_f(self, mu, D, q, bsq, rsq, rbsq, Y):
        """RootFunctor (reference: primitive_solver.hpp:87-165):
        f(mu) = mu - muhat and the (n, T, P) estimates at mu."""
        eos = self.eos
        x = 1.0 / (1.0 + mu * bsq)
        musq = mu * mu
        rbarsq = x * (rsq * x + mu * (x + 1.0) * rbsq)
        qbar = q - 0.5 * bsq - 0.5 * musq * x * x * (bsq * rsq - rbsq)
        h_min = eos.min_enthalpy()
        vsq_max = torch.clamp(rsq / (h_min * h_min + rsq),
                              max=self.v_max * self.v_max)
        vhatsq = torch.minimum(musq * rbarsq, vsq_max)
        iWhat = torch.sqrt(torch.clamp(1.0 - vhatsq, min=1e-30))
        nhat = clamp(D * iWhat / self.mb, eos.min_n, eos.max_n)
        eoverD = qbar - mu * rbarsq + 1.0
        ehat = D * eoverD
        That = eos.temperature_from_e(nhat, ehat, Y)
        That = clamp(That, eos.min_T, eos.max_T)
        ehat = eos.energy(nhat, That, Y)
        Phat = eos.pressure(nhat, That, Y)
        hhat = (ehat + Phat) / (self.mb * nhat)
        nu_a = hhat * iWhat
        nu_b = (D * eoverD + Phat) / D
        nuhat = torch.maximum(nu_a, nu_b)
        muhat = 1.0 / (nuhat + mu * rbarsq)
        return mu - muhat, nhat, That, Phat

    def _upper_f(self, mu, bsq, rsq, rbsq, h_min):
        """UpperRootFunctor (reference: primitive_solver.hpp:35-62)."""
        x = 1.0 / (1.0 + mu * bsq)
        xsq = x * x
        rbarsq = rsq * xsq + mu * x * (1.0 + x) * rbsq
        dis = torch.sqrt(h_min * h_min + rbarsq)
        dx = -bsq * xsq
        drbarsq = rbsq * xsq + mu * rbsq * dx \
            + x * (rbsq + 2.0 * (mu * rbsq + rsq) * dx)
        f = mu * dis - 1.0
        df = dis + mu * drbarsq / (2.0 * dis)
        return f, df

    # ------------------------------------------------------------------
    def con_to_prim(self, D, S_d, tau, B_u, g3d, g3u, Y=None):
        """(reference: primitive_solver.hpp ConToPrim :331-550).

        Returns dict(n, Wv_u, P, T, D, S_d, tau, nfloor, nfail) with the
        conserved variables re-synced where floors fired; the counts are
        0-d tensors on the fields' device.  CUDA fields go through the
        CUDA graph of the same solve."""
        return self._c2p_graph(D, S_d, tau, B_u, g3d, g3u, Y)

    def _con_to_prim(self, D, S_d, tau, B_u, g3d, g3u, Y=None):
        eos = self.eos
        mb = self.mb

        d_atm = mb * self.n_atm
        atm = D <= d_atm * self.threshold
        Ds = torch.clamp(D, min=d_atm)

        sqrtD = torch.sqrt(Ds)
        b_u = [B_u[a] / sqrtD for a in range(3)]
        r_d = [S_d[a] / Ds for a in range(3)]
        r_u = raise_(r_d, g3u)
        rsq = torch.clamp(contract(r_u, r_d), min=0.0)
        rb = contract(b_u, r_d)
        rbsq = rb * rb
        b_d = lower(b_u, g3d)
        bsq = torch.clamp(contract(b_u, b_d), min=0.0)
        q = tau / Ds

        h_min = eos.min_enthalpy()
        # ---- a tighter upper bound where rsq > h_min^2 (masked
        # NewtonSafe), n_newton trips
        lo = torch.zeros_like(Ds)
        hi = torch.full_like(Ds, 1.0 / h_min)
        mu = 0.5 * (lo + hi)
        for _ in range(self.n_newton):
            f, df = self._upper_f(mu, bsq, rsq, rbsq, h_min)
            lo = torch.where(f < 0.0, mu, lo)
            hi = torch.where(f >= 0.0, mu, hi)
            step = mu - f / torch.where(torch.abs(df) > 1e-30, df, 1.0)
            inside = (step > lo) & (step < hi)
            mu = torch.where(inside, step, 0.5 * (lo + hi))
        muh = torch.where(rsq > h_min * h_min,
                          mu * (1.0 + 1e-10), 1.0 / h_min)

        # ---- Anderson-Bjorck false position for f(mu) = mu - muhat
        a = torch.zeros_like(Ds)
        b = muh
        fa, _, _, _ = self._root_f(a, Ds, q, bsq, rsq, rbsq, Y)
        fb, _, _, _ = self._root_f(b, Ds, q, bsq, rsq, rbsq, Y)
        # f(0) < 0 always.  fb < 0 means the root sits above the tight
        # upper bound (near-cold states where h -> h_min make root and
        # bound nearly coincide, reference: primitive_solver.hpp:471-476);
        # widen back to the universal bound 1/h_min and re-evaluate.
        wide = torch.full_like(Ds, 1.0 / h_min)
        f_wide, _, _, _ = self._root_f(wide, Ds, q, bsq, rsq, rbsq, Y)
        b = torch.where(fb <= 0.0, wide, b)
        fb = torch.where(fb <= 0.0, f_wide, fb)
        # truly degenerate: the root numerically at the bound
        collided = fb <= 0.0
        # bracket invariant f(a) <= 0 <= f(b); the updates test the sign
        # of fx itself (a product test degenerates once fa underflows to
        # 0 at convergence)
        side = torch.zeros_like(Ds)  # +1: last test matched lower, -1 upper
        for _ in range(self.n_falsepos):
            denom = torch.where(torch.abs(fb - fa) > 1e-30, fb - fa, 1.0)
            x = (fb * a - fa * b) / denom
            fx, _, _, _ = self._root_f(x, Ds, q, bsq, rsq, rbsq, Y)
            low_side = fx <= 0.0
            # Anderson-Bjorck weighting on same-side repeats
            m_hi = 1.0 - fx / torch.where(torch.abs(fa) > 1e-30, fa, 1.0)
            m_hi = torch.where(m_hi > 0.0, m_hi, 0.5)
            m_lo = 1.0 - fx / torch.where(torch.abs(fb) > 1e-30, fb, 1.0)
            m_lo = torch.where(m_lo > 0.0, m_lo, 0.5)
            fb_new = torch.where(low_side & (side == 1.0), fb * m_hi, fb)
            fa_new = torch.where(~low_side & (side == -1.0), fa * m_lo, fa)
            a = torch.where(low_side, x, a)
            fa = torch.where(low_side, fx, fa_new)
            b = torch.where(low_side, b, x)
            fb = torch.where(low_side, fb_new, fx)
            side = torch.where(low_side, 1.0, -1.0)

        # bisection polish: Anderson-Bjorck can stall on derivative kinks
        # (piecewise-polytrope piece boundaries); bisection keeps halving
        for _ in range(self.n_bisect):
            mid = 0.5 * (a + b)
            fm, _, _, _ = self._root_f(mid, Ds, q, bsq, rsq, rbsq, Y)
            low_side = fm <= 0.0
            a = torch.where(low_side, mid, a)
            fa = torch.where(low_side, fm, fa)
            b = torch.where(low_side, b, mid)
            fb = torch.where(low_side, fb, fm)
        # prefer the exactly-converged endpoint over the bracket midpoint
        x = torch.where(fa == 0.0, a, torch.where(fb == 0.0, b,
                                                  0.5 * (a + b)))

        mu_root = torch.where(collided, b, x)
        _, n, T, P = self._root_f(mu_root, Ds, q, bsq, rsq, rbsq, Y)

        # ---- primitives
        rho = n * mb
        W = Ds / rho
        Wmux = W * mu_root / (1.0 + mu_root * bsq)
        rbmu = rb * mu_root
        Wv_u = [Wmux * (r_u[a] + rbmu * b_u[a]) for a in range(3)]

        # ---- ResetFloor error policy (reference: reset_floor.hpp):
        # atmosphere where the solve failed or n fell below the floor
        bad = atm | ~torch.isfinite(mu_root) \
            | (n < self.n_atm * self.threshold)
        n_out = torch.where(bad, self.n_atm, n)
        T_atm = self._atm_T(n_out)
        T_out = torch.where(bad, T_atm, torch.clamp(T, min=eos.min_T))
        P_out = torch.where(bad, eos.pressure(n_out, T_out, Y),
                            torch.clamp(P, min=0.0))
        Wv_out = [torch.where(bad, 0.0, Wv_u[a]) for a in range(3)]

        # re-sync the conserved state wherever anything fired
        Dn, S_dn, taun = self.prim_to_con(n_out, Wv_out, P_out, T_out,
                                          B_u, g3d)
        D_out = torch.where(bad, Dn, D)
        S_out = [torch.where(bad, S_dn[a], S_d[a]) for a in range(3)]
        tau_out = torch.where(bad, taun, tau)

        return {"n": n_out, "Wv_u": Wv_out, "P": P_out, "T": T_out,
                "D": D_out, "S_d": S_out, "tau": tau_out,
                "nfloor": torch.sum(bad),
                "nfail": torch.sum(bad & ~atm)}
