"""Ornstein-Uhlenbeck turbulence driving.

Counterpart of ``athenak_tpu/turb_driver.py`` (reference:
src/srcterms/turb_driver.cpp:40-1206): a solenoidal force built from
Gaussian Fourier amplitudes on shells nlow <= |n| <= nhigh with spectrum
|a_k| ~ k^-(expo+2)/2, net-momentum removal, amplitude normalisation to
a fixed energy-injection rate dedt, OU time correlation (white noise if
tcorr = 0), applied once per cycle before the time integrator.

The mode table, the coordinate tables and the volume weights are built
in numpy exactly as the JAX package builds them; the force is the same
sum over modes of A_k cos(k.x) + B_k sin(k.x), mode by mode in the same
order.

Random numbers: the JAX package's stream.  The state carries the
threefry key ``turb_key`` from ``<turb_driving>/seed`` as the JAX package
carries it; each cycle splits it, and the force field splits its subkey
into the keys of its two Gaussian amplitude sets (``prng.py``, integer
arithmetic on the run's device), so a driven run follows the JAX
package's realisation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import prng
from .comm import global_sum, local_blocks
from .indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ


class TurbulenceDriver:
    def __init__(self, pin, mesh, device) -> None:
        self.mesh = mesh
        self.device = torch.device(device)
        self.nlow = pin.get_or_add_integer("turb_driving", "nlow", 1)
        self.nhigh = pin.get_or_add_integer("turb_driving", "nhigh", 2)
        self.driving_type = pin.get_or_add_integer(
            "turb_driving", "driving_type", 0)
        self.expo = pin.get_or_add_real("turb_driving", "expo", 5.0 / 3.0)
        self.dedt = pin.get_or_add_real("turb_driving", "dedt", 0.0)
        self.tcorr = pin.get_or_add_real("turb_driving", "tcorr", 0.0)
        self.seed = pin.get_or_add_integer("turb_driving", "seed", 0)
        if self.driving_type != 0:
            raise NotImplementedError(
                "only isotropic driving (driving_type=0) is implemented")

        ms = mesh.mesh_size
        lx = ms.x1max - ms.x1min
        ly = ms.x2max - ms.x2min
        lz = ms.x3max - ms.x3min
        dk = (2.0 * math.pi / lx, 2.0 * math.pi / ly, 2.0 * math.pi / lz)

        # mode table: one entry per +/- pair (nk in a half-space)
        kvecs = []
        norms = []
        n2lo, n2hi = self.nlow ** 2, self.nhigh ** 2
        for nkx in range(0, self.nhigh + 1):
            for nky in range(-self.nhigh, self.nhigh + 1):
                for nkz in range(-self.nhigh, self.nhigh + 1):
                    if nkx == 0 and (nky < 0 or (nky == 0 and nkz <= 0)):
                        continue  # half-space: avoid double-counting
                    nsqr = nkx * nkx + nky * nky + nkz * nkz
                    if not (n2lo <= nsqr <= n2hi):
                        continue
                    k = (dk[0] * nkx, dk[1] * nky, dk[2] * nkz)
                    kiso = math.sqrt(k[0] ** 2 + k[1] ** 2 + k[2] ** 2)
                    kvecs.append(k)
                    norms.append(kiso ** (-(self.expo + 2.0) / 2.0))
        if not kvecs:
            raise ValueError("no driving modes in [nlow, nhigh]")
        self.kvec = np.array(kvecs)            # [nmode, 3]
        self.norm = np.array(norms)            # [nmode]
        self.nmode = len(kvecs)

        # broadcastable cell-centre coordinates (host constants)
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
        self.xc, self.yc, self.zc = xc, yc, zc
        self.shape = (nmb, 3, mbi.ncells3, mbi.ncells2, mbi.ncells1)

        # per-block fractional cell volume [nmb, 1, 1, 1], the weight of
        # every volume integral below (reference: turb_driver.cpp:717+)
        vol = (np.asarray(mesh.mb_size["dx1"])
               * np.asarray(mesh.mb_size["dx2"])
               * np.asarray(mesh.mb_size["dx3"]))
        self.wvol = (vol / (vol.sum() * mbi.nx1 * mbi.nx2 * mbi.nx3)
                     ).reshape(-1, 1, 1, 1)
        self._tables = {}

    # ------------------------------------------------------------------
    def init_state_entries(self, dtype):
        return {"turb_force": torch.zeros(self.shape, dtype=dtype,
                                          device=self.device),
                "turb_key": prng.prng_key(self.seed, self.device)}

    def _table(self, name: str, dtype):
        """Host table ``name`` on the run's device at ``dtype``, copied
        there once."""
        key = (name, dtype)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(
                getattr(self, name), dtype=dtype, device=self.device)
        return self._tables[key]

    # ------------------------------------------------------------------
    def _synthesize(self, key, dtype):
        """New solenoidal Gaussian force field [nmb, 3, n3, n2, n1] from
        the threefry key ``key``."""
        ka, kb = prng.split(key)
        a = prng.normal(ka, (self.nmode, 3), dtype)
        b = prng.normal(kb, (self.nmode, 3), dtype)
        kv = self._table("kvec", dtype)
        nrm = self._table("norm", dtype)
        ksq = torch.sum(kv * kv, dim=1, keepdim=True)
        # solenoidal projection: a -> a - (k.a) k / k^2
        a = (a - kv * torch.sum(kv * a, dim=1, keepdim=True) / ksq) \
            * nrm[:, None]
        b = (b - kv * torch.sum(kv * b, dim=1, keepdim=True) / ksq) \
            * nrm[:, None]

        # the running cycle's blocks
        xc = local_blocks(self._table("xc", dtype))
        yc = local_blocks(self._table("yc", dtype))
        zc = local_blocks(self._table("zc", dtype))
        force = torch.zeros((xc.shape[0],) + self.shape[1:], dtype=dtype,
                            device=self.device)
        for m in range(self.nmode):
            phase = kv[m, 0] * xc + kv[m, 1] * yc + kv[m, 2] * zc
            c = torch.cos(phase)[:, None]
            s = torch.sin(phase)[:, None]
            force = force + (a[m][None, :, None, None, None] * c
                             + b[m][None, :, None, None, None] * s)
        return force

    # ------------------------------------------------------------------
    def apply(self, state, dt, phys):
        """One cycle of driving: synthesize -> de-mean -> normalize -> OU
        blend -> add momentum/energy -> remove net momentum.  Returns a
        new state dict; the tensors of ``state`` are not written."""
        u = state["u"]
        w = state["w"]
        dtype = u.dtype
        mbi = self.mesh.mb_indcs
        act = (slice(None), slice(None),
               slice(mbi.ks, mbi.ke + 1),
               slice(mbi.js, mbi.je + 1),
               slice(mbi.is_, mbi.ie + 1))

        key, sub = prng.split(state["turb_key"])
        ftmp = self._synthesize(sub, dtype)

        den = u[:, IDN]
        dact = (slice(None), slice(mbi.ks, mbi.ke + 1),
                slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
        den_a = den[dact]
        wv = local_blocks(self._table("wvol", dtype))

        # remove net momentum injection (reference: turb_driver.cpp:717-755)
        t0 = global_sum(torch.sum(wv * den_a))
        for c in range(3):
            tc = global_sum(torch.sum(wv * den_a * ftmp[act][:, c]))
            ftmp[:, c] += -tc / t0

        # normalize to dedt (reference: turb_driver.cpp:757-812)
        fa = ftmp[act]
        mom = u[act][:, IM1:IM3 + 1]
        t0 = global_sum(torch.sum(wv * den_a * torch.sum(fa * fa, dim=1)))
        t1 = global_sum(torch.sum(wv * torch.sum(mom * fa, dim=1)))
        m0 = torch.clamp(0.5 * t0 * dt, min=1.0e-20)
        m1 = t1
        # quadratic for s:  m0 s^2 + m1 s = dedt
        disc = torch.sqrt(m1 * m1 / (4.0 * m0 * m0) + self.dedt / m0)
        s = torch.where(m1 >= 0, -m1 / (2.0 * m0) + disc,
                        m1 / (2.0 * m0) + disc)
        ftmp = ftmp * s

        # OU blend (reference: turb_driver.cpp:830-872)
        if self.tcorr <= 1e-6:
            force = ftmp
        else:
            # on the host in float64, from dt as the cycle holds it
            fcorr = math.exp(-float(dt) / self.tcorr)
            gcorr = math.sqrt(1.0 - fcorr * fcorr)
            force = fcorr * state["turb_force"] + gcorr * ftmp

        # apply forcing: dM = rho f dt, dE = f . M dt / rho ~ rho f.v dt
        vx, vy, vz = w[:, IVX], w[:, IVY], w[:, IVZ]
        fv = (force[:, 0] * vx + force[:, 1] * vy + force[:, 2] * vz)
        u = u.clone()
        den = u[:, IDN]
        u[:, IM1] += den * force[:, 0] * dt
        u[:, IM2] += den * force[:, 1] * dt
        u[:, IM3] += den * force[:, 2] * dt
        if phys.eos.is_ideal:
            u[:, IEN] += fv * den * dt

        # remove residual net momentum (reference: turb_driver.cpp:1138-1200)
        t0 = global_sum(torch.sum(wv * u[act][:, IDN]))
        for im in (IM1, IM2, IM3):
            tc = global_sum(torch.sum(wv * u[act][:, im]))
            u[:, im] += -den * tc / t0

        return dict(state, u=u, turb_force=force, turb_key=key)
