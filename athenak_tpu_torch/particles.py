"""Test particles: the drift pusher, the owner block and the initial draw.

Counterpart of ``athenak_tpu/particles.py`` (reference:
src/particles/particles.hpp:23-95, particles_pushers.cpp:19-59,
bvals_part.cpp, pgen/particles/part_random.cpp).  The reference
snapshot has only the ``drift`` pusher.  The particles are two arrays of
the state, ``prtcl_x`` and ``prtcl_v`` [np, 3], on the run's device at
its dtype; the push is one elementwise update with the periodic wrap,
and migration between blocks is the owner gid recomputed from the
position (``gids``, on the host).

The initial draw is the JAX package's, bit for bit: ``prng.py``'s
threefry stream under ``prng_key(seed)`` and ``split``, mapped to [0, 1)
as ``jax.random.uniform`` maps it.  The JAX package draws at the float
width of ``jax_enable_x64`` (float64 in its CPU tests, float32 on the
TPU by default); the port draws at the deck's precision, float64 as
shipped and float32 under ``job/precision=single``, which is what the
JAX package does in each of those two settings.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng


def uniform(key, shape, dtype):
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1)."""
    return prng.uniform_bits(key, shape, dtype) - 1.0


def _fmod_floor(a, b):
    """``jnp.mod``: the C remainder moved into the divisor's sign."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


class Particles:
    """The ``<particles>`` block."""

    def __init__(self, pin, mesh, device, dtype) -> None:
        self.mesh = mesh
        self.device = torch.device(device)
        self.dtype = dtype
        self.particle_type = pin.get_or_add_string(
            "particles", "particle_type", "cosmic_ray")
        self.pusher = pin.get_or_add_string("particles", "pusher", "drift")
        if self.pusher != "drift":
            raise NotImplementedError(
                "only the drift pusher exists in the reference snapshot "
                "(reference: particles_pushers.cpp:32-51)")
        ppc = pin.get_or_add_real("particles", "ppc", 1.0)
        mbi = mesh.mb_indcs
        ncells = mbi.nx1 * max(mbi.nx2, 1) * max(mbi.nx3, 1)
        self.nprtcl = max(1, int(ppc * mesh.nmb_total * ncells))
        self.ntrack = pin.get_or_add_integer("particles", "ntrack", 10)

        ms = mesh.mesh_size
        self._xmin = np.array([ms.x1min, ms.x2min, ms.x3min])
        self._xmax = np.array([ms.x1max, ms.x2max, ms.x3max])
        self._mb_width = np.array([mbi.nx1 * ms.dx1, mbi.nx2 * ms.dx2,
                                   mbi.nx3 * ms.dx3])
        self._nmb_xyz = np.array([mesh.nmb_x1, mesh.nmb_x2, mesh.nmb_x3])
        # (lx1, lx2, lx3) -> gid of the root grid
        lut = np.zeros((mesh.nmb_x3, mesh.nmb_x2, mesh.nmb_x1),
                       dtype=np.int32)
        if not mesh.multilevel:
            for gid, loc in enumerate(mesh.lloc_eachmb):
                lut[loc[2], loc[1], loc[0]] = gid
        self._gid_lut = lut
        self._xmin_t = torch.as_tensor(self._xmin, dtype=dtype,
                                       device=self.device)
        self._span_t = torch.as_tensor(self._xmax - self._xmin, dtype=dtype,
                                       device=self.device)

    # ------------------------------------------------------------------
    def init_state_entries(self, dtype, seed: int = 0):
        """Random positions over the domain and velocities in [-1, 1)
        (reference: pgen/particles/part_random.cpp), drawn on the host."""
        kx, kv = prng.split(prng.prng_key(seed))
        shape = (self.nprtcl, 3)
        span = self._xmax - self._xmin
        pos = self._xmin + span * uniform(kx, shape, dtype).numpy()
        vel = 2.0 * (uniform(kv, shape, dtype).numpy() - 0.5)
        return {
            "prtcl_x": torch.as_tensor(pos, dtype=dtype, device=self.device),
            "prtcl_v": torch.as_tensor(vel, dtype=dtype, device=self.device),
        }

    # ------------------------------------------------------------------
    def push(self, state, dt):
        """Drift with the periodic wrap.  The reference's two half drifts
        around the particle communication compose into one full drift
        when migration is a gather."""
        x, v = state["prtcl_x"], state["prtcl_v"]
        # x + dt v as one fused multiply-add, as XLA's fused loop forms it
        # on the CPU and nvcc forms addcmul's on the card
        x = torch.addcmul(x, v, torch.as_tensor(dt, dtype=x.dtype,
                                                device=x.device))
        x = self._xmin_t + _fmod_floor(x - self._xmin_t, self._span_t)
        return dict(state, prtcl_x=x)

    # ------------------------------------------------------------------
    def gids(self, x):
        """The owner gid of each particle (the migration step's
        destination, reference: bvals_part.cpp), on the host: the root
        grid's table on a uniform mesh, the containing leaf on a refined
        one."""
        xi = x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)
        if self.mesh.multilevel:
            sz = self.mesh.mb_size
            lo = np.stack([sz["x1min"], sz["x2min"], sz["x3min"]], axis=1)
            hi = np.stack([sz["x1max"], sz["x2max"], sz["x3max"]], axis=1)
            inside = np.all((xi[:, None, :] >= lo[None])
                            & (xi[:, None, :] <= hi[None]), axis=-1)
            return np.argmax(inside, axis=1).astype(np.int32)
        loc = np.floor((xi - self._xmin) / self._mb_width).astype(np.int64)
        loc = np.clip(loc, 0, self._nmb_xyz - 1)
        return self._gid_lut[loc[:, 2], loc[:, 1], loc[:, 0]]

    # ------------------------------------------------------------------
    def new_dt(self) -> float:
        """The time to cross the finest cell at |v| <= 1 (reference:
        part_random.cpp:82-86)."""
        from .diffusion import _dx_min
        mbi = self.mesh.mb_indcs
        dt = _dx_min(self.mesh, "x1")
        if mbi.nx2 > 1:
            dt = min(dt, _dx_min(self.mesh, "x2"))
        if mbi.nx3 > 1:
            dt = min(dt, _dx_min(self.mesh, "x3"))
        return dt
