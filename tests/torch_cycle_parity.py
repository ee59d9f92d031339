"""Shared harness of the shearing-box, particle and ion-neutral parity
tests (not a test file).

``CyclePair`` runs one deck through both packages on the CPU in float64
for ``ncyc`` whole cycles:

  * the JAX package builds the deck, its initial state may be changed by
    ``perturb`` (numpy, applied to the conserved variables before the
    c2p), ``init_ghosts``, ``dt_from_state`` and its driver's whole
    ``make_cycle_fn`` (the particle push, the orbital advection, the
    stages, the ImEx cycle, the time ``t``) run under ``jax.jit`` at
    XLA's backend optimisation level 0, driven by the port driver's dt
    rule, and with ``outputs`` its outputs are called as its driver calls
    them, in a directory of its own;
  * the port builds the same deck, takes the same ``perturb`` and runs
    its driver for ``ncyc`` cycles (``time/nlim``), with its outputs.

The states are kept as numpy dicts, each package's after its problem
generator (``*_init``), after initialisation (``*_ready``) and after the
cycles.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np

from athenak_tpu import main as jax_main
from athenak_tpu.athinput import ParameterInput as JaxInput
from athenak_tpu_torch import main as torch_main
from athenak_tpu_torch.athinput import ParameterInput
from athenak_tpu_torch.state import state_to_numpy
from torch_deck_parity import JAX_EXTRA, assert_close, assert_states_close
from torch_deck_parity import interior, jit_o0

_HUGE = float(np.finfo(np.float32).max)


def _jax_state(st, phys, u):
    """The JAX state with conserved ``u`` (numpy) and its primitives."""
    uj = jnp.asarray(u)
    if "bcc" in st:
        w, uj, _ = jit_o0(phys.cons_to_prim)(uj, st["bcc"])
    else:
        w, uj, _ = jit_o0(phys.cons_to_prim)(uj)
    return dict(st, u=uj, w=w)


def _port_state(st, phys, u):
    import torch
    ut = torch.as_tensor(u, dtype=phys.dtype, device=phys.device)
    if "bcc" in st:
        w, ut, _ = phys.cons_to_prim(ut, st["bcc"])
    else:
        w, ut, _ = phys.cons_to_prim(ut)
    return dict(st, u=ut, w=w)


def _copy(d):
    """A numpy state dict that shares no memory with the tensors it came
    from (the port's fills write in place)."""
    return jax.tree_util.tree_map(np.array, d)


class _Chdir:
    def __init__(self, path):
        self.path = path

    def __enter__(self):
        self.cwd = os.getcwd()
        if self.path is not None:
            os.makedirs(self.path, exist_ok=True)
            os.chdir(self.path)

    def __exit__(self, *exc):
        os.chdir(self.cwd)


class CyclePair:
    """One deck through both packages (see the module docstring)."""

    def __init__(self, text: str, overrides=(), ncyc: int = 3,
                 rundir=None, outputs: bool = False,
                 perturb=None, split: bool = False) -> None:
        self.text, self.overrides, self.ncyc = text, list(overrides), ncyc
        self.perturb, self.split = perturb, split
        jdir = None if rundir is None else os.path.join(rundir, "jax")
        tdir = None if rundir is None else os.path.join(rundir, "port")
        self.jax_dir, self.port_dir = jdir, tdir
        with _Chdir(jdir):
            self._jax(outputs)
        with _Chdir(tdir):
            self._port(outputs)

    def _jax(self, outputs: bool) -> None:
        from athenak_tpu.outputs import make_outputs
        pj = JaxInput.from_string(self.text)
        pj.modify_from_cmdline(JAX_EXTRA + self.overrides)
        mesh, phys, _, driver, st = jax_main.build(pj)
        if self.perturb is not None:
            st = _jax_state(st, phys, self.perturb(np.array(st["u"])))
        self.jax_mesh, self.jax_phys = mesh, phys
        self.jax_init = jax.tree_util.tree_map(np.asarray, st)
        st = jit_o0(phys.init_ghosts)(st)
        self.jax_ready = jax.tree_util.tree_map(np.asarray, st)
        dt_of = jit_o0(phys.dt_from_state)
        cycle = _split_cycle(driver, dt_of) if self.split \
            else jit_o0(driver.make_cycle_fn())
        dtype = st["u"].dtype
        tlim, cfl = driver.tlim, driver.cfl_no
        dt = min(cfl * float(dt_of(st)), _HUGE)
        if dt > tlim:
            dt = tlim
        mesh.dt = dt
        self.jax_dts = [dt]
        outs = make_outputs(pj, mesh, phys) if outputs else []
        for out in outs:
            out.maybe_write(mesh, st["u"], st["w"], force=True, state=st)
        for _ in range(self.ncyc):
            st, dtnew, _ = cycle(st, jnp.asarray(dt, dtype))
            mesh.time += dt
            mesh.ncycle += 1
            dt = min(2.0 * dt, cfl * float(dtnew))
            if mesh.time < tlim and mesh.time + dt > tlim:
                dt = tlim - mesh.time
            mesh.dt = dt
            self.jax_dts.append(dt)
            if outs and any(out.due(mesh) for out in outs):
                for out in outs:
                    out.maybe_write(mesh, st["u"], st["w"], state=st)
        for out in outs:
            out.maybe_write(mesh, st["u"], st["w"], force=True, state=st)
        self.jax_time = mesh.time
        self.jax_state = jax.tree_util.tree_map(np.asarray, st)

    def _port(self, outputs: bool) -> None:
        from athenak_tpu_torch.outputs import make_outputs
        pt = ParameterInput.from_string(self.text)
        pt.modify_from_cmdline(self.overrides + [f"time/nlim={self.ncyc}"])
        mesh, phys, _, driver, st = torch_main.build(pt, device="cpu")
        if self.perturb is not None:
            st = _port_state(st, phys, self.perturb(
                st["u"].numpy().copy()))
        self.port_init = _copy(state_to_numpy(st))
        outs = make_outputs(pt, mesh, phys, driver) if outputs else []
        st = driver.initialize(st)
        self.port_ready = _copy(state_to_numpy(st))
        st = driver.execute(st, outputs=outs)
        self.mesh, self.phys, self.driver = mesh, phys, driver
        self.state = state_to_numpy(st)

    def check(self, tol=1e-10, ng=2, extra=()):
        """The initial and initialised states to 1e-12, the cycles' state
        and time to ``tol``, the cycle count; ``extra`` names further
        state entries held to ``tol`` of their scale."""
        assert self.mesh.ncycle == self.ncyc
        assert_states_close(self.port_init, self.jax_init, 1e-12, ng)
        assert_states_close(self.port_ready, self.jax_ready, 1e-12, ng)
        assert_states_close(self.state, self.jax_state, tol, ng)
        for k in extra:
            got, ref = self.state[k], self.jax_state[k]
            if np.ndim(ref) >= 5:
                got, ref = interior(got, ng), interior(ref, ng)
            assert_close(got, ref, tol, k, scale=max(
                float(np.abs(ref).max()), 1e-300))
        np.testing.assert_allclose(self.mesh.time, self.jax_time, rtol=tol)
        assert np.isfinite(self.state["u"]).all()
        assert self.state["u"].dtype == np.float64
        return self


def _split_cycle(driver, dt_of):
    """The JAX driver's cycle for a shearing-box deck without forcing
    or particles, in two compiled parts."""
    phys, integ = driver.phys, driver.integrator
    sbox = phys.psbox

    def advect(st, dt):
        u = sbox.orbital_advect(st["u"], dt)
        u = phys.bvals.fill_ghosts(u)
        u = sbox.remap_ghosts(u, st["t"])
        bfc = sbox.orbital_advect_fc(st["bfc"], dt)
        bfc = phys.fill_ghosts_fc(bfc)
        bfc = sbox.remap_ghosts_fc(bfc, st["t"])
        bcc = phys.compute_bcc(bfc)
        w, u, _ = phys.cons_to_prim(u, bcc)
        return dict(st, u=u, w=w, bfc=bfc, bcc=bcc)

    advect = jit_o0(advect)
    stage = jit_o0(lambda s, sv, g0, g1, bdt: phys.stage_update(
        s, sv, g0, g1, bdt)[0])

    def cycle(st, dt):
        st = advect(st, dt)
        saved = phys.save_state(st)
        for s in range(integ.nexp_stages):
            st = stage(st, saved, *(jnp.asarray(v, dt.dtype) for v in (
                integ.gam0[s], integ.gam1[s], integ.beta[s] * dt)))
        st = dict(st, t=st["t"] + dt)
        return st, dt_of(st), None

    return cycle


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()
