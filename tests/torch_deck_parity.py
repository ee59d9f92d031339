"""Shared harness of the deck parity tests of the port (not a test file).

``DeckPair`` runs one athinput deck through both packages on the CPU in
float64 (JAX runs in float64 in this suite, tests/conftest.py):

  * the JAX package builds the deck, its problem generator makes the
    initial state, and its ``init_ghosts``, ``dt_from_state``, turbulence
    forcing and stage run under ``jax.jit`` at XLA's backend
    optimisation level 0 (the stage compiled once, with the RK
    coefficients traced), driven by the port driver's dt rule (2x
    growth, CFL, the stop at tlim) for ``ncyc`` cycles, under RK4 with
    the physics' ``accumulate_rk4`` before every stage after the first
    (eagerly);
  * the port runs the same deck through ``athenak_tpu_torch.main.run``
    with ``time/nlim=ncyc`` in a directory of its own.

Each result is kept: the JAX package's initial state, its state after
initialisation and after the cycles, its time, and the port's objects.
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXTRA = ["mesh/coalesce=false", "mesh/pencil_pack=false"]
_HUGE = float(np.finfo(np.float32).max)


def deck_text(path: str) -> str:
    """The text of a deck of ``inputs/`` (path relative to the repo)."""
    with open(os.path.join(ROOT, path)) as f:
        return f.read()


def deck_literal(fname: str, name: str):
    """A literal assigned at the top level of one of the repo's test
    files (a deck's text), read with ``ast``."""
    import ast
    with open(os.path.join(ROOT, "tests", fname)) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(f"tests/{fname} assigns no {name}")


def read_bin(path):
    """(the header up to the cell data, the rest) of a ``bin`` file."""
    data = open(path, "rb").read()
    i = data.index(b"header offset=")
    j = data.index(b"\n", i)
    off = int(data[i + len(b"header offset="):j])
    return data[:j + 1 + off], data[j + 1 + off:]


def jit_o0(fn):
    """``jax.jit`` at backend optimisation level 0."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def interior(a, ng: int = 2):
    """The interior cells (faces: the interior and its upper face) of a
    cell [nmb, nvar, n3, n2, n1] or face [nmb, n3, n2, n1] array; an axis
    of extent 1 (or 2 for a face axis of a degenerate dimension) is
    kept whole."""
    sl = [slice(None)] * a.ndim
    for ax in range(a.ndim - 3, a.ndim):
        if a.shape[ax] > 2:
            sl[ax] = slice(ng, -ng)
    return a[tuple(sl)]


def assert_close(got, ref, tol, label, scale=None):
    """max |got - ref| <= tol * scale, the scale max |ref| unless given
    (exact equality for a zero reference)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, f"{label}: {got.shape} vs {ref.shape}"
    if scale is None:
        scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max()) if ref.size else 0.0
    assert err <= tol * scale, f"{label}: {err:g} of scale {scale:g}"


def assert_states_close(got, ref, tol, ng=2, keys=("u", "w")):
    """u and w (where both have them) and the face field on the
    interior, each to ``tol`` of its own scale (the face field's: the
    largest of its three components)."""
    for k in keys:
        if k in got and k in ref:
            assert_close(interior(got[k], ng), interior(ref[k], ng), tol, k)
    if "bfc" in ref:
        bmax = max(float(np.abs(v).max()) for v in ref["bfc"].values())
        for c, v in ref["bfc"].items():
            assert_close(interior(got["bfc"][c], ng), interior(v, ng), tol,
                         c, scale=bmax)


class DeckPair:
    """One deck through both packages (see the module docstring)."""

    def __init__(self, text: str, overrides=(), ncyc: int = 3,
                 rundir=None) -> None:
        self.text, self.overrides, self.ncyc = text, list(overrides), ncyc
        self._jax()
        self._port(rundir)

    def _pins(self):
        pj, pt = JaxInput.from_string(self.text), \
            ParameterInput.from_string(self.text)
        pj.modify_from_cmdline(JAX_EXTRA + self.overrides)
        pt.modify_from_cmdline(self.overrides)
        return pj, pt

    def _jax(self) -> None:
        pj, _ = self._pins()
        mesh, phys, pgen, driver, st = jax_main.build(pj)
        self.jax_mesh, self.jax_phys, self.jax_pgen = mesh, phys, pgen
        self.jax_pin = pj
        self.jax_init = jax.tree_util.tree_map(np.asarray, st)
        st = jit_o0(phys.init_ghosts)(st)
        self.jax_ready = jax.tree_util.tree_map(np.asarray, st)
        dt_of = jit_o0(phys.dt_from_state)
        stage = jit_o0(lambda s, sv, g0, g1, bdt: phys.stage_update(
            s, sv, g0, g1, bdt)[0])
        force = jit_o0(lambda s, d: phys.pturb.apply(s, d, phys)) \
            if phys.pturb is not None else None
        integ, dtype = driver.integrator, st["u"].dtype
        tlim, cfl = driver.tlim, driver.cfl_no
        dt = min(cfl * float(dt_of(st)), _HUGE)
        if dt > tlim:
            dt = tlim
        t = 0.0
        self.jax_dts = [dt]
        for _ in range(self.ncyc):
            if force is not None:
                st = force(st, jnp.asarray(dt, dtype))
            saved = phys.save_state(st)
            for s in range(integ.nexp_stages):
                if s > 0 and integ.name == "rk4":
                    # the 2S register, eagerly (one rounding a product
                    # and a sum, as the port's torch ops)
                    saved = phys.accumulate_rk4(saved, st, integ.delta[s])
                st = stage(st, saved, *(jnp.asarray(v, dtype) for v in (
                    integ.gam0[s], integ.gam1[s],
                    integ.beta[s] * jnp.asarray(dt, dtype))))
            t += dt
            dt = min(2.0 * dt, cfl * float(dt_of(st)))
            if t < tlim and t + dt > tlim:
                dt = tlim - t
            self.jax_dts.append(dt)
        self.jax_time = t
        self.jax_state = jax.tree_util.tree_map(np.asarray, st)

    def _port(self, rundir) -> None:
        _, pt = self._pins()
        pt.modify_from_cmdline([f"time/nlim={self.ncyc}"])
        self.port_pin = pt
        cwd = os.getcwd()
        if rundir is not None:
            os.makedirs(rundir, exist_ok=True)
            os.chdir(rundir)
        try:
            mesh, phys, pgen, _, st0 = torch_main.build(
                ParameterInput.from_string(pt.dump()), device="cpu")
            self.port_init = state_to_numpy(st0)
            self.port_ready = state_to_numpy(phys.init_ghosts(st0))
            self.mesh, self.phys, self.driver, st = torch_main.run(
                pt, device="cpu")
        finally:
            os.chdir(cwd)
        self.state = state_to_numpy(st)

    def jax_final(self, tmpdir):
        """Run the JAX problem generator's ``final`` on the JAX state in
        ``tmpdir`` (after the same number of cycles)."""
        cwd = os.getcwd()
        os.chdir(tmpdir)
        try:
            self.jax_mesh.ncycle = self.ncyc
            st = jax.tree_util.tree_map(jnp.asarray, self.jax_state)
            return self.jax_pgen.final(self.jax_pin, self.jax_mesh,
                                       self.jax_phys, st)
        finally:
            os.chdir(cwd)


def check_pair(pair: DeckPair, tol=1e-10, ng=2):
    """The checks every deck takes: the initial state (the problem
    generator and p2c) to 1e-12, the initialised state (fills and c2p)
    to 1e-12, the cycles' state and time to ``tol``, the cycle count."""
    assert pair.mesh.ncycle == pair.ncyc
    assert_states_close(pair.port_init, pair.jax_init, 1e-12, ng)
    assert_states_close(pair.port_ready, pair.jax_ready, 1e-12, ng)
    assert_states_close(pair.state, pair.jax_state, tol, ng)
    np.testing.assert_allclose(pair.mesh.time, pair.jax_time, rtol=tol)
    assert np.isfinite(pair.state["u"]).all()
    assert pair.state["u"].dtype == np.float64
    return pair


class AmrPair:
    """One adaptive deck through both packages' ``main.run`` (the JAX
    package's driver, with its AMR step, block pool or not as the deck
    says, compiled at XLA's backend optimisation level 0), with the leaf
    list of every tree update (``jax_trees`` recorded around the JAX
    package's AMR step, ``trees`` read off the port's ``AMR.updates``:
    lists of (cycle, leaves)) and the dt each cycle chose before its AMR
    step (``jax_dts``, ``dts``)."""

    def __init__(self, text: str, overrides=(), jax_overrides=(),
                 rundir=None) -> None:
        from athenak_tpu import amr as jax_amr
        from athenak_tpu_torch import amr as torch_amr
        import pytest

        self.jax_trees = []
        self.jax_dts, self.dts = [], []
        with pytest.MonkeyPatch.context() as mp:
            for mod, seq, dts in ((jax_amr, self.jax_trees, self.jax_dts),
                                  (torch_amr, None, self.dts)):
                mp.setattr(mod.AMR, "step",
                           _recording(mod.AMR.step, seq, dts))
            mp.setattr(jax, "jit", _jit_o0(jax.jit))
            pj = JaxInput.from_string(text)
            pj.modify_from_cmdline(JAX_EXTRA + list(overrides)
                                   + list(jax_overrides))
            cwd = os.getcwd()
            if rundir is not None:
                os.makedirs(rundir, exist_ok=True)
                os.chdir(rundir)
            try:
                (self.jax_mesh, self.jax_phys, self.jax_driver,
                 st) = jax_main.run(pj)
                self.jax_state = jax.tree_util.tree_map(np.asarray, st)
                pt = ParameterInput.from_string(text)
                pt.modify_from_cmdline(list(overrides))
                self.mesh, self.phys, self.driver, st = torch_main.run(
                    pt, device="cpu")
                self.state = state_to_numpy(st)
            finally:
                os.chdir(cwd)
        self.trees = [(r["ncycle"], r["leaves"])
                      for r in self.driver.pamr.updates]

    def check(self, tol=1e-10, ng=2):
        """The leaf sequence equal at every tree update, the block counts
        created and deleted equal, the state and time to ``tol``."""
        assert self.trees == self.jax_trees
        np.testing.assert_allclose(self.dts, self.jax_dts, rtol=tol)
        assert self.mesh.leaves == [tuple(v) for v in self.jax_mesh.leaves]
        for k in ("nmb_created", "nmb_deleted"):
            assert getattr(self.driver.pamr, k) == \
                getattr(self.jax_driver.pamr, k), k
        assert self.mesh.ncycle == self.jax_mesh.ncycle
        np.testing.assert_allclose(self.mesh.time, self.jax_mesh.time,
                                   rtol=tol)
        assert_states_close(self.state, self.jax_state, tol, ng)
        return self


def _recording(step, seq, dts):
    """``AMR.step`` that appends the cycle's dt to ``dts`` and, unless
    ``seq`` is None, (cycle, leaves) to ``seq`` at every tree update."""
    def wrapped(self, driver, state, outputs=()):
        dts.append(float(driver.mesh.dt))
        state, changed = step(self, driver, state, outputs)
        if changed and seq is not None:
            seq.append((int(driver.mesh.ncycle),
                        [tuple(int(v) for v in leaf)
                         for leaf in driver.mesh.leaves]))
        return state, changed
    return wrapped


def _jit_o0(jit):
    """``jax.jit`` at backend optimisation level 0 (``jit_o0``), for the
    JAX package's driver and AMR step, which compile a cycle for every
    tree."""
    def wrapped(fn=None, **kw):
        opts = dict(kw.pop("compiler_options", None) or {},
                    xla_backend_optimization_level=0)
        return jit(fn, compiler_options=opts, **kw)
    return wrapped


class EagerRun:
    """One Z4c deck through the JAX package outside ``jax.jit`` (a Z4c
    right-hand side is thousands of small operations, each compiled once
    eagerly; ``jax.jit`` is made the identity, so the AMR step's rebuild
    and fills and the waveform output's psi4 run the same way, and the
    fills the rebuild compiles for a new tree serve its cycles): build,
    initialise, then ``ncyc`` cycles of its ``make_cycle_fn`` (the
    puncture trackers' ``post_cycle`` included) with the port driver's
    dt rule, its AMR step after every cycle (every tree update recorded
    in ``trees`` as (cycle, leaves)) and, with ``outputs``, its outputs
    called as its driver calls them, in ``rundir``.  Keeps the final
    state (numpy), time, mesh, physics and driver."""

    def __init__(self, text: str, overrides=(), ncyc: int = 3,
                 outputs: bool = False, rundir=None) -> None:
        import pytest
        from athenak_tpu.outputs import make_outputs

        pin = JaxInput.from_string(text)
        pin.modify_from_cmdline(JAX_EXTRA + list(overrides))
        self.pin = pin
        self.trees = []
        cwd = os.getcwd()
        if rundir is not None:
            os.makedirs(rundir, exist_ok=True)
            os.chdir(rundir)
        try:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax, "jit", lambda f=None, **kw: f)
                self._run(pin, ncyc, make_outputs if outputs else None)
        finally:
            os.chdir(cwd)

    def _run(self, pin, ncyc, make_outputs) -> None:
        mesh, phys, _, driver, st = jax_main.build(pin)
        outs = make_outputs(pin, mesh, phys) if make_outputs else []
        st = driver.initialize(st)
        self.ready = jax.tree_util.tree_map(np.asarray, st)
        for out in outs:
            out.maybe_write(mesh, st["u"], st["w"], force=True, state=st)
        for _ in range(ncyc):
            m = driver.mesh
            cycle = driver.make_cycle_fn()
            st, dtnew, _ = cycle(st, jnp.asarray(m.dt, st["u"].dtype))
            m.time += m.dt
            m.ncycle += 1
            dt = min(2.0 * m.dt, driver.cfl_no * float(dtnew))
            if m.time < driver.tlim and m.time + dt > driver.tlim:
                dt = driver.tlim - m.time
            m.dtold, m.dt = m.dt, dt
            if driver.pamr is not None:
                st, changed = driver.pamr.step(driver, st, outs)
                if changed:
                    m = driver.mesh
                    dtn = float(driver.phys.dt_from_state(st))
                    m.dt = min(m.dt, driver.cfl_no * dtn)
                    self.trees.append((m.ncycle, [
                        tuple(int(v) for v in leaf) for leaf in m.leaves]))
            if outs and any(out.due(m) for out in outs):
                for out in outs:
                    out.maybe_write(m, st["u"], st["w"], state=st)
        for out in outs:
            out.maybe_write(driver.mesh, st["u"], st["w"], force=True,
                            state=st)
        self.mesh, self.phys, self.driver = driver.mesh, driver.phys, driver
        self.state = jax.tree_util.tree_map(np.asarray, st)
        self.time = driver.mesh.time


def port_run(text: str, overrides=(), ncyc: int = 3, rundir=None):
    """The same deck through the port's ``main.run`` on the CPU for
    ``ncyc`` cycles in ``rundir``: (mesh, phys, driver, numpy state)."""
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(list(overrides) + [f"time/nlim={ncyc}"])
    cwd = os.getcwd()
    if rundir is not None:
        os.makedirs(rundir, exist_ok=True)
        os.chdir(rundir)
    try:
        mesh, phys, driver, st = torch_main.run(pin, device="cpu")
    finally:
        os.chdir(cwd)
    return mesh, phys, driver, state_to_numpy(st)


def scaled_err(got, want):
    """max |got - want| / max(|want|, 1), the Z4c tests' measure."""
    want = np.asarray(want)
    return float((np.abs(np.asarray(got) - want)
                  / np.maximum(np.abs(want), 1.0)).max())
