"""The batched cycle window against the JAX package's own.

A run with no outputs, not verbose, without adaptive mesh, turbulence
driving or particles takes the JAX driver's batched window
(``athenak_tpu/driver.py`` ``_build_batch_cycle``: k = 16 cycles a
dispatch with the dt chain on the device in the state's dtype) and the
port's (``athenak_tpu_torch/driver.py`` ``_run_window``).  Each case runs
one deck through both packages' ``Driver.execute`` on the CPU (the JAX
side compiled at XLA's backend optimisation level 0) and holds, in
float64, the state to 1e-10 of each field's scale on the interior, time
and dt to rtol 1e-12, and the cycle count and counters equal.  The MHD
blast is shifted by 0.3 of a cell (ROADMAP F4) and runs kernel A's route
in its plain version, the Z4c deck kernel H's (their gates opened for
CPU tensors).  The JAX window runs one more batch than the port's (its
lookahead, all cycles inactive): both packages' inactive cycles are
no-ops to well below that tolerance.

Also: float32 runs follow JAX's float32 chain of t and dt, where the
per-cycle loop keeps them in float64 on the host (ROADMAP F32); the
window is bitwise the port's per-cycle loop in float64; ``execute``
chooses the window where the JAX driver does; the reason each closed
configuration gives for running its window eagerly; and the plain
versions of kernels A, C, D, E and H give the same bits for the step as
a 0-d tensor as for the step as a Python float.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import chip_smoke  # noqa: E402
from athenak_tpu import driver as jax_driver  # noqa: E402
from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu_torch import driver as torch_driver  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.physics import mhd as torch_mhd  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from athenak_tpu_torch.z4c import z4c as torch_z4c  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (JAX_EXTRA, assert_states_close,  # noqa: E402
                               deck_text)

SOD = "inputs/hydro/sod.athinput"
BLAST = "inputs/mhd/blast.athinput"
PUNCTURE = "inputs/z4c/one_puncture.athinput"
CUT3 = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
# 0.3 of a cell off the blast's mirror planes (ROADMAP F4)
SHIFT = ["mesh/x1min=-0.9625", "mesh/x1max=1.0375", "mesh/x2min=-0.9625",
         "mesh/x2max=1.0375", "mesh/x3min=-0.9625", "mesh/x3max=1.0375"]
F64 = ["job/precision=double"]
CASES = {
    # deck, overrides, the kernel gate opened, the window's k
    "sod": (SOD, ["time/nlim=40"], None, 16),
    "blast_a": (BLAST, F64 + CUT3 + SHIFT + ["time/nlim=20"], "mhd", 16),
    "z4c_h": (PUNCTURE, F64 + CUT3 + ["time/nlim=5"], "z4c", 5),
    "sr": ("inputs/srhydro/mb1.athinput", ["time/nlim=24"], None, 16),
    # no nlim: the window lands on tlim inside its second batch
    "tlim": (SOD, ["time/tlim=0.04"], None, 16),
    "nlim_lt_k": (SOD, ["time/nlim=5"], None, 5),
}


class _JaxO0:
    """The JAX driver module's ``jax`` with ``jit`` at XLA's backend
    optimisation level 0 (the same program, compiled faster)."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kw):
        return jax.jit(fn, compiler_options={
            "xla_backend_optimization_level": 0}, **kw)


@pytest.fixture
def jax_o0(monkeypatch):
    monkeypatch.setattr(jax_driver, "jax", _JaxO0())


def open_gate(monkeypatch, gate):
    """Kernel A's (``mhd``) or H's (``z4c``) gate opened for CPU tensors:
    the wrapper then runs the kernel's plain version."""
    mod = {"mhd": torch_mhd, "z4c": torch_z4c}.get(gate)
    if mod is not None:
        monkeypatch.setattr(mod, "kernel_dtype_ok", lambda t: True)


def jax_run(text, overrides):
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + list(overrides))
    mesh, _, _, driver, st = jax_main.build(pj)
    st = driver.initialize(st)
    st = driver.execute(st)
    return {"mesh": mesh, "driver": driver,
            "state": jax.tree_util.tree_map(np.asarray, st)}


def port_run(text, overrides, verbose=False):
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(list(overrides))
    mesh, phys, _, driver, st = torch_main.build(pt, device="cpu")
    st = driver.initialize(st)
    route = phys.stage_route(st["u"]) if hasattr(phys, "stage_route") \
        else None
    kpath = phys.kernel_path(st["u"]) if hasattr(phys, "kernel_path") \
        else None
    with contextlib.redirect_stdout(io.StringIO()):
        st = driver.execute(st, verbose=verbose)
    return {"mesh": mesh, "driver": driver, "phys": phys, "route": route,
            "kernel_path": kpath, "state": state_to_numpy(st)}


def check_against_jax(port, jx, ng, tol=1e-10):
    pm, jm = port["mesh"], jx["mesh"]
    assert pm.ncycle == jm.ncycle
    assert_states_close(port["state"], jx["state"], tol, ng)
    np.testing.assert_allclose(pm.time, jm.time, rtol=1e-12)
    np.testing.assert_allclose(pm.dt, jm.dt, rtol=1e-12)
    pc, jc = port["driver"].ecounters, jx["driver"].ecounters
    assert {k: int(v) for k, v in pc.items()} == \
        {k: int(v) for k, v in jc.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_window_matches_jax(case, jax_o0, monkeypatch, one_torch_thread):
    path, extra, gate, k = CASES[case]
    text = deck_text(path)
    open_gate(monkeypatch, gate)
    port = port_run(text, extra)
    w = port["driver"].window
    assert w is not None and w["k"] == k and not w["graph"]
    assert w["closed"] == "the state lies on the CPU"
    if gate == "mhd":
        assert port["route"] == "A"
    if gate == "z4c":
        assert port["kernel_path"]
    jx = jax_run(text, extra)
    check_against_jax(port, jx, port["mesh"].mb_indcs.ng)
    if case == "tlim":
        assert port["mesh"].time == port["driver"].tlim
        assert w["batches"] >= 2 and port["mesh"].ncycle % 16 != 0


def test_float32_follows_the_jax_chain(jax_o0, one_torch_thread):
    """Sod in float32, 40 cycles: the window's time and dt are float32
    numbers on a float32 chain as JAX's are (within two float32 ulps of
    JAX's, whose dtnew comes from its own float32 state; the state within
    1e-5 of each field's scale: XLA's and torch's float32 rounding part
    over 40 cycles), while the per-cycle loop's time is the float64 sum on the
    host, which is no float32 number (ROADMAP F32)."""
    text, extra = deck_text(SOD), ["job/precision=single", "time/nlim=40"]
    port = port_run(text, extra)
    loop = port_run(text, extra, verbose=True)
    # the JAX package's single precision is x64 off (its main.py)
    jax.config.update("jax_enable_x64", False)
    try:
        jx = jax_run(text, extra)
    finally:
        jax.config.update("jax_enable_x64", True)
    assert port["state"]["u"].dtype == jx["state"]["u"].dtype == np.float32
    pm, lm, jm = port["mesh"], loop["mesh"], jx["mesh"]
    assert pm.ncycle == lm.ncycle == jm.ncycle == 40
    assert_states_close(port["state"], jx["state"], 1e-5, 2)
    for t in (pm.time, pm.dt, jm.time, jm.dt):
        assert float(np.float32(t)) == t
    # each package's dtnew from its own float32 state may part by an ulp
    for a, b in ((pm.time, jm.time), (pm.dt, jm.dt)):
        assert abs(a - b) <= 2 * float(np.spacing(np.float32(b)))
    assert float(np.float32(lm.time)) != lm.time
    assert lm.time != pm.time
    np.testing.assert_allclose(lm.time, pm.time, rtol=1e-6)


def test_window_is_bitwise_the_loop_in_float64(monkeypatch,
                                               one_torch_thread):
    """The shifted 16^3 blast on kernel A's route (its plain version), 20
    cycles: the window (two batches, the second with inactive cycles)
    against the per-cycle loop, every array, time, dt and the counters
    equal."""
    open_gate(monkeypatch, "mhd")
    text, extra = deck_text(BLAST), F64 + CUT3 + SHIFT + ["time/nlim=20"]
    win = port_run(text, extra)
    loop = port_run(text, extra, verbose=True)
    assert win["driver"].window["batches"] == 2
    assert loop["driver"].window is None
    for key, ref in loop["state"].items():
        got = win["state"][key]
        if isinstance(ref, dict):
            for c in ref:
                np.testing.assert_array_equal(got[c], ref[c])
        else:
            np.testing.assert_array_equal(got, ref)
    assert win["mesh"].time == loop["mesh"].time
    assert win["mesh"].dt == loop["mesh"].dt
    assert win["driver"].ecounters == loop["driver"].ecounters


class _Window(Exception):
    pass


class _Loop(Exception):
    pass


class _Output:
    """An output that writes nothing (the initial write is forced)."""

    def maybe_write(self, *args, **kwargs):
        pass

    def due(self, mesh):
        return False


def _raise(exc):
    def fn(*args, **kwargs):
        raise exc
    return fn


PATHS = {
    "plain": (SOD, [], False, False),
    "outputs": (SOD, [], True, False),
    "verbose": (SOD, [], False, True),
    "amr": ("inputs/hydro/blast_hydro_amr.athinput", CUT3, False, False),
    "turbulence": ("inputs/turb/turb.athinput", CUT3, False, False),
    "particles": ("inputs/particles/random_drift.athinput", [], False,
                  False),
}


@pytest.mark.parametrize("case", sorted(PATHS))
def test_execute_chooses_the_path_jax_chooses(case, monkeypatch,
                                              one_torch_thread):
    """Each package's ``execute`` stopped where it picks its loop: the
    JAX driver at ``_build_batch_cycle`` or at its first per-cycle call,
    the port at ``_run_window`` or ``_cycle_loop``."""
    path, extra, outputs, verbose = PATHS[case]
    text = deck_text(path)
    monkeypatch.setattr(jax_driver.Driver, "_build_cycle",
                        lambda self, state=None: _raise(_Loop()))
    monkeypatch.setattr(jax_driver.Driver, "_build_batch_cycle",
                        _raise(_Window()))
    monkeypatch.setattr(torch_driver.Driver, "_run_window",
                        _raise(_Window()))
    monkeypatch.setattr(torch_driver.Driver, "_cycle_loop",
                        _raise(_Loop()))
    outs = [_Output()] if outputs else None
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + list(extra))
    _, _, _, jd, js = jax_main.build(pj)
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(list(extra))
    _, _, _, td, ts = torch_main.build(pt, device="cpu")
    got = []
    for driver, st in ((jd, js), (td, ts)):
        with contextlib.redirect_stdout(io.StringIO()):
            with pytest.raises((_Window, _Loop)) as exc:
                driver.execute(st, outputs=outs, verbose=verbose)
        got.append(exc.type)
    assert got[0] is got[1]
    assert (got[1] is _Window) == (case == "plain")
    assert td.use_window(outs, verbose) == (case == "plain")


class _OnCard:
    """A stand-in for a state on the card (``graph_window`` reads only
    ``state["u"].is_cuda`` before the configuration)."""
    is_cuda = True


CLOSED = {
    "inputs/mhd/blast.athinput": None,
    "inputs/z4c/one_puncture.athinput": None,
    "inputs/mhd/blast_smr.athinput": None,
    "inputs/srmhd/blast_srmhd.athinput": "Illinois",
    "inputs/grhydro/bondi.athinput": "Illinois",
    "inputs/tests/selfgravity.athinput": "multigrid",
    "inputs/tests/jeans_wave.athinput": None,
    "inputs/shearing_box/mri2d.athinput": None,
    "inputs/shearing_box/mri3d.athinput": "check_shift",
    "inputs/hydro/rt2d.athinput": None,
    "inputs/hydro/viscosity.athinput": None,
    "inputs/radiation/hohlraum_1d.athinput": None,
    "inputs/dyn_grmhd/sod.athinput": "nest",
}


@pytest.mark.parametrize("path", sorted(CLOSED))
def test_graph_window_names_the_host_read(path, one_torch_thread):
    """The predicate of the window's CUDA graph: the decks that carry the
    kernels capture, each closed configuration names its host read."""
    pt = ParameterInput.from_string(deck_text(path))
    pt.modify_from_cmdline(["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
                           if "blast" in path or "puncture" in path else [])
    _, _, _, driver, _ = torch_main.build(pt, device="cpu")
    why = driver.graph_window({"u": _OnCard()})
    if CLOSED[path] is None:
        assert why is None
    else:
        assert CLOSED[path] in why
    driver.ranks = object()
    assert "ranks" in driver.graph_window({"u": _OnCard()})
    assert "CPU" in driver.graph_window({"u": torch.zeros(1)})


def _state(text, extra):
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(list(extra))
    mesh, phys, _, driver, st = torch_main.build(pt, device="cpu")
    return mesh, phys, driver.initialize(st)


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert torch.equal(a, b)


@pytest.mark.parametrize("prec", ["single", "double"])
def test_plain_versions_take_the_step_as_a_tensor(prec, one_torch_thread):
    """Kernels A, C, D, E and H's plain versions on a deck's state: the
    step as a 0-d tensor of the state's dtype gives the bits the same
    step as a Python float gives."""
    from athenak_tpu_torch.ops import stage, stage_split, stage_v1
    from athenak_tpu_torch.ops import z4c_stage as zs
    dtype = torch.float32 if prec == "single" else torch.float64
    extra = [f"job/precision={prec}"] + CUT3

    def steps(x):
        t = torch.tensor(x, dtype=dtype)
        return float(t), t

    mesh, phys, st = _state(deck_text(BLAST), extra + SHIFT)
    f, t = steps(0.5 * mesh.dt)
    a = [stage.mega_stage_v2_plain(st["u"], st["bfc"], st["u"], st["bfc"],
                                   phys.eos, 0.5, 0.5, s, phys.dxs)
         for s in (f, t)]
    _same(*a)
    e = [stage_v1.fused_mega_stage3d_plain(
        st["w"], st["bcc"], st["bfc"], st["u"], st["u"], st["bfc"],
        phys.eos, 0.5, 0.5, s, phys.dxs) for s in (f, t)]
    _same(*e)

    mesh, phys, st = _state(chip_smoke.SR_DECK, extra)
    f, t = steps(0.5 * mesh.dt)
    solver = stage_split.solver_for(phys)
    c = [stage_split.fused_stage3d_plain(
        st["w"], st["bcc"], st["bfc"], st["u"], st["u"], phys.eos, 0.5,
        0.5, s, phys.dxs, solver) for s in (f, t)]
    _same(*c)
    _, fden, emf = c[0]
    d = [stage_split.fused_ct3d_plain(st["w"], st["bcc"], fden, emf,
                                      st["bfc"], st["bfc"], 0.5, 0.5, s,
                                      phys.dxs, is_sr=True) for s in (f, t)]
    _same(*d)

    mesh, phys, st = _state(deck_text(PUNCTURE), extra)
    f, t = steps(0.25 * mesh.dt)
    u1 = st["u"] * 1.001
    h = [zs.fused_z4c_stage_plain(st["u"], u1, phys, 0.5, 0.5, s)
         for s in (f, t)]
    _same(*h)
