"""The Z4c slice as a whole: the single puncture through both packages.

Two decks at 16^3 in float64 (JAX runs in float64 in this suite,
tests/conftest.py): ``bench.py``'s ``Z4C_DECK`` (nghost 2, RK4, outflow
faces with Sommerfeld rows, KO dissipation), as ``chip_smoke.py`` copies
it, and ``inputs/z4c/one_puncture.athinput`` (nghost 3, RK3, its own
gauge).  Three cycles of each through the port's ``main.run`` or
``main.cli`` agree with the JAX package's ``build`` + driver to 1e-10 of
max(|value|, 1), with the same time and cycle count.  A JAX state moved
into the port through ``state.py`` runs on there the stage kernel's way
(the kernel gate opened for CPU tensors, so each wrapper runs its plain
version).  The JAX cycles run outside ``jax.jit`` (see
``tests/test_torch_z4c_ops.py``), one reference run per deck.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.ops import z4c_stage  # noqa: E402
from athenak_tpu_torch.state import state_from_numpy  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from athenak_tpu_torch.z4c.z4c import Z4c  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUNCTURE = os.path.join(ROOT, "inputs", "z4c", "one_puncture.athinput")
SMALL = ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16",
         "mesh/nx3=16", "time/nlim=3"]
DECKS = {"z4c": chip_smoke.Z4C_DECK,
         "puncture": open(PUNCTURE).read()}
NCYC = 3


def _pin(name, cls=ParameterInput, extra=()):
    pin = cls.from_string(DECKS[name])
    pin.modify_from_cmdline(SMALL + list(extra))
    return pin


def scaled_err(got, want):
    want = np.asarray(want)
    return float((np.abs(np.asarray(got) - want)
                  / np.maximum(np.abs(want), 1.0)).max())


_JAX_RUNS = {}


def jax_run(name):
    """The JAX package's build, initialize and three cycles of the deck
    with the host dt chain; the state after each cycle (numpy),
    the time and dt before each cycle."""
    if name not in _JAX_RUNS:
        mesh, _, _, driver, state = jax_main.build(_pin(name, JaxInput))
        state = driver.initialize(state)
        cycle = driver.make_cycle_fn()
        states, times, dts = [], [], []
        dt = mesh.dt
        for _ in range(NCYC):
            times.append(mesh.time)
            dts.append(dt)
            state, dtnew, _ = cycle(state, jnp.asarray(dt))
            mesh.time += dt
            states.append(np.asarray(state["u"]))
            dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
        _JAX_RUNS[name] = {"states": states, "times": times, "dts": dts,
                           "time": mesh.time}
    return _JAX_RUNS[name]


def test_deck_is_bench_deck():
    """chip_smoke.py's copy of the bench deck is the bench deck."""
    assert chip_smoke.Z4C_DECK == bench.Z4C_DECK


def test_z4c_deck_run_parity(monkeypatch, tmp_path):
    ref = jax_run("z4c")
    monkeypatch.chdir(tmp_path)
    mesh, phys, driver, st = torch_main.run(_pin("z4c"), device="cpu")
    assert isinstance(phys, Z4c) and driver.integrator.name == "rk4"
    assert mesh.ncycle == NCYC and mesh.time == ref["time"]
    assert st["u"].dtype == torch.float64
    assert scaled_err(st["u"].numpy(), ref["states"][-1]) <= 1e-10
    assert driver.zone_cycles == NCYC * 16 ** 3
    # on the CPU nothing launches a CUDA kernel
    assert all(k.launches == 0 for k in kernels.ALL)


def test_puncture_deck_cli_parity(monkeypatch, tmp_path):
    """inputs/z4c/one_puncture.athinput (RK3, nghost 3) through
    ``main.cli -i`` with ATHENAK_DEVICE=cpu."""
    ref = jax_run("puncture")
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    mesh, phys, driver, st = torch_main.cli(
        ["-i", PUNCTURE, "-d", str(tmp_path / "run")] + SMALL)
    assert phys.ng == 3 and driver.integrator.name == "rk3"
    assert phys.opt.shift_ggamma == 0.75 and phys.opt.damp_kappa1 == 0.02
    assert mesh.ncycle == NCYC and mesh.time == ref["time"]
    assert scaled_err(st["u"].numpy(), ref["states"][-1]) <= 1e-10


def test_state_carried_across_kernel_path(monkeypatch):
    """The JAX state after one cycle, moved into the port through
    state.py, runs two more cycles there through the kernel path's
    calls (fused stage, then the outflow fill kernel's plain version):
    the result agrees with the JAX package's third cycle."""
    ref = jax_run("z4c")
    monkeypatch.setattr(Z4c, "kernel_path",
                        lambda self, u: self.use_stage_kernel)
    mesh, phys, _, driver, _ = torch_main.build(_pin("z4c"), device="cpu")
    assert phys.fold_bc
    moved = state_from_numpy({"u": ref["states"][0], "w": ref["states"][0]},
                             "cpu", torch.float64)
    assert set(moved) == {"u", "w"}
    back = state_to_numpy(moved)
    assert set(back) == {"u", "w"}
    np.testing.assert_array_equal(back["u"], ref["states"][0])
    calls = []
    real_fill = z4c_stage.outflow_fill
    monkeypatch.setattr(z4c_stage, "outflow_fill",
                        lambda u, bv: calls.append(bv.ng) or real_fill(u, bv))
    cycle = driver.make_cycle_fn()
    st = moved
    for n in (1, 2):
        st, dtnew, counters = cycle(st, ref["dts"][n])
        assert counters == {} and dtnew == mesh.mesh_size.dx1
    assert calls == [2] * 8          # one fill after each of 8 stages
    assert scaled_err(st["u"].numpy(), ref["states"][2]) <= 1e-10


def test_dynamical_grmhd_still_raises():
    """<mhd> together with <z4c> selects dynamical GRMHD in both
    packages (the port no longer raises on it); the vacuum puncture
    generator cannot make its state and raises the same error in both."""
    from athenak_tpu.bvals import BoundaryValues as JaxBV
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    extra = ["mhd/gamma=1.6666666666666667", "mhd/eos=ideal"]
    pin = _pin("z4c", extra=extra)
    mesh = Mesh(pin)
    phys = torch_main.make_physics(pin, mesh, BoundaryValues(mesh), "cpu",
                                   torch.float64)
    pj = _pin("z4c", cls=JaxInput, extra=extra)
    jm = JaxMesh(pj)
    jphys = jax_main.make_physics(pj, jm, JaxBV(jm))
    assert type(phys).__name__ == type(jphys).__name__ == "DynGRMHD"
    assert phys.z4c is not None and jphys.z4c is not None
    for build, cls in ((lambda p: torch_main.build(p, device="cpu"),
                        ParameterInput), (jax_main.build, JaxInput)):
        with pytest.raises(AttributeError, match="opt"):
            build(_pin("z4c", cls=cls, extra=extra))
