"""The Z4c problem generators of the port against the JAX package, and
the Z4c decks of ``inputs/z4c/`` through the port's CLI, on the CPU in
float64.

  * every generator this slice ports (Kerr-Schild, the boosted and the
    two punctures, the linear wave, the AwA gauge wave and robust
    stability, each from its deck or ``tests/test_z4c*.py``'s, cut to a
    few thousand cells): the initial state and the tracker positions
    against the JAX package's to 1e-12, and every registry name;
  * ``z4c_linear_wave`` for three RK3 cycles: the state and its ``final``
    error file against the JAX package's to 1e-10;
  * ``inputs/z4c/awa/gauge_wave.athinput`` as shipped (64 x 4 x 4 with
    nghost 4, harmonic lapse, periodic) for two cycles against JAX;
  * ``kerr_schild``, ``one_puncture_ahf``, ``awa/robust_stability`` and
    ``two_puncture_trackers`` through ``main.cli -i`` with
    ``ATHENAK_DEVICE=cpu`` at a cut size: they run, the state stays
    finite, robust stability stays at its noise.

The JAX evolutions run outside ``jax.jit`` (``torch_deck_parity``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.pgen import _REGISTRY as JAX_REGISTRY  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.pgen import _REGISTRY  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (JAX_EXTRA, ROOT, EagerRun,  # noqa: E402
                               deck_text, interior, port_run, scaled_err)

CUBE = [f"{b}/nx{d}=12" for b in ("mesh", "meshblock") for d in (1, 2, 3)]
LW_DECK = """
<job>
basename = z4clw
<mesh>
nghost = 2
nx1 = 16
x1min = 0.0
x1max = 1.0
nx2 = 4
x2min = 0.0
x2max = 1.0
nx3 = 4
x3min = 0.0
x3max = 1.0
<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
tlim = 1.0
<z4c>
diss = 0.5
damp_kappa1 = 0.02
lapse_oplog = 2.0
lapse_advect = 1.0
shift_eta = 2.0
<problem>
pgen_name = z4c_linear_wave
amp = 1.0e-6
kx1 = 1.0
kx2 = 0.3
kx3 = 0.2
"""
BOOSTED = deck_text("inputs/z4c/one_puncture.athinput").replace(
    "z4c_one_puncture", "z4c_boosted_puncture")
GENERATORS = {
    "kerr_schild": (deck_text("inputs/z4c/kerr_schild.athinput"), CUBE),
    "gauge_wave": (deck_text("inputs/z4c/awa/gauge_wave.athinput"), []),
    "robust_stability": (
        deck_text("inputs/z4c/awa/robust_stability.athinput"),
        CUBE + ["problem/seed=5"]),
    "boosted": (BOOSTED, CUBE + ["problem/punc_velocity_x1=0.5",
                                 "problem/punc_center_x2=0.3"]),
    "linear_wave": (LW_DECK, []),
    "two_punctures": (
        deck_text("inputs/z4c/two_puncture_trackers.athinput"),
        CUBE + ["mesh_refinement/refinement=none", "problem/punc1_x1=3",
                "problem/punc2_x1=-3", "problem/punc1_P_x2=-0.1",
                "problem/punc2_P_x2=0.1", "problem/punc1_S_x3=0.05",
                "problem/tp_npoints=16", "problem/tp_iterations=100"]),
}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_initial_state_matches_jax(name):
    text, cut = GENERATORS[name]
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + ["job/precision=double"] + cut)
    *_, jst = jax_main.build(pj)
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(["job/precision=double"] + cut)
    *_, st = torch_main.build(pt, device="cpu")
    st = state_to_numpy(st)
    assert sorted(st) == sorted(jst)
    ref = np.asarray(jst["u"])
    assert st["u"].shape == ref.shape and st["u"].dtype == np.float64
    assert np.abs(st["u"] - ref).max() <= 1e-12 * np.abs(ref).max()
    if "co_pos" in jst:
        np.testing.assert_array_equal(st["co_pos"], np.asarray(
            jst["co_pos"]))


def test_registry_has_the_z4c_generators():
    names = [k for k, v in JAX_REGISTRY.items()
             if ".z4c_" in v and "import" not in v]
    assert len(names) == 11
    for k in names:
        assert _REGISTRY[k].split(".")[-1] == JAX_REGISTRY[k].split(".")[-1]


def test_linear_wave_error_file_matches_jax(tmp_path, monkeypatch):
    """Three cycles and the ``final`` hook: the state to 1e-10 and the
    ``z4clw-errs.dat`` row to 1e-10 of its largest entry."""
    import jax.numpy as jnp
    from athenak_tpu.pgen import z4c_linear_wave as jax_lw
    ncyc = 3
    ref = EagerRun(LW_DECK, ["job/precision=double"], ncyc)
    _, _, _, st = port_run(LW_DECK, ["job/precision=double"], ncyc,
                           rundir=tmp_path / "port")
    assert scaled_err(interior(st["u"]), interior(ref.state["u"])) <= 1e-10
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    ref.mesh.ncycle = ncyc
    jax_lw.final(ref.pin, ref.mesh, ref.phys,
                 {"u": jnp.asarray(ref.state["u"])})
    want = np.loadtxt("z4clw-errs.dat")
    got = np.loadtxt(tmp_path / "port" / "z4clw-errs.dat")
    assert got.shape == want.shape and want[4] > 0.0
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert tuple(got[:4].astype(int)) == (16, 4, 4, ncyc)


def test_gauge_wave_matches_jax(tmp_path):
    """The AwA gauge wave as shipped: nghost 4 on a 4-cell x2/x3
    interior, the harmonic lapse; two cycles against JAX."""
    text = deck_text("inputs/z4c/awa/gauge_wave.athinput")
    ref = EagerRun(text, ["job/precision=double"], 2)
    mesh, phys, driver, st = port_run(text, ["job/precision=double"], 2,
                                      rundir=tmp_path)
    assert phys.ng == 4 and phys.opt.lapse_harmonic == 1.0
    assert scaled_err(interior(st["u"], 4), interior(ref.state["u"], 4)) \
        <= 1e-10
    assert mesh.time == pytest.approx(ref.time, rel=1e-14)


@pytest.mark.parametrize("deck,cut,ncyc", [
    ("kerr_schild", CUBE, 2),
    ("one_puncture_ahf", CUBE, 2),
    ("awa/robust_stability", CUBE, 2),
    # one cycle, then the tracker refinement of all 8 root blocks
    ("two_puncture_trackers", [
        f"mesh/nx{d}=16" for d in (1, 2, 3)] + [
        f"meshblock/nx{d}=8" for d in (1, 2, 3)] + [
        "mesh_refinement/num_levels=2", "problem/tp_npoints=16",
        "problem/tp_iterations=20"], 1)])
def test_deck_runs_through_cli(deck, cut, ncyc, tmp_path, monkeypatch):
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    path = f"{ROOT}/inputs/z4c/{deck}.athinput"
    mesh, phys, driver, st = torch_main.cli(
        ["-i", path, "-d", str(tmp_path / "run"), f"time/nlim={ncyc}",
         "job/precision=double"] + cut)
    u = st["u"].numpy()
    assert mesh.ncycle == ncyc and np.isfinite(u).all()
    assert interior(u, phys.ng)[:, 0].min() > 0.0
    if deck == "awa/robust_stability":
        # Minkowski plus noise of 1e-10: the state stays at the noise
        flat = np.zeros(22)
        flat[[0, 1, 4, 6, 18]] = 1.0
        dev = interior(u, 2) - flat[None, :, None, None, None]
        assert np.abs(dev).max() < 1e-8
    if deck == "two_puncture_trackers":
        assert driver.pamr.updates and phys.nco == 2
        assert (tmp_path / "run" / "two_puncture_trackers.co_0.txt"
                ).exists()
