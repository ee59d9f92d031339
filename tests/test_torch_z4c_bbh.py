"""Binary black holes in Z4c: the port against the JAX package in
float64 on the CPU.

  * the two-puncture correction u: the port's red-black SOR (torch
    float64) against the JAX package's numpy sweeps, with momenta, at
    ``tp_npoints`` 24 and ``tp_iterations`` 200, to 1e-12 of max|u|;
  * ``inputs/z4c/two_puncture_trackers.athinput`` cut to one 32^3 block
    on [-8, 8]^3 (the binary under the keys the generator reads, ROADMAP
    F10), three RK4 cycles with the two trackers and the ``wave`` output:
    the state, the tracker positions and both ``co_N`` files and the
    ``waveform.txt`` mode table to 1e-10;
  * psi4 (``weyl_scalars``), the ``WaveExtractor`` modes and the
    constraint monitors (``adm_constraints``: H, M^2, and with ``full``
    M_d, Z and C) on the JAX package's evolved binary, to 1e-10 of their
    largest value;
  * the same deck with tracker refinement on a 16^3 root of 8^3 blocks,
    three levels, three RK2 cycles (8, 22, then 36 blocks): the leaves
    at every tree update exactly, the state and the trackers to 1e-10;
  * a ``-r`` restart of the flat binary at 12^3: 4 cycles straight
    against 2 + 2, bitwise in u and the trackers.

The JAX runs go outside ``jax.jit`` (``torch_deck_parity.EagerRun``),
one a deck, shared by the module's tests; torch runs on one thread.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from athenak_tpu.pgen import z4c_two_punctures as jax_tp  # noqa: E402
from athenak_tpu.z4c import weyl as jax_weyl  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.pgen import z4c_two_punctures  # noqa: E402
from athenak_tpu_torch.z4c import weyl  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (EagerRun, deck_text, interior,  # noqa: E402
                               port_run, scaled_err)

DECK = deck_text("inputs/z4c/two_puncture_trackers.athinput")
BINARY = ["job/precision=double", "problem/punc1_x1=3",
          "problem/punc2_x1=-3", "problem/punc1_P_x2=-0.1",
          "problem/punc2_P_x2=0.1", "problem/tp_npoints=24",
          "problem/tp_iterations=200"]
FLAT = BINARY + ["mesh_refinement/refinement=none"] + [
    f"{b}/nx{d}=32" for b in ("mesh", "meshblock") for d in (1, 2, 3)] + [
    f"mesh/x{d}{e}={v}" for d in (1, 2, 3)
    for e, v in (("min", -8.0), ("max", 8.0))] + [
    "z4c/extraction_radius_1=6", "output1/dt=0.3"]
# tracker refinement on 8 root blocks: each tracker deep in one root
# block's outer child, so every update refines one block a tracker and
# no 2:1 cascade reaches level 0; RK2 and no extraction sphere to keep
# the JAX package's three trees cheap
AMR = BINARY + ["time/integrator=rk2", "z4c/nrad_wave_extraction=0"] + [
    f"mesh/nx{d}=16" for d in (1, 2, 3)] + [
    f"meshblock/nx{d}=8" for d in (1, 2, 3)] + [
    f"mesh/x{d}{e}={v}" for d in (1, 2, 3)
    for e, v in (("min", -8.0), ("max", 8.0))] + [
    "mesh_refinement/num_levels=3", "z4c/co_0_x=6.5", "z4c/co_0_y=6.5",
    "z4c/co_0_z=6.5", "z4c/co_1_x=-6.5", "z4c/co_1_y=6.5",
    "z4c/co_1_z=6.5", "z4c/co_0_radius=0.5", "z4c/co_1_radius=0.5",
    "problem/punc1_x1=6.5", "problem/punc1_x2=6.5", "problem/punc1_x3=6.5",
    "problem/punc2_x1=-6.5", "problem/punc2_x2=6.5",
    "problem/punc2_x3=6.5", "z4c/extraction_radius_1=4"]
NCYC = 3


@pytest.fixture(scope="module")
def flat(tmp_path_factory):
    """The flat binary through both packages, each in its own
    directory, with the wave output."""
    root = tmp_path_factory.mktemp("bbh_flat")
    ref = EagerRun(DECK, FLAT, NCYC, outputs=True, rundir=root / "jax")
    port = port_run(DECK, FLAT, NCYC, rundir=root / "port")
    return ref, port, root


def test_sor_matches_numpy():
    """Bowen-York data with momenta and spins: the torch sweeps give the
    numpy sweeps' u to 1e-12 of max|u|."""
    args = ((-8.0, 8.0, -8.0, 8.0, -8.0, 8.0),
            [[3.0, 0.1, 0.0], [-3.0, -0.2, 0.3]], [0.5, 0.4],
            [[0.0, -0.1, 0.02], [0.01, 0.1, 0.0]],
            [[0.0, 0.0, 0.05], [0.02, 0.0, 0.0]])
    ref = jax_tp._solve_u(*args, N=24, iters=200)
    got = z4c_two_punctures._solve_u(*args, N=24, iters=200, device="cpu")
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    scale = float(np.abs(ref[3]).max())
    assert scale > 1e-4
    assert float(np.abs(got[3] - ref[3]).max()) <= 1e-12 * scale
    # Brill-Lindquist (no momenta, no spins): no solve in either
    bl = (args[0], args[1], args[2], [[0.0] * 3] * 2, [[0.0] * 3] * 2)
    assert z4c_two_punctures._solve_u(*bl, N=8, iters=2) is None
    assert jax_tp._solve_u(*bl, N=8, iters=2) is None


def test_flat_binary_matches_jax(flat):
    ref, (mesh, phys, driver, st), _ = flat
    assert phys.nco == 2 and mesh.ncycle == NCYC
    assert mesh.time == pytest.approx(ref.time, rel=1e-14)
    np.testing.assert_array_equal(ref.ready["u"].shape, st["u"].shape)
    assert scaled_err(interior(st["u"], 4), interior(ref.state["u"], 4)) \
        <= 1e-10
    assert st["co_pos"].dtype == np.float64
    np.testing.assert_allclose(st["co_pos"], ref.state["co_pos"],
                               rtol=0, atol=1e-10)
    # the trackers moved (the shift grows from zero), along y
    moved = st["co_pos"] - phys.tracker_pos0
    assert np.abs(moved).max() > 1e-5
    assert np.isfinite(st["u"]).all() and st["u"][:, 0].min() > 0.0


def test_wave_files_match_jax(flat):
    """``co_0.txt``, ``co_1.txt`` and ``waveform.txt``: the same rows;
    times and positions to 1e-10 of max(|value|, 1), the modes to 1e-10
    of the largest mode."""
    _, _, root = flat
    names = ["two_puncture_trackers.co_0.txt",
             "two_puncture_trackers.co_1.txt",
             "two_puncture_trackers.waveform.txt"]
    for name in names[:2]:
        a = np.loadtxt(root / "port" / name)
        b = np.loadtxt(root / "jax" / name)
        assert a.shape == b.shape and a.shape[0] >= 3, name
        assert scaled_err(a, b) <= 1e-10, name
    a = np.loadtxt(root / "port" / names[2])
    b = np.loadtxt(root / "jax" / names[2])
    assert a.shape == b.shape and a.shape[0] >= 3
    assert scaled_err(a[:, :2], b[:, :2]) <= 1e-12   # time, radius
    big = float(np.abs(b[:, 2:]).max())
    assert big > 0.0 and np.abs(a[:, 2:] - b[:, 2:]).max() <= 1e-10 * big
    with open(root / "port" / names[2]) as f, \
            open(root / "jax" / names[2]) as g:
        assert f.readline() == g.readline()   # the column header


def test_weyl_modes_and_constraints_match_jax(flat):
    """On the JAX package's evolved binary: psi4 * r on the interior, the
    (l, m) modes on the extraction sphere, and every constraint monitor
    to 1e-10 of their largest value."""
    ref, (mesh, phys, _, _), _ = flat
    u = ref.state["u"]
    ut = torch.tensor(u)
    got = [t.numpy() for t in weyl.weyl_scalars(phys, ut)]
    want = [np.asarray(a)
            for a in jax_weyl.weyl_scalars(ref.phys, jnp.asarray(u))]
    for g, w in zip(got, want):
        gi, wi = interior(g[:, None], 4), interior(w[:, None], 4)
        assert float(np.abs(wi).max()) > 0.0
        assert np.abs(gi - wi).max() <= 1e-10 * np.abs(wi).max()
    ext = weyl.WaveExtractor([6.0], lmax=4, nlevel=16)
    jext = jax_weyl.WaveExtractor([6.0], lmax=4, nlevel=16)
    (_, mg), = ext.modes(mesh, *got)
    (_, mw), = jext.modes(ref.mesh, *want)
    assert sorted(mg) == sorted(mw)
    big = max(abs(v) for pair in mw.values() for v in pair)
    assert big > 0.0
    for k in mw:
        assert np.abs(np.subtract(mg[k], mw[k])).max() <= 1e-10 * big, k

    full = phys.adm_constraints(ut, full=True)
    jfull = ref.phys.adm_constraints(jnp.asarray(u), full=True)
    H, M2 = phys.adm_constraints(ut)
    pairs = [("H", H, jfull["H"]), ("M2", M2, jfull["M2"])] + [
        (k, full[k], jfull[k]) for k in ("H", "M2", "Z", "C")] + [
        (f"M_{a}", full["M_d"][a], jfull["M_d"][a]) for a in range(3)]
    for label, g, w in pairs:
        gi = interior(g.numpy()[:, None], 4)
        wi = interior(np.asarray(w)[:, None], 4)
        scale = float(np.abs(wi).max())
        assert scale > 0.0, label
        assert np.abs(gi - wi).max() <= 1e-10 * scale, label


def test_tracker_amr_matches_jax(tmp_path):
    """Three levels of tracker refinement: the same leaves at every tree
    update, the state, time and trackers to 1e-10; the trackers carried
    through every rebuild."""
    ref = EagerRun(DECK, AMR, NCYC, rundir=tmp_path / "jax")
    mesh, phys, driver, st = port_run(DECK, AMR, NCYC,
                                      rundir=tmp_path / "port")
    trees = [(r["ncycle"], r["leaves"]) for r in driver.pamr.updates]
    assert trees == ref.trees and len(trees) == 2
    assert driver.pamr.z4c_amr.method == "tracker"
    assert [r["nmb"] for r in driver.pamr.updates] == [22, 36]
    assert sorted(set(mesh.mb_lev.tolist())) == [0, 1, 2]
    assert mesh.time == pytest.approx(ref.time, rel=1e-14)
    assert scaled_err(interior(st["u"], 4), interior(ref.state["u"], 4)) \
        <= 1e-10
    np.testing.assert_allclose(st["co_pos"], ref.state["co_pos"],
                               rtol=0, atol=1e-10)
    assert np.abs(st["co_pos"] - phys.tracker_pos0).max() > 0.0


def test_restart_keeps_trackers_bitwise(tmp_path, monkeypatch):
    """A 12^3 flat binary: 4 cycles straight against 2 + ``-r`` 2,
    bitwise in u and co_pos (the restart file holds co_pos at the
    state's dtype)."""
    cut = [o for o in FLAT if "nx" not in o and "output1" not in o] + [
        f"{b}/nx{d}=12" for b in ("mesh", "meshblock") for d in (1, 2, 3)]
    text = DECK + "\n<output2>\nfile_type = rst\ndcycle = 2\n"
    monkeypatch.chdir(tmp_path)
    *_, straight = port_run(text, cut, 4, rundir=tmp_path / "a")
    os.chdir(tmp_path / "a")
    _, _, _, st = torch_main.run_restart(
        "two_puncture_trackers.00001.rst", ["time/nlim=4"], device="cpu")
    np.testing.assert_array_equal(st["u"].numpy(), straight["u"])
    np.testing.assert_array_equal(st["co_pos"].numpy(),
                                  straight["co_pos"])
    assert st["co_pos"].dtype == torch.float64
