"""The rank-split cycle of the port on every physics the JAX package's
shard cycle covers, and the particle exchange (gloo on the CPU, each
rank a child process; ``athenak_tpu_torch/parallel``).

One spawn of four ranks runs, in float64: the decks of
tests/test_turb_shard.py, test_z4c_shard.py, test_rad_shard.py (the Kerr
beam, the coupled linear wave), test_dyngr_shard.py,
test_ion_neutral_shard.py and test_part_comm.py's particle blast, the
four decks of ``__graft_entry__.py::dryrun_multichip`` at four devices
(a blast of 6 blocks, which the JAX package pads to 8, the 2-D SMR MHD
blast, the Z4c two punctures with trackers, rad_relax), and
test_part_comm.py's three exchange cases.  Each deck runs its cycle function at the first dt, as
the JAX tests' ``_run`` does; the ranks then make the one-rank runs of
the same decks, dealt out among them, while four fresh interpreters
run the named ones through the JAX package on one device.  Held:

  * the split run, gathered, against the one-rank run: bitwise where
    the JAX test asserts a bit match (the particle blast), at the JAX
    test's tolerance elsewhere (turbulence: its volume integrals are
    all-reduced in another order);
  * against the JAX package's single-device run to 1e-10 of each
    field's scale (the blasts moved by 0.3 of a root cell, ROADMAP F4);
  * the exchange: every particle on its destination rank with nothing
    lost, overflow reported and the particles kept under a tiny cap,
    dead slots respected.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.main import build as jax_build  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (assert_close, assert_states_close,  # noqa: E402
                               jit_o0)
import torch_shard_decks as D  # noqa: E402

L = D.deck_literal
TURB = L("test_turb_shard.py", "DECK")
Z4C = L("test_z4c_shard.py", "DECK")
BEAM = L("test_rad_gr.py", "BEAM_DECK")
# test_rad_shard.py's coupled linear wave: 8 blocks along x1
LWAVE = L("test_rad_gr.py", "RAD_LWAVE_DECK").replace(
    "nx1 = 32\nx1min", "nx1 = 64\nx1min")
DYNGR = L("test_dyngr_shard.py", "DECK")
ION = L("test_ion_neutral_shard.py", "DECK")
PART = D.DECK + "\n<particles>\nppc = 0.5\n"
F64 = ["job/precision=double"]
with open(f"{D.ROOT}/inputs/particles/random_drift.athinput") as _f:
    DRIFT = _f.read()
# random_drift at 16^3 in 8 blocks of 8^3, a trk row every cycle: 409
# particles (3 does not divide them) and 8 (as many as the blocks)
DRIFT_CUT = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16", "meshblock/nx1=8",
             "meshblock/nx2=8", "meshblock/nx3=8", "output1/dt=0.01"]
# the puncture with its CCE worldtube and horizon dump (tests/test_cce.py)
# in 2 blocks, with a restart file every cycle
CCE = L("test_cce.py", "DECK") + "\n<output1>\nfile_type = rst\ndcycle = 1\n"
CCE_CUT = ["meshblock/nx1=16", "meshblock/nx2=16", "meshblock/nx3=8"]


def _deck(text, ncyc=2, overrides=()):
    return dict(text=text, world=4, ncyc=ncyc, fixed_dt=True,
                overrides=list(overrides))


JOBS = {
    "turb": _deck(TURB, 3),
    "z4c": _deck(Z4C),
    "beam": _deck(BEAM),
    "lwave": _deck(LWAVE),
    "dyngr": _deck(DYNGR),
    "ion": _deck(ION),
    "part": _deck(PART, 3),
    "part_s": _deck(PART, 3, D.shift(PART)),
    "g_blast": _deck(D.GRAFT_BLAST, 2, F64 + D.shift(D.GRAFT_BLAST)),
    "g_smr": _deck(D.GRAFT_SMR, 2, F64 + D.shift(D.GRAFT_SMR)),
    "g_z4c": _deck(D.GRAFT_Z4C, 2, F64),
    "g_rad": _deck(D.GRAFT_RAD, 2, F64),
    # drift particles on 3 ranks whose count 3 does not divide, and a
    # count equal to the block count; the CCE and horizon dumps on 2
    # ranks, resumed with -r from the cycle-1 restart file
    "part3": dict(text=DRIFT, world=3, ncyc=3, outputs=True,
                  overrides=DRIFT_CUT),
    "partn": dict(text=DRIFT, world=3, ncyc=3, outputs=True,
                  overrides=DRIFT_CUT + ["particles/ppc=0.001953125"]),
    "cce": dict(text=CCE, world=2, ncyc=2, outputs=True,
                overrides=CCE_CUT,
                restart=("punc.00001.rst", ["time/nlim=2"])),
    # test_part_comm.py's exchange cases, on 4 ranks
    "x_route": dict(kind="part", world=4, seed=0, nlive=64,
                    balanced=True, passes=6),
    "x_overflow": dict(kind="part", world=4, seed=0, nlive=64, cap=1),
    "x_dead": dict(kind="part", world=4, seed=0, nlive=64, dead_frac=0.3,
                   balanced=True, passes=6),
}
# held against the JAX package's one-device run, the longest first
JAX_JOBS = ("dyngr", "g_smr", "z4c", "g_z4c", "ion", "part_s", "g_rad",
            "lwave", "g_blast", "turb", "beam")
#: the configurations the port refused under ranks until the gather
#: path's were written out: their JAX runs (the particle decks on its
#: gather path on 2 virtual devices, the CCE deck on one device)
LIFTED = ("part3", "partn", "cce")


#: run outside ``jax.jit``, op by op (a Z4c right-hand side is thousands
#: of small operations: compiling each once is quicker than compiling
#: the cycle, as tests/torch_deck_parity.py's ``EagerRun`` does)
EAGER = ("z4c", "g_z4c")


def _jax_run(job):
    spec = JOBS[job]
    pin = JaxInput.from_string(spec["text"])
    pin.modify_from_cmdline(spec["overrides"])
    pin.set_value("mesh", "coalesce", "false")
    pin.set_value("mesh", "pencil_pack", "false")
    with pytest.MonkeyPatch.context() as mp:
        if job in EAGER:
            mp.setattr(jax, "jit", lambda f=None, **kw: f)
        mesh, phys, pgen, driver, state = jax_build(pin)
        state = driver.initialize(state)
        fn = driver.make_cycle_fn()
        fn = fn if job in EAGER else jit_o0(fn)
        dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
        for _ in range(spec["ncyc"]):
            state, dtnew, _ = fn(state, dt)
    return jax.tree_util.tree_map(np.asarray, state), float(dtnew)


def _jax_drive(job, ndev=2):
    """A particle job through the JAX package's driver and outputs
    (``execute`` with its ``trk``), on its NamedSharding gather path over
    ``ndev`` virtual devices: the final state and the trk file's text."""
    import os
    import tempfile

    from athenak_tpu.outputs import make_outputs
    from athenak_tpu.parallel import make_device_mesh
    from torch_deck_parity import _jit_o0

    spec = JOBS[job]
    pin = JaxInput.from_string(spec["text"])
    pin.modify_from_cmdline(spec["overrides"]
                            + [f"time/nlim={spec['ncyc']}"])
    pin.set_value("mesh", "coalesce", "false")
    pin.set_value("mesh", "pencil_pack", "false")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _jit_o0(jax.jit))
        os.chdir(tmp)
        try:
            mesh, phys, pgen, driver, state = jax_build(pin)
            driver.dmesh = make_device_mesh(ndev)
            state = driver.initialize(state)
            outs = make_outputs(pin, mesh, phys)
            state = driver.execute(state, outs)
            trk = open(f"{pin.get_string('job', 'basename')}.trk").read()
        finally:
            os.chdir(cwd)
    return {"state": jax.tree_util.tree_map(np.asarray, state),
            "time": mesh.time, "trk": trk}


def _jax_cce(job):
    """The CCE job through the JAX package on one device, outside
    ``jax.jit``: its cycles at the first dt (the Z4c bound is the cell
    size, so the driver's dt chain is that dt), then its own CCE and
    horizon dumps of the final state (its driver cannot write them,
    ROADMAP F11(b)).  Returns the state and the dumps' data."""
    import os
    import tempfile

    from athenak_tpu.z4c import cce as jax_cce

    spec = JOBS[job]
    pin = JaxInput.from_string(spec["text"])
    pin.modify_from_cmdline(spec["overrides"])
    pin.set_value("mesh", "coalesce", "false")
    pin.set_value("mesh", "pencil_pack", "false")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda f=None, **kw: f)
        mesh, phys, pgen, driver, state = jax_build(pin)
        state = driver.initialize(state)
        fn = driver.make_cycle_fn()
        dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
        for _ in range(spec["ncyc"]):
            state, _, _ = fn(state, dt)
        mesh.time = spec["ncyc"] * driver.mesh.dt
        cwd = os.getcwd()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                c = jax_cce.read_cce(jax_cce.CCE(pin, mesh, 0).dump(
                    mesh, phys, state["u"]))
                h = jax_cce.read_horizon_dump(jax_cce.HorizonDump(
                    pin, mesh, 0).dump(mesh, phys, state["u"]), 6)
            finally:
                os.chdir(cwd)
    return {"state": jax.tree_util.tree_map(np.asarray, state),
            "time": mesh.time, "cce": c, "horizon": h}


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    """(split runs, one-rank runs, JAX runs) by job: the ranks make the
    split runs and then, dealt out among them, the one-rank runs, while
    this process makes the JAX runs."""
    fut = D.split_and_one(JOBS, [k for k, v in JOBS.items()
                                 if v.get("kind") != "part"
                                 and k != "part_s"])
    with D.jax_pool() as pool:
        jx = {k: pool.submit(_jax_run, k) for k in JAX_JOBS}
        jx.update({k: pool.submit(_jax_drive, k) for k in ("part3",
                                                            "partn")})
        jx["cce"] = pool.submit(_jax_cce, "cce")
        jx = {k: f.result() for k, f in jx.items()}
    split, one = fut.result()
    return split, one, jx


def _close(got, ref, rtol, atol):
    for k, v in ref.items():
        if isinstance(v, dict):
            _close(got[k], v, rtol, atol)
        elif isinstance(v, np.ndarray) and v.dtype.kind == "f":
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol,
                                       err_msg=k)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# (job, rtol, atol) of the JAX test each deck comes from; 0 is a bit match
TOLS = [("turb", 1e-10, 1e-13), ("z4c", 5e-13, 1e-16),
        ("beam", 5e-13, 1e-16), ("lwave", 5e-13, 1e-16),
        ("dyngr", 5e-13, 1e-16), ("ion", 5e-13, 1e-16),
        ("part", 0, 0), ("g_blast", 0, 0), ("g_smr", 0, 0),
        ("g_z4c", 5e-13, 1e-16), ("g_rad", 5e-13, 1e-16)]


@pytest.mark.parametrize("job,rtol,atol", TOLS)
def test_split_cycle_matches_one_rank(runs, job, rtol, atol):
    """The gathered split state (every leaf: the turbulence key, the
    tracker positions, T, z, the particles) against the one-rank run's
    at the JAX shard test's bar, and the new dt."""
    split, one, _ = runs
    assert np.isclose(split[job]["dtnew"], one[job]["dtnew"], rtol=1e-12)
    if rtol == 0:
        assert split[job]["dtnew"] == one[job]["dtnew"]
    _close(split[job]["state"], one[job]["state"], rtol, atol)


def test_turbulence_drives_and_trackers_move(runs):
    """The forcing is not a silent no-op on the ranks and the trackers
    stay finite (test_turb_shard.py, dryrun_multichip)."""
    split, _, _ = runs
    assert np.abs(split["turb"]["state"]["turb_force"]).max() > 0.0
    np.testing.assert_array_equal(split["turb"]["state"]["turb_key"],
                                  runs[1]["turb"]["state"]["turb_key"])
    assert np.isfinite(split["g_z4c"]["state"]["co_pos"]).all()
    assert split["g_blast"]["nmb"] == 6


@pytest.mark.parametrize("job", JAX_JOBS)
def test_split_cycle_matches_jax(runs, job):
    """The split run against the JAX package's one-device run of the
    same deck and cycles: 1e-10 of each field's scale."""
    split, _, jx = runs
    ref, rdt = jx[job]
    assert np.isclose(split[job]["dtnew"], rdt, rtol=1e-10)
    keys = [k for k in ("u", "w", "i0", "ui", "wi", "bfc", "turb_force",
                        "T", "z") if k in ref]
    assert_states_close(split[job]["state"], {k: ref[k] for k in keys},
                        1e-10, keys=[k for k in keys if k != "bfc"])
    if "co_pos" in ref:
        np.testing.assert_allclose(split[job]["state"]["co_pos"],
                                   ref["co_pos"], rtol=1e-10, atol=1e-12)
    if "prtcl_x" in ref:
        np.testing.assert_allclose(split[job]["state"]["prtcl_x"],
                                   ref["prtcl_x"], rtol=0, atol=1e-12)


def _key(r):
    return tuple(np.round(r, 12))


def _by_rank(rec, world=4):
    x, alive = rec["x"], rec["alive"]
    n = len(alive) // world
    return {d: sorted(_key(r) for r in x[d * n:(d + 1) * n][
        alive[d * n:(d + 1) * n]]) for d in range(world)}


def _wanted(rec, world=4):
    x, dest, alive = rec["x0"], rec["dest"], rec["alive0"]
    return {d: sorted(_key(x[i]) for i in range(len(x))
                      if alive[i] and dest[i] == d) for d in range(world)}


@pytest.mark.parametrize("job", ["x_route", "x_dead"])
def test_exchange_routes_to_destination(runs, job):
    """Every live particle on its destination rank, none lost, no
    overflow left (test_part_comm.py's balanced and dead-slot cases)."""
    rec = runs[0][job]
    assert rec["overflow"].sum() == 0
    assert rec["alive"].sum() == rec["alive0"].sum()
    assert _by_rank(rec) == _wanted(rec)


def test_exchange_under_a_one_row_cap_keeps_particles(runs):
    """A one-row cap: the overflow is reported and every unshipped
    particle stays alive where it was."""
    rec = runs[0]["x_overflow"]
    assert rec["alive"].sum() == rec["alive0"].sum()
    assert rec["overflow"].sum() > 0
    orig = {_key(r) for r in rec["x0"]}
    assert all(_key(r) in orig for r in rec["x"][rec["alive"]])


def test_particle_gids_match_jax():
    """The device owner-gid lookup against the JAX package's
    ``gids_jnp`` and the port's host ``Particles.gids`` on the particle
    blast's mesh, positions on and off the blocks' faces."""
    from athenak_tpu.main import build as jbuild
    from athenak_tpu.parallel.part_comm import gids_jnp
    from athenak_tpu_torch import main as torch_main
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.parallel.part_comm import gids

    _, phys, _, _, _ = torch_main.build(ParameterInput.from_string(PART),
                                        device="cpu")
    _, jphys, _, _, _ = jbuild(JaxInput.from_string(PART))
    rng = np.random.default_rng(3)
    x = rng.uniform([-1, -0.5, -0.5], [1, 0.5, 0.5], (4000, 3))
    x[:8] = [[-1, -0.5, -0.5], [0, 0, 0], [0.5, 0.25, -0.25],
             [1, 0.5, 0.5], [-0.5, 0, 0.25], [0.125, 0.125, 0.125],
             [0.999, -0.499, 0.499], [-1, 0.5, -0.5]]
    got = gids(phys.ppart, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(gids_jnp(jphys.ppart, x)))
    np.testing.assert_array_equal(got, phys.ppart.gids(x))


@pytest.mark.parametrize("job", LIFTED)
def test_lifted_configuration_bitwise_one_rank(runs, job):
    """Drift particles on 3 ranks (409 particles, 137 slots a rank, the
    last rank's tail dead; 8 particles, as many as the blocks) and the
    CCE and horizon dumps on 2 ranks: the gathered state, dt, time and
    counters bitwise the one-rank run's, every file the run wrote (trk,
    the dumps, the restart files) byte-equal, and the dumps' -r resume
    bitwise too."""
    split, one, _ = runs
    a, b = split[job], one[job]
    assert (a["time"], a["dt"], a["ncycle"]) == (b["time"], b["dt"],
                                                 b["ncycle"])
    assert a["ecounters"] == b["ecounters"]
    _close(a["state"], b["state"], 0, 0)
    assert sorted(a["files"]) == sorted(b["files"])
    for f in b["files"]:
        assert a["files"][f] == b["files"][f], f
    if job.startswith("part"):
        n = a["state"]["prtcl_x"].shape[0]
        assert n in (409, a["nmb"]) and n % 3 != 0
        assert any(f.endswith(".trk") for f in b["files"])
    else:
        assert sum(f.startswith("cce/") for f in b["files"]) == 2
        assert sum(f.endswith("etk_output_file.dat")
                   for f in b["files"]) == 2
        ra, rb = a["restart"], b["restart"]
        assert (ra["time"], ra["ncycle"]) == (rb["time"], rb["ncycle"])
        _close(ra["state"], rb["state"], 0, 0)


def _trk_rows(text):
    return np.array([[float(v) for v in line.split()]
                     for line in text.splitlines()
                     if line and not line.startswith("#")])


@pytest.mark.parametrize("job", LIFTED)
def test_lifted_configuration_matches_jax(runs, job, tmp_path):
    """The same split runs against the JAX package's: the particle decks
    through its driver and ``trk`` output on its gather path over 2
    virtual devices (state and the trk rows to 1e-10), the CCE deck on
    one device with its own dumps of the final state (the z4c state, the
    worldtube's and the horizon cube's data to 1e-10)."""
    split, _, jx = runs
    got, ref = split[job], jx[job]
    np.testing.assert_allclose(got["time"], ref["time"], rtol=1e-12)
    keys = [k for k in ("u", "w") if k in ref["state"]]
    assert_states_close(got["state"], {k: ref["state"][k] for k in keys},
                        1e-10, keys=keys)
    if job.startswith("part"):
        np.testing.assert_allclose(got["state"]["prtcl_x"],
                                   ref["state"]["prtcl_x"], rtol=0,
                                   atol=1e-12)
        mine = [f for f in got["files"] if f.endswith(".trk")]
        a = _trk_rows(got["files"][mine[0]].decode())
        b = _trk_rows(ref["trk"])
        assert a.shape == b.shape and a.shape[0] > 0
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
        return
    from athenak_tpu_torch.z4c import cce
    # the final dumps: the worldtube's of the latest time, the cube's of
    # the highest count
    dumps = []
    for i, f in enumerate(f for f in got["files"] if f.startswith("cce/")):
        (tmp_path / f"c{i}.bin").write_bytes(got["files"][f])
        dumps.append(cce.read_cce(str(tmp_path / f"c{i}.bin")))
    c = max(dumps, key=lambda d: d["time"])
    cube = sorted(f for f in got["files"]
                  if f.endswith("etk_output_file.dat"))[-1]
    (tmp_path / "h.dat").write_bytes(got["files"][cube])
    h = cce.read_horizon_dump(str(tmp_path / "h.dat"), 6)
    assert np.isclose(c["time"], ref["cce"]["time"], rtol=1e-12)
    assert np.isclose(h["time"], ref["horizon"]["time"], rtol=1e-12)
    for a, b in ((c["real"], ref["cce"]["real"]),
                 (c["imag"], ref["cce"]["imag"]),
                 (h["data"], ref["horizon"]["data"])):
        assert a.shape == b.shape
        assert_close(a, b, 1e-10, "dump", scale=float(np.abs(b).max()))
