"""The rank-split cycle of the port on every physics the JAX package's
shard cycle covers, and the particle exchange (gloo on the CPU, each
rank a child process; ``athenak_tpu_torch/parallel``).

One spawn of four ranks runs, in float64: the decks of
tests/test_turb_shard.py, test_z4c_shard.py, test_rad_shard.py (the Kerr
beam, the coupled linear wave), test_dyngr_shard.py,
test_ion_neutral_shard.py and test_part_comm.py's particle blast, the
four decks of ``__graft_entry__.py::dryrun_multichip`` at four devices
(a blast whose 6 blocks pad to 8, the 2-D SMR MHD blast, the Z4c two
punctures with trackers, rad_relax), and test_part_comm.py's three
exchange cases.  Each deck runs its cycle function at the first dt, as
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
from torch_deck_parity import assert_states_close, jit_o0  # noqa: E402
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
