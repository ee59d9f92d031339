"""The port's block axis split over ``torch.distributed`` ranks (gloo on
the CPU, each rank a child process; ``athenak_tpu_torch/parallel``).

One spawn of four ranks runs every deck of the module (the decks of
tests/test_shard_comm.py, test_load_balance.py's weighted layout, the
outputs and a restart, the configurations the JAX package runs on its
NamedSharding gather path), each on the group of its first 2, 3 or 4
ranks, in float64, and then the one-rank runs, dealt out among the
ranks; four fresh interpreters make the JAX package's runs meanwhile.
Held:

  * the split run, gathered, bitwise the port's one-rank run where the
    JAX test asserts a bit match (test_shard_comm.py: uniform, padded,
    SMR hydro and MHD; the weighted layout), at the JAX test's tolerance
    elsewhere (GR), the same trees and the state bitwise on the AMR deck;
  * the split run against the JAX package's single-device run to 1e-10,
    and the uniform blast against the JAX package's own shard cycle on
    eight virtual devices;
  * the exchange volume: a fill sends exactly the ng-thick slabs whose
    receiver lies on another rank, counted here from the mesh's gid maps,
    and no all-gather runs in a cycle;
  * ``load_balance`` against the JAX package's on test_load_balance.py's
    three cost lists;
  * the gather path's configurations (self-gravity by FFT and by
    multigrid, the shearing box, the AMR block pool, the shadow's and the
    hohlraum's user boundaries) on 2 ranks bitwise their one-rank runs
    and within 1e-10 of the JAX package's gather path on 2 virtual
    devices (the block pool: its one-device driver); ``whole_blocks`` and
    ``own_blocks`` on ranks of unequal counts; nccl with too few cards
    raises;
  * ``bin`` and ``rst`` files and a ``-r`` resume on 4 ranks byte-equal
    to one rank's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.main import build as jax_build  # noqa: E402
from athenak_tpu.mesh import load_balance as jax_load_balance  # noqa: E402
from athenak_tpu.parallel import make_device_mesh  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.mesh import Mesh, load_balance  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.parallel import rank_device, spawn_ranks  # noqa: E402
from athenak_tpu_torch.parallel.shard_comm import ShardLayout  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (assert_close, assert_states_close,  # noqa: E402
                               interior, jit_o0)
import torch_shard_decks as D  # noqa: E402

SMR = D.deck_literal("test_shard_comm.py", "SMR_DECK")
SMR_H = SMR.format(phys="hydro", rsolver="hllc")
SMR_M = SMR.format(phys="mhd", rsolver="hlld")
GR = D.deck_literal("test_shard_comm.py", "GR_DECK")
AMR = D.deck_literal("test_shard_comm.py", "AMR_DECK")
# 16 blocks: the first four five times as heavy (test_load_balance.py)
COST = [5.0] * 4 + [1.0] * 12
OUT = D.DECK + """
<output1>
file_type = bin
variable = mhd_w
dcycle = 1

<output2>
file_type = rst
dcycle = 2
"""
SMALL_BOX = ["meshblock/nx1=8", "meshblock/nx2=8"]
ROOT16 = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
# blast_amr with the block pool (its default route for MHD), cut to a
# 32^2 plane of 8^2 blocks in float64 (in 3-D the JAX package's pool
# recompiles its padded cycle as its capacity climbs: 165 s on the CPU
# at 16^3), the refinement threshold lowered so that the tree refines
# at the first check (cycle 2: the 4 central blocks of 16 refine, 28
# leaves on two levels), moved off the blast's symmetry for the JAX
# comparison (ROADMAP F4)
POOL = ["mesh/nx1=32", "mesh/nx2=32", "mesh/nx3=1", "meshblock/nx1=8",
        "meshblock/nx2=8", "meshblock/nx3=1", "job/precision=double",
        "amr_criterion1/value_max=1.01"]


def _deck(name):
    with open(f"{D.ROOT}/inputs/{name}.athinput") as f:
        return f.read()

JOBS = {
    "uni": dict(text=D.DECK, world=4, ncyc=3, fixed_dt=True,
                fill_bytes=True),
    "uni3": dict(text=D.DECK, world=3, ncyc=3, fixed_dt=True),
    "six": dict(text=D.DECK6, world=4, ncyc=3, fixed_dt=True),
    "cost": dict(text=D.DECK, world=4, ncyc=3, cost=COST),
    "smr_h": dict(text=SMR_H, world=4, ncyc=3, fixed_dt=True),
    "smr_m": dict(text=SMR_M, world=4, ncyc=3, fixed_dt=True),
    "gr": dict(text=GR, world=4, ncyc=3, fixed_dt=True),
    # the JAX comparisons' decks, shifted off the blast's symmetry (F4)
    "uni_s": dict(text=D.DECK, overrides=D.shift(D.DECK), world=4,
                  ncyc=3, fixed_dt=True),
    "six_s": dict(text=D.DECK6, overrides=D.shift(D.DECK6), world=4,
                  ncyc=3, fixed_dt=True),
    "smr_h_s": dict(text=SMR_H, overrides=D.shift(SMR_H), world=4,
                    ncyc=3, fixed_dt=True),
    "amr": dict(text=AMR, world=4, ncyc=14),
    "smr_m_s": dict(text=SMR_M, overrides=D.shift(SMR_M), world=4,
                    ncyc=3, fixed_dt=True),
    # the adaptive deck cut from 14 to 2 cycles (one tree update) for the
    # JAX comparison: the JAX driver compiles a cycle for every tree
    "amr_s": dict(text=AMR, overrides=D.shift(AMR), world=4, ncyc=2),
    # -p under ranks: a trace a rank
    "prof": dict(text=D.DECK, world=2, ncyc=1, profile=True),
    "out": dict(text=OUT, world=4, ncyc=4, outputs=True,
                restart=("shardcomm.00001.rst", ["time/nlim=4"])),
    # what the JAX package runs on its NamedSharding gather path, each on
    # 2 ranks at the first dt (the AMR block pool through the driver's
    # loop): the FFT Jeans wave, the shearing box, the multigrid with
    # multi-block roots (the spheres widened so that they resolve at
    # 16^3, ROADMAP F19) and with multipole boundaries, the block pool,
    # and the user boundaries of the shadow and the hohlraum
    "sbox": dict(text=_deck("shearing_box/hydro_orb_adv"), world=2,
                 ncyc=3, fixed_dt=True,
                 overrides=["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=4",
                            "meshblock/nx1=8", "meshblock/nx2=16",
                            "meshblock/nx3=4"]),
    "grav": dict(text=_deck("tests/jeans_wave"), world=2, ncyc=3,
                 fixed_dt=True,
                 overrides=["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8",
                            "meshblock/nx1=8", "meshblock/nx2=8",
                            "meshblock/nx3=8"]),
    "mg": dict(text=_deck("tests/selfgravity"), world=2, ncyc=3,
               fixed_dt=True, overrides=ROOT16 + [
                   "meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8",
                   "problem/radius=0.25", "problem/x1=0.3",
                   "problem/x2=-0.4"]),
    "be": dict(text=_deck("tests/be_collapse_mhd"), world=2, ncyc=2,
               fixed_dt=True, overrides=ROOT16 + [
                   "meshblock/nx1=4", "meshblock/nx2=4", "meshblock/nx3=4",
                   "mesh/nghost=2", "problem/njeans=4"]),
    "pool": dict(text=_deck("mhd/blast_amr"), world=2, ncyc=3,
                 overrides=POOL + D.shift(_deck("mhd/blast_amr"),
                                          overrides=POOL)),
    "ubc": dict(text=_deck("radiation/shadow"), world=2, ncyc=3,
                fixed_dt=True,
                overrides=["mesh/nx1=16", "mesh/nx2=8", *SMALL_BOX]),
    "hohl": dict(text=_deck("radiation/hohlraum_1d"), world=2, ncyc=3,
                 fixed_dt=True,
                 overrides=["mesh/nx1=32", "meshblock/nx1=8"]),
    # whole_blocks and own_blocks on 3 ranks of 6, 5 and 5 blocks
    "blocks": dict(kind="blocks", world=3),
}


def _jax_run(job, ndev=0, ncyc=3, gather=False):
    """The JAX test's ``_run`` of a job's deck: ``ncyc`` cycles at the
    first dt, on one device, or on ``ndev`` virtual devices by the shard
    cycle or (``gather``) by the NamedSharding gather path, the state's
    block axis split over the devices and XLA partitioning the cycle
    (XLA's backend optimisation level 0)."""
    pin = JaxInput.from_string(JOBS[job]["text"])
    pin.modify_from_cmdline(list(JOBS[job].get("overrides", ())))
    pin.set_value("mesh", "coalesce", "false")
    pin.set_value("mesh", "pencil_pack", "false")
    mesh, phys, pgen, driver, state = jax_build(pin)
    if ndev:
        driver.dmesh = make_device_mesh(ndev)
    state = driver.initialize(state)
    fn = jit_o0(driver.make_shard_cycle_fn(state) if ndev and not gather
                else driver.make_cycle_fn())
    dt = jnp.asarray(driver.mesh.dt, dtype=state["u"].dtype)
    for _ in range(ncyc):
        state, dtnew, _ = fn(state, dt)
    if gather:
        assert "mb" in str(state["u"].sharding.spec)
        state = driver._unpadded(state)
    return jax.tree_util.tree_map(np.asarray, state), float(dtnew)


def _jax_amr(job):
    """The JAX package's ``main.run`` of an adaptive job (its driver and
    AMR step without the block pool, XLA's backend optimisation level
    0): every tree update as (cycle, leaves), the blocks created and
    deleted, the final time and state."""
    import os
    import tempfile

    from athenak_tpu import amr as jax_amr
    from athenak_tpu import main as jax_main
    from torch_deck_parity import JAX_EXTRA, _jit_o0, _recording

    spec = JOBS[job]
    trees = []
    pin = JaxInput.from_string(spec["text"])
    pin.modify_from_cmdline(JAX_EXTRA + list(spec.get("overrides", ()))
                            + [f"time/nlim={spec['ncyc']}"])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp, \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_amr.AMR, "step",
                   _recording(jax_amr.AMR.step, trees, []))
        mp.setattr(jax, "jit", _jit_o0(jax.jit))
        os.chdir(tmp)
        try:
            mesh, _, driver, st = jax_main.run(pin)
        finally:
            os.chdir(cwd)
    return {"trees": trees, "created": driver.pamr.nmb_created,
            "deleted": driver.pamr.nmb_deleted, "time": mesh.time,
            "state": jax.tree_util.tree_map(np.asarray, st)}


#: the configurations the JAX package runs on its gather path: its runs
#: on 2 virtual devices by that path, the block pool through its driver on
#: one device (its main.run takes no device mesh)
LIFTED = ("sbox", "grav", "mg", "be", "pool", "ubc", "hohl")

#: the JAX package's runs: (function, arguments), the longest first
JAX_RUNS = {"amr_s": (_jax_amr, ("amr_s",)),
            "pool": (_jax_amr, ("pool",)),
            "be": (_jax_run, ("be", 2, 2, True)),
            "smr_m_s": (_jax_run, ("smr_m_s",)),
            "shard": (_jax_run, ("uni_s", 8)),
            "gr": (_jax_run, ("gr",)),
            "uni_s": (_jax_run, ("uni_s",)),
            "smr_h_s": (_jax_run, ("smr_h_s",)),
            "six_s": (_jax_run, ("six_s",)),
            **{k: (_jax_run, (k, 2, 3, True))
               for k in ("mg", "ubc", "sbox", "grav", "hohl")}}


@pytest.fixture(scope="module")
def runs(one_torch_thread):
    """(split runs by job, one-rank runs by job, JAX runs): the ranks make
    the split runs and then, dealt out among them, the one-rank runs,
    while four fresh interpreters make the JAX runs."""
    # the one-rank runs of the decks the JAX comparisons leave unshifted
    solo = sorted((k for k, v in JOBS.items() if not v.get("kind")
                   and not v.get("profile") and not k.endswith("_s")),
                  key=lambda k: k not in ("smr_m", "smr_h"))
    fut = D.split_and_one(JOBS, solo)
    with D.jax_pool() as pool:
        jx = {k: pool.submit(fn, *a) for k, (fn, a) in JAX_RUNS.items()}
        jx = {k: f.result() for k, f in jx.items()}
    split, one = fut.result()
    return split, one, jx


def _bitwise(got, ref):
    for k, v in ref.items():
        if isinstance(v, dict):
            _bitwise(got[k], v)
        elif isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("job", ["uni", "uni3", "six", "smr_h", "smr_m"])
def test_split_cycle_bitwise_one_rank(runs, job):
    """The decks whose JAX tests assert a bit match: the gathered state
    and the new dt bitwise the one-rank run's (3 ranks hold 16 blocks as
    6, 5 and 5; 4 ranks hold 6 as 2, 2, 1 and 1)."""
    split, one, _ = runs
    assert split[job]["nmb"] == one[job]["nmb"]
    assert split[job]["dtnew"] == one[job]["dtnew"]
    _bitwise(split[job]["state"], one[job]["state"])


def test_weighted_layout_bitwise_one_rank(runs):
    """test_load_balance.py's weighted layout through the driver's loop:
    uneven block counts a rank, the state, time and dt chain bitwise;
    the load-balance line of the report."""
    split, one, _ = runs
    counts, uniform, eff = split["cost"]["lb"]
    assert not uniform and min(counts) < max(counts)
    assert 0.0 < eff <= 1.0
    assert split["cost"]["time"] == one["cost"]["time"]
    assert split["cost"]["dt"] == one["cost"]["dt"]
    _bitwise(split["cost"]["state"], one["cost"]["state"])
    assert "load balancing efficiency" in split["cost"]["report"]


def test_gr_split_matches(runs):
    """GR hydro with excision on 4 ranks: the JAX test's tolerance
    (test_shard_comm.py::test_shard_cycle_gr_matches)."""
    split, one, _ = runs
    assert np.isclose(split["gr"]["dtnew"], one["gr"]["dtnew"], rtol=1e-12)
    for k in ("u", "w"):
        np.testing.assert_allclose(split["gr"]["state"][k],
                                   one["gr"]["state"][k], rtol=1e-6,
                                   atol=1e-7)


def test_gr_split_matches_jax(runs):
    """The GR deck on 4 ranks against the JAX package's one-device run,
    outside the horizon's neighbourhood r_ks <= 3 (the horizon at 1.95
    and two cells): u to 1e-10 of its scale, w through the JAX package's
    p2c image to u's scale (ROADMAP F12(b), as
    tests/test_torch_gr_slice.py holds w).  Inside it the c2p beside the
    excision takes the last bits of u: the one-rank port's run sits 5e-9
    from the JAX package's after three cycles, against 2.1e-9 of the
    deck's own response to u moved by two units in the last place
    (ROADMAP F12(d)); beyond r_ks = 3 the gap is some 3e-13."""
    split, _, jx = runs
    got, (ref, rdt) = split["gr"], jx["gr"]
    assert np.isclose(got["dtnew"], rdt, rtol=1e-12)
    pin = ParameterInput.from_string(GR)
    _, tphys, _, _, _ = torch_main.build(pin, device="cpu")
    far = interior(np.broadcast_to(tphys.geom.ks_radius_cc(),
                                   ref["u"][:, 0].shape)[:, None]) > 3.0
    pin = JaxInput.from_string(GR)
    pin.set_value("mesh", "coalesce", "false")
    _, phys, _, _, _ = jax_build(pin)
    scale = float(np.abs(interior(ref["u"])).max())
    for label, a, b in [("u", got["state"]["u"], ref["u"])] + [
            ("w (p2c)", *(np.asarray(phys.prim_to_cons(jnp.asarray(w)))
                          for w in (got["state"]["w"], ref["w"])))]:
        a, b = np.broadcast_arrays(interior(a), interior(b))
        m = np.broadcast_to(far, a.shape)
        assert_close(a[m], b[m], 1e-10, label, scale=scale)


def test_amr_split_same_trees(runs):
    """The adaptive deck (refine and derefine over 14 cycles) on 4 ranks:
    every tree, the created and deleted counts exactly one rank's; the
    state bitwise (every rank remaps the gathered state in gid order)."""
    split, one, _ = runs
    a, b = split["amr"]["amr"], one["amr"]["amr"]
    assert b["created"] > 0 and b["deleted"] > 0
    assert a["trees"] == b["trees"] and a["leaves"] == b["leaves"]
    assert (a["created"], a["deleted"]) == (b["created"], b["deleted"])
    assert split["amr"]["time"] == one["amr"]["time"]
    _bitwise(split["amr"]["state"], one["amr"]["state"])


@pytest.mark.parametrize("job", ["uni_s", "smr_h_s", "six_s", "smr_m_s"])
def test_split_cycle_matches_jax(runs, job):
    """The split run against the JAX package's single-device run of the
    same deck and cycles, 1e-10 of each field's scale (the domain moved
    by 0.3 of a root cell, ROADMAP F4)."""
    split, _, jx = runs
    ref, rdt = jx[job]
    assert np.isclose(split[job]["dtnew"], rdt, rtol=1e-12)
    nmb = split[job]["nmb"]
    ref = {k: (v[:nmb] if hasattr(v, "shape") else
               {c: a[:nmb] for c, a in v.items()})
           for k, v in ref.items() if k in ("u", "w", "bfc")}
    assert_states_close(split[job]["state"], ref, 1e-10)


def test_amr_split_matches_jax(runs):
    """The adaptive deck, cut to 2 cycles and moved by 0.3 of a root
    cell (ROADMAP F4), on 4 ranks against the JAX package's one-device
    driver: every tree update at the same cycle, the created and deleted
    counts, the time and the state to 1e-10."""
    split, _, jx = runs
    a, ref = split["amr_s"], jx["amr_s"]
    assert len(ref["trees"]) >= 1
    assert [(c, [tuple(int(v) for v in leaf) for leaf in t])
            for c, t in a["amr"]["trees"]] == ref["trees"]
    assert (a["amr"]["created"], a["amr"]["deleted"]) == (
        ref["created"], ref["deleted"])
    np.testing.assert_allclose(a["time"], ref["time"], rtol=1e-10)
    assert_states_close(a["state"], ref["state"], 1e-10)


def test_split_cycle_matches_jax_shard_cycle(runs):
    """The uniform blast on 4 ranks against the JAX package's own
    shard_map cycle on 8 virtual devices."""
    split, _, jx = runs
    ref, rdt = jx["shard"]
    assert np.isclose(split["uni_s"]["dtnew"], rdt, rtol=1e-12)
    assert_states_close(split["uni_s"]["state"],
                        {k: ref[k] for k in ("u", "w", "bfc")}, 1e-10)


def test_fill_sends_the_crossing_slabs(runs):
    """One fill of u on 4 ranks: each rank sends exactly the ng-thick
    slabs whose receiver is on another rank (counted from the mesh's gid
    maps and the layout's owners), and no all-gather runs in the cycles."""
    split, _, _ = runs
    pin = ParameterInput.from_string(D.DECK)
    mesh = Mesh(pin)
    mbi = mesh.mb_indcs
    lay = ShardLayout(mesh, 4)
    owner = lay.rank_eachmb
    cells = {"x1": mbi.ncells2 * mbi.ncells3, "x2": mbi.ncells1
             * mbi.ncells3, "x3": mbi.ncells1 * mbi.ncells2}
    nvar = split["uni"]["state"]["u"].shape[1]
    want = np.zeros(4, dtype=np.int64)
    for ax in ("x1", "x2", "x3"):
        for side in ("m", "p"):
            donor = np.asarray(mesh.nbr_gid[ax + side])
            for g in range(mesh.nmb_total):
                if owner[donor[g]] != owner[g]:
                    # float64 slabs [nvar, ng, the other two extents]
                    want[owner[donor[g]]] += 8 * nvar * mbi.ng * cells[ax]
    got = split["uni"]["fill"]
    assert got["gathers"] == 0 and split["uni"]["gathers_in_run"] == 0
    assert got["sent"] == want.tolist() and want.min() > 0


def test_load_balance_matches_jax():
    """test_load_balance.py's three cost lists through both packages:
    the same contiguous assignment."""
    cases = [(np.ones(16), 8), (np.ones(6), 4),
             (np.array([1, 1, 1, 1, 4, 4, 4, 4, 1, 1, 1, 1], float), 4),
             (np.array([100, 1, 1, 1, 1, 1, 1, 1], float), 4)]
    for cost, n in cases:
        for a, b in zip(load_balance(cost, n), jax_load_balance(cost, n)):
            np.testing.assert_array_equal(a, b)
    rank, _, nmb = load_balance(cases[3][0], 4)
    assert nmb[0] == 1 and (np.diff(rank) >= 0).all()
    _, _, nmb = load_balance(np.ones(6), 4)
    assert nmb.tolist() == [1, 1, 2, 2]


@pytest.mark.parametrize("job", LIFTED)
def test_lifted_configuration_bitwise_one_rank(runs, job):
    """What the JAX package leaves to its gather path, on 2 ranks: the
    gathered state, dt, the counters and the time bitwise the one-rank
    run's; every rank solves the gravity decks on the whole mesh, so all
    ranks count the one-rank run's solves and V-cycles; the block pool's
    trees and its redistribution bitwise too."""
    split, one, _ = runs
    a, b = split[job], one[job]
    assert a["nmb"] == b["nmb"] and a["time"] == b["time"]
    assert a["dt"] == b["dt"] and a.get("dtnew") == b.get("dtnew")
    assert a.get("counters") == b.get("counters")
    assert a["ecounters"] == b["ecounters"]
    _bitwise(a["state"], b["state"])
    if "vcycles" in b:
        assert a["vcycles"] == b["vcycles"] * 2
    if job == "mg":
        assert b["vcycles"][0][1] > 0
    if job == "pool":
        assert a["amr"] == b["amr"] and b["amr"]["created"] > 0
        assert a["gathers_in_run"] > 0


@pytest.mark.parametrize("job", LIFTED)
def test_lifted_configuration_matches_jax(runs, job):
    """The same split runs against the JAX package's run of the same
    deck: its NamedSharding gather path on 2 virtual devices at the first
    dt, the block pool through its driver (trees, created and deleted
    counts, time), each field to 1e-10 of its scale."""
    split, _, jx = runs
    got = split[job]
    if job == "pool":
        ref = jx[job]
        assert [(c, [tuple(int(v) for v in leaf) for leaf in t])
                for c, t in got["amr"]["trees"]] == ref["trees"]
        assert (got["amr"]["created"], got["amr"]["deleted"]) == (
            ref["created"], ref["deleted"])
        np.testing.assert_allclose(got["time"], ref["time"], rtol=1e-10)
        assert_states_close(got["state"], ref["state"], 1e-10)
        return
    ref, rdt = jx[job]
    assert np.isclose(got["dtnew"], rdt, rtol=1e-10)
    keys = [k for k in ("u", "w", "i0", "phi") if k in ref]
    if job == "mg":
        # outside the spheres the density sits at the floor (1.2e-38)
        # and falls steeply at their edges, where a velocity is a small
        # momentum over a small density: u (1e-13 of its scale apart)
        # is held everywhere, w where the density exceeds 1e-3 of its
        # peak
        keys.remove("w")
        a, b = interior(got["state"]["w"]), interior(ref["w"])
        m = np.broadcast_to(b[:, :1] > 1e-3 * b[:, 0].max(), b.shape)
        assert m[:, 0].any() and not m[:, 0].all()
        assert_close(a[m], b[m], 1e-10, "w", scale=float(np.abs(b).max()))
    assert_states_close(got["state"], {k: ref[k] for k in keys}, 1e-10,
                        keys=keys)
    if "bfc" in ref:
        assert_states_close(got["state"], {"bfc": ref["bfc"]}, 1e-10,
                            keys=())


def test_whole_and_own_blocks_on_unequal_ranks(runs):
    """16 blocks on 3 ranks (6, 5 and 5 blocks, in gid order):
    ``whole_blocks`` gives every rank every block's rows in gid order;
    ``own_blocks`` gives each rank its rows of a gid-ordered table; both
    are the identity outside ``use_comm``; 17 particles leave the last
    rank's last slot dead."""
    rec = runs[0]["blocks"]
    nmb, L = rec["nmb"], rec["L"]
    assert (nmb, L) == (16, 6) and rec["outside"] == (True, True)
    want = 10.0 * np.arange(nmb)[:, None] + np.array([0.0, 1.0])
    for r in range(3):
        np.testing.assert_array_equal(rec["whole"][r], want)
    gids = rec["gids"]
    np.testing.assert_array_equal(gids, [list(range(6)),
                                         list(range(6, 11)) + [-1],
                                         list(range(11, 16)) + [-1]])
    np.testing.assert_array_equal(rec["own"],
                                  np.where(gids >= 0, 100.0 + gids, -1.0))
    # 17 particles: 6 slots a rank, the last rank's sixth dead
    assert rec["alive"].shape == (3, 6)
    assert rec["alive"].sum(axis=1).tolist() == [6, 6, 5]


def test_unsupported_names_no_lifted_configuration():
    """``shard_comm.unsupported`` returns None for every configuration
    that was refused under ranks (self-gravity by FFT and multigrid, the
    shearing box, the AMR block pool, the hohlraum and shadow user
    boundaries, drift particles of any count)."""
    from athenak_tpu_torch.parallel.shard_comm import unsupported
    for job in LIFTED:
        spec = JOBS[job]
        pin = ParameterInput.from_string(spec["text"])
        pin.modify_from_cmdline(list(spec["overrides"]))
        _, phys, _, driver, state = torch_main.build(pin, device="cpu")
        assert unsupported(driver, state) is None, job
    for ppc in ("0.1", "0.001953125"):
        pin = ParameterInput.from_string(_deck("particles/random_drift"))
        pin.modify_from_cmdline(ROOT16 + [
            "meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8",
            f"particles/ppc={ppc}"])
        _, phys, _, driver, state = torch_main.build(pin, device="cpu")
        assert phys.ppart.nprtcl in (409, driver.mesh.nmb_total)
        assert unsupported(driver, state) is None


def test_nccl_with_too_few_cards_raises():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="nccl puts one rank on each"):
        rank_device("nccl", 0, n + 1)
    with pytest.raises(RuntimeError, match="nccl puts one rank on each"):
        spawn_ranks(D.rank_jobs, n + 1, backend="nccl", args=({},))


def test_gloo_ranks_default_to_the_card(monkeypatch):
    """A gloo group's ranks go on the card unless the caller asks for the
    CPU (``device`` or ATHENAK_DEVICE), as the port's entry points do:
    without a card that raises, before any rank starts."""
    monkeypatch.delenv("ATHENAK_DEVICE", raising=False)
    assert rank_device("gloo", 1, 2, "cpu") == torch.device("cpu")
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    assert rank_device("gloo", 1, 2) == torch.device("cpu")
    monkeypatch.delenv("ATHENAK_DEVICE")
    if torch.cuda.is_available():
        assert rank_device("gloo", 1, 2) == torch.device("cuda:0")
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rank_device("gloo", 0, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn_ranks(D.rank_jobs, 2, args=({},))


def test_profile_writes_a_trace_a_rank(runs):
    """``-p`` under two gloo ranks (``main.profiled``): one trace file a
    rank, named by its rank, each parsing as JSON with events."""
    split, _, _ = runs
    traces = split["prof"]["traces"]
    assert [t.split(".")[0] for t in traces] == ["rank0", "rank1"]
    assert all(t.endswith(".pt.trace.json") for t in traces)
    assert all(n > 0 for n in traces.values())


def test_outputs_and_restart_byte_equal(runs):
    """bin and rst files written by rank 0 of 4 ranks byte-equal to one
    rank's; a -r resume from the cycle-2 file on 4 ranks bitwise one
    rank's resume."""
    split, one, _ = runs
    a, b = split["out"]["files"], one["out"]["files"]
    assert sorted(a) == sorted(b)
    assert any(f.endswith(".bin") for f in a)
    assert any(f.endswith(".rst") for f in a)
    for f in b:
        assert a[f] == b[f], f
    ra, rb = split["out"]["restart"], one["out"]["restart"]
    assert (ra["time"], ra["ncycle"]) == (rb["time"], rb["ncycle"])
    _bitwise(ra["state"], rb["state"])


def test_a_failing_rank_fails_the_run():
    """A rank that raises ends the run: the others are killed and
    ``spawn_ranks`` raises with the failing rank's error."""
    bad = {"bad": dict(text="<job>\nbasename = bad\n", world=2)}
    with pytest.raises(RuntimeError, match=r"rank \d of 2 \(gloo\)"):
        spawn_ranks(D.rank_jobs, 2, device="cpu", args=(bad,),
                    timeout=120, group_timeout=30)
