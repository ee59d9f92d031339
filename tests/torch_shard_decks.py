"""Decks of the port's rank-split tests and the code each rank runs (not
a test file; it imports no JAX, so the ranks of ``spawn_ranks`` start
quickly).

``rank_jobs(ranks, jobs)`` runs every job of ``jobs`` (name -> spec) in
turn on the ranks of one ``gloo`` group, each on a subgroup of the
spec's ``world`` ranks; rank 0 returns the results by name.
``one_rank(text, ...)`` runs a deck the same way with no group.  A spec:

  text, overrides   the deck and its block/par=value overrides
  ncyc              cycles (``time/nlim``)
  world             ranks (the group's first ``world``)
  cost              per-block costs set on the mesh before the layout
  outputs           return the bytes of every file the run wrote, by
                    its path (each run is made in a fresh directory)
  restart           (file name, overrides): after the run, resume from
                    that file of the run's directory with ``-r``
  fill_bytes        also measure one ghost fill of ``u``: the bytes each
                    rank sent
  fixed_dt          run the cycle function ``ncyc`` times at the first
                    dt, as the JAX package's shard tests do, instead of
                    the driver's loop; the last new dt is returned
  kind = "part"     the particle exchange of ``part_job`` instead of a
                    deck
  kind = "blocks"   ``blocks_job``: the whole-mesh all-gather and its
                    inverse on ranks of unequal counts
"""

from __future__ import annotations

import glob
import os
import shutil
import tempfile

import numpy as np
import torch

from athenak_tpu_torch import main as torch_main
from athenak_tpu_torch.athinput import ParameterInput
from athenak_tpu_torch.state import state_to_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


DECK = """
<job>
basename = shardcomm

<mesh>
nghost = 2
nx1 = 32
x1min = -1.0
x1max = 1.0
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = 16
x3min = -0.5
x3max = 0.5
ix1_bc = outflow
ox1_bc = outflow

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
b_amb = 0.1
"""

def shift(text, frac=0.3, overrides=()):
    """Overrides moving a deck's domain (after ``overrides``) by ``frac``
    of a root cell along every axis of more than one cell: a blast at
    rest centred on block faces cannot be held against the JAX package
    cycle by cycle on the CPU (ROADMAP F4), so the JAX comparisons run
    the shifted deck."""
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(list(overrides))
    out = []
    for d in (1, 2, 3):
        n = pin.get_integer("mesh", f"nx{d}")
        if n == 1:
            continue
        lo, hi = (pin.get_real("mesh", f"x{d}{e}") for e in ("min", "max"))
        q = frac * (hi - lo) / n
        out += [f"mesh/x{d}min={lo + q}", f"mesh/x{d}max={hi + q}"]
    return out


#: 6 blocks on 4 ranks: 2, 2, 1 and 1
DECK6 = DECK.replace("nx1 = 32", "nx1 = 48").replace(
    "nx2 = 16", "nx2 = 8").replace("nx3 = 16", "nx3 = 8")


def _build(spec, ranks):
    pin = ParameterInput.from_string(spec["text"])
    pin.modify_from_cmdline(list(spec.get("overrides", ()))
                            + [f"time/nlim={spec.get('ncyc', 3)}"])
    dev = ranks.device if ranks is not None else "cpu"
    mesh, phys, pgen, driver, state = torch_main.build(pin, device=dev)
    if spec.get("cost") is not None:
        mesh.cost_eachmb = np.asarray(spec["cost"], np.float32)
    driver.ranks = ranks
    return pin, mesh, phys, pgen, driver, state


def _fill_bytes(driver, state):
    """One fill of ``u`` on this rank's blocks: the bytes every rank sent
    (rank order) and the all-gathers the fill ran."""
    from athenak_tpu_torch.comm import use_comm
    ranks, comm = driver.ranks, driver.comm
    u = state["u"].clone()
    b0, g0 = ranks.sent_bytes, ranks.gathers
    with use_comm(comm):
        driver.phys.bvals.fill_ghosts(u)
    gathers = ranks.gathers - g0
    sent = ranks.all_gather(torch.tensor([ranks.sent_bytes - b0]))
    return {"sent": sent.tolist(), "gathers": gathers}


def run_spec(spec, ranks=None):
    """One deck through the port: build, initialise, run ``ncyc``
    cycles.  Returns the whole final state (numpy) and the host record on
    rank 0 (or with no group), None on the other ranks."""
    from athenak_tpu_torch.outputs import make_outputs
    cwd = os.getcwd()
    # every rank runs in rank 0's fresh directory: rank 0 writes there
    tmp = _shared_dir(ranks)
    os.chdir(tmp)
    try:
        pin, mesh, phys, pgen, driver, state = _build(spec, ranks)
        outputs = make_outputs(pin, mesh, phys, driver)
        state = driver.initialize(state)
        extra = {}
        if spec.get("fill_bytes") and ranks is not None:
            extra["fill"] = _fill_bytes(driver, state)
        g0 = driver.ranks.gathers if ranks is not None else 0
        if spec.get("fixed_dt"):
            cycle = driver._build_cycle()
            dt = driver.mesh.dt
            tot = {}
            for _ in range(spec.get("ncyc", 3)):
                state, dtnew, counters = cycle(state, dt)
                for k, v in (counters or {}).items():
                    tot[k] = tot.get(k, 0) + int(v)
            extra["dtnew"] = float(dtnew)
            extra["counters"] = tot
            state = driver._unpadded(state)
        elif spec.get("profile"):
            # -p under ranks: each rank traces its run into one file
            prof = os.path.join(tmp, "prof")
            with torch_main.profiled(prof, driver.phys.device,
                                     None if ranks is None else ranks.rank):
                state = driver.execute(state, outputs=outputs)
            if ranks is not None:
                ranks.barrier()
            extra["traces"] = {f: _trace_events(os.path.join(prof, f))
                               for f in sorted(os.listdir(prof))}
        else:
            state = driver.execute(state, outputs=outputs)
            extra["report"] = driver.finalize_report()
        pgrav = getattr(driver.phys, "pgrav", None)
        if pgrav is not None:
            # each rank's solves and V-cycles (every rank solves on the
            # whole mesh, so all must count alike)
            n = torch.tensor([pgrav.nsolve, getattr(pgrav, "ncycles", 0)])
            extra["vcycles"] = (ranks.all_gather(n[None]) if ranks
                                is not None else n[None]).tolist()
        if ranks is not None:
            extra["gathers_in_run"] = driver.ranks.gathers - g0
            extra["sent_bytes"] = driver.ranks.sent_bytes
            extra["lb"] = (driver._layout.nmb_eachrank.tolist(),
                           driver._layout.uniform,
                           driver._layout.lb_efficiency)
        if spec.get("restart"):
            fname, over = spec["restart"]
            _, _, d2, s2 = torch_main.run_restart(
                os.path.join(tmp, fname), over,
                device=ranks.device if ranks is not None else "cpu",
                ranks=ranks)
            extra["restart"] = None if s2 is None else {
                "state": state_to_numpy(s2), "time": d2.mesh.time,
                "ncycle": d2.mesh.ncycle}
        if state is None:
            return None
        rec = {"state": state_to_numpy(state), "time": driver.mesh.time,
               "dt": driver.mesh.dt, "ncycle": driver.mesh.ncycle,
               "nmb": driver.mesh.nmb_total,
               "ecounters": dict(driver.ecounters), **extra}
        pamr = driver.pamr
        if pamr is not None:
            rec["amr"] = {"leaves": list(driver.mesh.leaves),
                          "created": pamr.nmb_created,
                          "deleted": pamr.nmb_deleted,
                          "trees": [(u["ncycle"], u["leaves"])
                                    for u in pamr.updates]}
        if spec.get("outputs"):
            # every file the run wrote, by its path in the run directory
            rec["files"] = {f: open(f, "rb").read() for f in sorted(
                glob.glob("**", recursive=True)) if os.path.isfile(f)}
        return rec
    finally:
        os.chdir(cwd)
        if ranks is not None:
            ranks.barrier()
        if ranks is None or ranks.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)


def _trace_events(path):
    """The number of events of a ``torch.profiler`` trace file (parsed
    as JSON)."""
    import json
    with open(path) as f:
        return len(json.load(f)["traceEvents"])


def _shared_dir(ranks):
    """A fresh directory made by rank 0, its name on every rank."""
    if ranks is None:
        return tempfile.mkdtemp(prefix="shard")
    t = torch.zeros(256, dtype=torch.uint8)
    if ranks.rank == 0:
        b = tempfile.mkdtemp(prefix="shard").encode()
        t[:len(b)] = torch.frombuffer(bytearray(b), dtype=torch.uint8)
    t = ranks.all_sum(t)
    return bytes(t[t > 0].tolist()).decode()


def one_rank(text, **spec):
    """A deck with no group."""
    return run_spec(dict(spec, text=text))


def part_case(seed, nlive, world, dead_frac=0.0, balanced=False):
    """tests/test_part_comm.py's exchange case as numpy: positions [2
    nlive, 4] with the live particles on the even slots, each slot's
    destination rank, and the live mask."""
    rng = np.random.default_rng(seed)
    nslot = 2 * nlive
    x = rng.standard_normal((nslot, 4))
    dest = rng.integers(0, world, nslot)
    if balanced:
        dest[0::2] = rng.permutation(np.repeat(np.arange(world),
                                               nlive // world))
    alive = np.zeros(nslot, bool)
    alive[0::2] = rng.random(nlive) >= dead_frac
    return x, dest, alive


def part_job(ranks, spec):
    """Up to ``passes`` exchanges of the rank's share of ``part_case``;
    every rank's slots and overflow gathered to rank 0."""
    from athenak_tpu_torch.parallel.part_comm import exchange_particles
    x, dest, alive = part_case(spec["seed"], spec["nlive"], ranks.world,
                               spec.get("dead_frac", 0.0),
                               spec.get("balanced", False))
    L = len(alive) // ranks.world
    sl = slice(ranks.rank * L, (ranks.rank + 1) * L)
    parts = {"x": torch.as_tensor(x[sl])}
    al = torch.as_tensor(alive[sl])
    de = torch.as_tensor(dest[sl])
    for _ in range(spec.get("passes", 1)):
        parts, al, de, ovf = exchange_particles(ranks, parts, al, de,
                                                cap=spec.get("cap"))
        tot = int(ranks.all_sum(torch.tensor([ovf]))[0])
        if tot == 0:
            break
    xs = ranks.all_gather(parts["x"])
    als = ranks.all_gather(al)
    ovfs = ranks.all_gather(torch.tensor([ovf]))
    if ranks.rank != 0:
        return None
    return {"x": xs.numpy(), "alive": als.numpy(), "overflow":
            ovfs.numpy(), "x0": x, "dest": dest, "alive0": alive}


def blocks_job(ranks, spec):
    """``comm.whole_blocks`` and ``comm.own_blocks`` on DECK's 16 blocks
    split over the group (3 ranks: 6, 5 and 5 blocks): each rank's rows
    hold 10 gid + [0, 1]; returns, on rank 0, every rank's whole array,
    its own rows of the gid-ordered table 100 + gid and its gids (both
    padded with -1 to the largest count, for the gather here), the
    identity of both outside ``use_comm``, and each rank's live particle
    slots of 17 particles (``prtcl_alive``)."""
    from athenak_tpu_torch.comm import own_blocks, use_comm, whole_blocks
    from athenak_tpu_torch.mesh import Mesh
    from athenak_tpu_torch.parallel.shard_comm import ShardComm

    def comm_mesh():
        return Mesh(ParameterInput.from_string(DECK))

    comm = ShardComm(comm_mesh(), ranks)
    g = torch.as_tensor(comm.local_gids, dtype=torch.float64)
    rows = 10.0 * g[:, None] + torch.tensor([0.0, 1.0])
    table = 100.0 + torch.arange(comm.nmb, dtype=torch.float64)
    outside = (whole_blocks(rows) is rows, own_blocks(table) is table)
    with use_comm(comm):
        whole = whole_blocks(rows)
        own = own_blocks(table)
    fill = torch.full((comm.L - comm.n,), -1.0, dtype=torch.float64)
    got = ranks.all_gather(torch.cat([whole.flatten(), own, fill])[None])
    gids = ranks.all_gather(torch.cat([g, fill])[None])
    # 17 particles on the group: ceil(17 / world) slots a rank
    alive = ranks.all_gather(ShardComm(
        comm_mesh(), ranks, nprtcl=17).prtcl_alive("cpu")[None])
    if ranks.rank != 0:
        return None
    n = 2 * comm.nmb
    return {"whole": got[:, :n].reshape(ranks.world, comm.nmb, 2).numpy(),
            "own": got[:, n:].numpy(), "gids": gids.numpy(),
            "nmb": comm.nmb, "L": comm.L, "outside": outside,
            "alive": alive.numpy()}


def rank_jobs(ranks, jobs, solo=()):
    """Every job on its subgroup, in order; then the one-rank runs of the
    jobs named in ``solo``, dealt out over the ranks, each with no group.
    Returns (the split results by name on rank 0, else None; this rank's
    one-rank results by name)."""
    out = {}
    for name, spec in jobs.items():
        sub = ranks.sub(spec.get("world", ranks.world))
        if sub is None:
            continue
        if spec.get("kind") == "part":
            out[name] = part_job(sub, spec)
            continue
        if spec.get("kind") == "blocks":
            out[name] = blocks_job(sub, spec)
            continue
        out[name] = run_spec(spec, sub)
    mine = {name: run_spec(jobs[name])
            for i, name in enumerate(solo) if i % ranks.world == ranks.rank}
    return (out if ranks.rank == 0 else None), mine


def split_and_one(jobs, solo, world=4):
    """Start ``world`` ranks on ``jobs`` and the one-rank runs of ``solo``
    (see ``rank_jobs``); returns a future of (split results, one-rank
    results), so the caller works meanwhile."""
    from concurrent.futures import ThreadPoolExecutor

    from athenak_tpu_torch.parallel import spawn_ranks

    def run():
        outs = spawn_ranks(rank_jobs, world, device="cpu",
                           args=(jobs, tuple(solo)), timeout=600,
                           group_timeout=120)
        one = {}
        for _, mine in outs:
            one.update(mine)
        return outs[0][0], one

    pool = ThreadPoolExecutor(1)
    fut = pool.submit(run)
    pool.shutdown(wait=False)
    return fut


def _jax_child() -> None:
    """Set a fresh interpreter up as tests/conftest.py sets up the test
    process (JAX on the CPU with eight virtual devices, float64), at a
    lower priority than the ranks, which wait for their slowest."""
    os.nice(19)
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def jax_pool(nproc=4):
    """``nproc`` fresh interpreters for the JAX package's reference runs,
    made beside each other and beside the ranks (each compiles its own
    cycle, which is most of its time and holds one core).  Spawned, not
    forked: this process runs JAX's threads.  Submit a module-level
    function of a test module, the longest jobs first."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(
        nproc, mp_context=multiprocessing.get_context("spawn"),
        initializer=_jax_child)


# ---------------------------------------------------------------------------
# the decks of __graft_entry__.py::dryrun_multichip at n_devices = 4 (its
# blast with a block count that does not divide, the 2-D SMR MHD blast,
# the Z4c two punctures with trackers, rad_relax), here in float64
def _graft_blast():
    return DECK.replace("basename = shardcomm", "basename = graft_blast") \
        .replace("nx1 = 32", "nx1 = 24").replace(
            "ix1_bc = outflow\nox1_bc = outflow\n", "").replace(
            "<meshblock>\nnx1 = 8\nnx2 = 8\nnx3 = 8",
            "<meshblock>\nnx1 = 4\nnx2 = 16\nnx3 = 16")


GRAFT_BLAST = _graft_blast()

GRAFT_SMR = """
<job>
basename = graft_smr

<mesh>
nghost = 2
nx1 = 32
x1min = -1.0
x1max = 1.0
nx2 = 32
x2min = -1.0
x2max = 1.0
nx3 = 1
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 8
nx2 = 8

<mesh_refinement>
refinement = static
num_levels = 2

<refined_region1>
level = 1
x1min = -0.25
x1max = 0.25
x2min = -0.25
x2max = 0.25
x3min = -0.25
x3max = 0.25

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0

<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld

<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
b_amb = 0.1
"""

GRAFT_Z4C = """
<job>
basename = graft_z4c

<mesh>
nghost = 2
nx1 = 16
x1min = -8.0
x1max = 8.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 16
x2min = -8.0
x2max = 8.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 16
x3min = -8.0
x3max = 8.0
ix3_bc = outflow
ox3_bc = outflow

<meshblock>
nx1 = 16
nx2 = 16
nx3 = 4

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 1.0

<z4c>
diss = 0.5
damp_kappa1 = 0.02
nco = 2
co_0_x = 3.0
co_0_radius = 1.0
co_1_x = -3.0
co_1_radius = 1.0

<problem>
pgen_name = z4c_two_punctures
par_b = 3.0
par_m_plus = 0.5
par_m_minus = 0.5
"""

GRAFT_RAD = """
<job>
basename = graft_rad

<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
nx2 = 4
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5

<meshblock>
nx1 = 4
nx2 = 4

<coord>
general_rel = true
minkowski = true

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 10.0

<hydro>
eos = ideal
gamma = 2.0
reconstruct = plm
rsolver = hlle

<radiation>
nlevel = 1
arad = 1.0
kappa_a = 1.0
kappa_s = 0.0
kappa_p = 0.0

<problem>
pgen_name = rad_relax
erad = 1.0
temp = 100.0
"""

