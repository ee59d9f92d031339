"""Multi-rank execution: the block axis split over a torch.distributed
process group.

Counterpart of ``athenak_tpu/parallel/__init__.py`` (reference:
src/mesh/load_balance.cpp:38-90, src/bvals/bvals_cc.cpp:42-289).  The
reference's only parallelism is MPI ranks over MeshBlocks; the JAX
package maps it to ``shard_map`` over a 1-D device mesh, and the port to
one process a rank.  Each rank holds its own blocks
(``shard_comm.ShardLayout``), runs the driver's cycle on them and
moves donor slabs to the ranks that need them as per-peer packed
point-to-point messages (``shard_comm.ShardComm``); dt is an all-reduce
MIN and the counters an all-reduce SUM.

``Ranks`` takes the place of the JAX package's ``make_device_mesh``: the
process group, this process's rank, the world size, the backend and the
rank's device.  The backend is the caller's choice and never changes:

  * ``nccl``: one rank a card, ``cuda:{rank}`` (raises with fewer cards
    than ranks);
  * ``gloo`` on a card: every rank on ``cuda:0``, each packed message
    staged through pinned host buffers (gloo moves host memory only and
    NCCL refuses two ranks on one card), so a one-card machine runs the
    multi-rank path;
  * ``gloo`` on the CPU (the tests), when the caller asks for it.

A gloo group's device is the caller's ``device`` or $ATHENAK_DEVICE,
``cuda`` by default, as the port's entry points choose theirs
(``main.resolve_device``): without a card that raises.

``spawn_ranks`` starts the ranks as child processes that meet through a
``FileStore`` in a temporary directory (no TCP port to fight over).
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

#: seconds a collective may wait before the group fails the run
DEFAULT_TIMEOUT = 300.0


class Ranks:
    """A process group over which the block axis is split.  ``group`` is
    None for the default group."""

    def __init__(self, backend: str, device, group=None) -> None:
        self.group = group
        self.backend = backend
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.device = torch.device(device)
        # gloo moves host memory: tensors on a card cross through pinned
        # host buffers, one growable buffer a (peer, direction, dtype)
        # viewed at each message's shape, so the new routes of a tree
        # update reuse it
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self._pinned: Dict[tuple, torch.Tensor] = {}
        # what moved: bytes this rank sent point to point, the exchanges
        # it took part in, its all-gathers and the bytes it gave them
        self.sent_bytes = 0
        self.exchanges = 0
        self.gathers = 0
        self.gathered_bytes = 0

    # -- construction ----------------------------------------------------
    @classmethod
    def init(cls, backend: str, rank: int, world: int, init_method: str,
             timeout: float = DEFAULT_TIMEOUT, device=None) -> "Ranks":
        """Join the default group on the rank's device (``rank_device``)."""
        device = rank_device(backend, rank, world, device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        kw = {}
        if backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout), **kw)
        ranks = cls(backend, device)
        # the first collective is one every rank joins (NCCL's
        # point-to-point calls need the communicator made by then)
        ranks.barrier()
        return ranks

    def sub(self, n: int) -> Optional["Ranks"]:
        """The group of ranks 0 .. n-1, or None on the other ranks.  Every
        rank of this group must call it, in the same order."""
        if n == self.world:
            return self
        grp = dist.new_group(list(range(n)), backend=self.backend)
        if self.rank >= n:
            return None
        return Ranks(self.backend, self.device, group=grp)

    # -- staging -----------------------------------------------------------
    def _host(self, key, like: torch.Tensor) -> torch.Tensor:
        """A pinned host view of ``like``'s shape and dtype, on the
        buffer of ``key`` (grown when too small)."""
        k = (key, like.dtype)
        n = like.numel()
        buf = self._pinned.get(k)
        if buf is None or buf.numel() < n:
            buf = torch.empty(max(n, 1), dtype=like.dtype, pin_memory=True)
            self._pinned[k] = buf
        return buf[:n].view(like.shape)

    def _peer(self, r: int) -> int:
        """Global rank of rank ``r`` of this group."""
        if self.group is None:
            return r
        return dist.get_global_rank(self.group, r)

    # -- point to point ----------------------------------------------------
    def exchange(self, sends: Dict[int, torch.Tensor],
                 recvs: Dict[int, tuple], dtype, device) -> Dict[int,
                                                                 torch.Tensor]:
        """Send ``sends[p]`` to peer p and receive a tensor of shape
        ``recvs[q]`` from peer q, all posted at once
        (``batch_isend_irecv``) and waited for.  Returns the received
        tensors on ``device`` by peer."""
        if not sends and not recvs:
            return {}
        ops, got, back = [], {}, []
        for p, t in sorted(sends.items()):
            t = t.contiguous()
            if self.staged:
                h = self._host(("s", p), t)
                h.copy_(t)
                t = h
            self.sent_bytes += t.numel() * t.element_size()
            ops.append(dist.P2POp(dist.isend, t, self._peer(p), self.group))
        for q, shape in sorted(recvs.items()):
            if self.staged:
                buf = self._host(("r", q), torch.empty(shape, dtype=dtype,
                                                       device="meta"))
                back.append(q)
            else:
                buf = torch.empty(shape, dtype=dtype, device=device)
            got[q] = buf
            ops.append(dist.P2POp(dist.irecv, buf, self._peer(q),
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.exchanges += 1
        for q in back:
            # a blocking copy: the pinned buffer is reused by the next call
            got[q] = got[q].to(device)
        return got

    # -- collectives -------------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of ``t`` on the device the backend moves: the host for
        gloo, the rank's card for nccl (whatever device ``t`` is on: a
        host dt bound, say)."""
        want = self.device if self.backend == "nccl" else torch.device("cpu")
        return t.detach().to(want, copy=True).contiguous()

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        w = self._wire(t)
        dist.all_reduce(w, op=op, group=self.group)
        return w if w.device == t.device else w.to(t.device)

    def all_min(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(torch.as_tensor(t), dist.ReduceOp.MIN)

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(torch.as_tensor(t), dist.ReduceOp.SUM)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's equal-shaped ``t`` along axis 0, in
        rank order, on every rank (a tree update's redistribution, the
        AMR flags, and in a cycle the source of a whole-mesh solve,
        ``comm.whole_blocks``)."""
        src = self._wire(t)
        parts = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(parts, src, group=self.group)
        self.gathers += 1
        self.gathered_bytes += src.numel() * src.element_size()
        return torch.cat(parts, 0).to(t.device)

    def barrier(self) -> None:
        self.all_sum(torch.zeros(1, device=self.device))


def rank_device(backend: str, rank: int, world: int,
                device=None) -> torch.device:
    """The device of ``rank`` under ``backend`` (see the module text);
    ``device`` chooses a gloo group's (default $ATHENAK_DEVICE, else
    cuda)."""
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < world:
            raise RuntimeError(
                f"nccl puts one rank on each card: {world} ranks need "
                f"{world} cards, this machine has {n} (use gloo to run "
                "several ranks on one card)")
        return torch.device(f"cuda:{rank}")
    if backend == "gloo":
        dev = torch.device(device if device is not None else
                           os.environ.get("ATHENAK_DEVICE", "cuda"))
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "gloo ranks on the card were asked for but CUDA is not "
                    "available (pass device='cpu' or set "
                    "ATHENAK_DEVICE=cpu for a CPU run)")
            return torch.device("cuda:0")
        return dev
    raise ValueError(f"backend '{backend}': nccl or gloo")


def check_divisible(nmb_total: int, world: int) -> None:
    """Every rank needs a block (reference: src/mesh/load_balance.cpp:
    55-63 imposes nmb >= nranks).  The JAX package's check asks for a
    count the devices divide, for its NamedSharding path; the port gives
    the ranks counts that differ by at most one
    (``shard_comm.ShardLayout``)."""
    if nmb_total < world:
        raise ValueError(
            f"nmb_total={nmb_total} blocks cannot cover {world} ranks; "
            "choose smaller meshblocks")


# ---------------------------------------------------------------------------
def tree_map(fn, tree):
    """``fn`` on every tensor of a state (dicts of tensors and dicts)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def block_leaf(key, a, n) -> bool:
    """Whether state entry ``key``'s tensor ``a`` is split along the
    block axis (its leading extent ``n``).  The particle arrays
    (``prtcl_*``) and ``REPLICATED_KEYS`` never are, by key, so a
    particle count equal to a block count is no ambiguity."""
    return (key not in REPLICATED_KEYS and isinstance(a, torch.Tensor)
            and a.ndim >= 1 and a.shape[0] == n
            and not key.startswith("prtcl_"))


def shard_state(state, comm):
    """The rank's rows of every block leaf of a global state in gid order
    (``comm.local_gids``) and its share of the particle arrays
    (``prtcl_*``: ``comm.Lp`` = ceil(nprtcl / world) slots a rank in
    particle order; where the ranks do not divide the count, the last
    rank's tail slots clone particle 0 and are dead,
    ``comm.prtcl_alive``); the small leaves (the tracker positions
    ``co_pos``, the turbulence key, the time) stay whole on every rank.
    Particle arrays are told from block arrays by their key, whatever
    their length."""
    def keep(key, a):
        if key.startswith("prtcl_"):
            p0, n = comm.rank * comm.Lp, comm.Lp
            rows = torch.arange(p0, p0 + n, device=a.device)
            return a[torch.where(rows < a.shape[0], rows, 0)]
        if block_leaf(key, a, comm.nmb):
            return a[torch.as_tensor(comm.local_gids, device=a.device)]
        return a

    return {k: tree_map(lambda a, k=k: keep(k, a), v)
            for k, v in state.items()}


#: state entries kept whole on every rank: the turbulence driver's key
#: (every rank draws the same modes; the reference broadcasts the same
#: amplitudes, turb_driver.cpp:500-560), the puncture trackers (kept
#: equal by the SUM in ``z4c_amr.device_interp``) and the time
REPLICATED_KEYS = frozenset({"turb_key", "co_pos", "t"})


# ---------------------------------------------------------------------------
#: the program of a rank of ``spawn_ranks``: python -c _RANK_MAIN RANK
#: WORLD BACKEND STORE JOB PARENT_PID
_RANK_MAIN = ("import sys\n"
              "from athenak_tpu_torch.parallel import _rank_main\n"
              "sys.exit(_rank_main(sys.argv[1:]))\n")


def _rank_main(argv) -> int:
    """Child process of ``spawn_ranks``: join the group, run the
    function, write its result, leave the group."""
    rank, world, backend, store, job, parent = argv
    rank, world = int(rank), int(world)
    # Linux kills this rank when the process that spawned it dies
    # (PR_SET_PDEATHSIG), so no rank outlives a killed run
    import ctypes
    import signal
    ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
    if os.getppid() != int(parent):
        return 1
    with open(job, "rb") as f:
        fn_name, args, timeout = pickle.load(f)
    if backend == "gloo" and os.environ.get("ATHENAK_DEVICE") == "cpu":
        torch.set_num_threads(1)
    mod, name = fn_name.split(":")
    fn = getattr(importlib.import_module(mod), name)
    ranks = Ranks.init(backend, rank, world, f"file://{store}",
                       timeout=timeout)
    try:
        out = fn(ranks, *args)
        ranks.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{job}.{rank}", "wb") as f:
        pickle.dump(out, f)
    return 0


def spawn_ranks(fn, world: int, backend: str = "gloo", device=None,
                args=(), timeout: float = 900.0, env=None,
                group_timeout: float = DEFAULT_TIMEOUT):
    """Run ``fn(ranks, *args)`` on ``world`` ranks, each a child process
    (``_RANK_MAIN``), and return their results
    in rank order.  ``fn`` is a module-level function (or
    "module:name"); the ranks start in the directory that holds the port
    and import a function's module from where this process found it (a
    "module:name" from that directory or PYTHONPATH).  ``device`` chooses
    a gloo group's device as ``rank_device`` does (default
    $ATHENAK_DEVICE, else the card).  A rank that fails, or a run longer than
    ``timeout`` seconds, kills the others and raises with the failing
    rank's error output; a collective that waits ``group_timeout``
    seconds fails its rank."""
    where = []
    if callable(fn):
        src = getattr(sys.modules.get(fn.__module__), "__file__", None)
        if src:
            # the function's module is found where the caller found it
            where.append(os.path.dirname(os.path.abspath(src)))
        fn = f"{fn.__module__}:{fn.__qualname__}"
    # raises here, before any rank starts, for nccl with too few cards
    # and for a card that is not there
    rank_device(backend, 0, world, device)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    penv = dict(os.environ if env is None else env)
    path = [root] + where + [p for p in penv.get(
        "PYTHONPATH", "").split(os.pathsep) if p]
    penv["PYTHONPATH"] = os.pathsep.join(path)
    if device is not None:
        penv["ATHENAK_DEVICE"] = str(device)
    if backend == "gloo" and penv.get("ATHENAK_DEVICE") == "cpu":
        penv.setdefault("OMP_NUM_THREADS", "1")
    with tempfile.TemporaryDirectory(prefix="ranks") as tmp:
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, tuple(args), min(timeout, group_timeout)), f)
        store = os.path.join(tmp, "store")
        procs = []
        for r in range(world):
            err = open(os.path.join(tmp, f"err{r}"), "w+")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _RANK_MAIN,
                 str(r), str(world), backend, store, job, str(os.getpid())],
                stdout=err, stderr=subprocess.STDOUT, env=penv,
                cwd=root), err))
        t_end = time.monotonic() + timeout
        failed = None
        try:
            while True:
                codes = [p.poll() for p, _ in procs]
                bad = [r for r, c in enumerate(codes)
                       if c is not None and c != 0]
                if bad:
                    failed = (bad[0], f"exit {codes[bad[0]]}")
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > t_end:
                    failed = (next(r for r, c in enumerate(codes)
                                   if c is None), f"timeout {timeout} s")
                    break
                time.sleep(0.05)
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            logs = []
            for _, f in procs:
                f.seek(0)
                logs.append(f.read())
                f.close()
        if failed is not None:
            r, why = failed
            raise RuntimeError(f"rank {r} of {world} ({backend}): {why}\n"
                               + logs[r][-4000:])
        outs = []
        for r in range(world):
            with open(f"{job}.{r}", "rb") as f:
                outs.append(pickle.load(f))
        return outs
