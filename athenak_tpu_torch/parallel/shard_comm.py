"""Block communication across ranks: per-peer packed slab exchange.

Counterpart of ``athenak_tpu/parallel/shard_comm.py`` (reference: the
rank-packed MPI messages of src/bvals/bvals_cc.cpp:42-255,
bvals.hpp:104-172).  Design:

  * Blocks are Z-ordered and assigned contiguously in gid order (the
    reference's ``Mesh::LoadBalance`` ranges, load_balance.cpp:38-90):
    as evenly as the count allows for uniform costs, by the cost-weighted
    assignment with ``mesh.cost_eachmb`` uneven.  A rank holds its own
    blocks and no pad (the JAX package pads every rank to the largest
    count for ``shard_map``; here a pad's dt and floor counts would enter
    the MIN and the SUM), so a rank's count may differ from another's.
  * Every block-axis movement of the port is a gather with a host gid map
    (``comm.BlockTables.gather``: same-level halo donors, the
    mixed-level fine and coarse donors, EMF and flux-correction
    partners).  Under a ``ShardComm`` each distinct map becomes a
    ``_Route``, built once on the host and kept by the map: for every
    peer, the local slab indices to pack, and for every local slot where
    its donor lies in ``cat([local] + received)``.  One ``index_select``
    a peer packs the messages, one ``batch_isend_irecv`` moves all of
    them, one ``index_select`` unpacks; local donors never leave the
    device.  Duplicated donors are packed twice, unused slabs never sent.
  * Per-block tables (physical-BC masks, parity tables, dx, geometry) are
    read through ``comm.local_blocks``, which hands each rank its rows.
  * A module that solves on the whole mesh (the self-gravity FFT and
    multigrid) reads its source through ``comm.whole_blocks``, one
    all-gather of every rank's rows into gid order, and keeps its own
    rows of the result (``comm.own_blocks``): what XLA's SPMD
    partitioner inserts on the JAX package's NamedSharding gather path,
    written out.  Every rank does the same float work on the same data,
    so a split run stays bitwise its one-rank run.

The volume a fill moves is one ng-thick slab a block face whose neighbour
lies on another rank, the reference's MPI traffic.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..comm import use_comm
from . import block_leaf, check_divisible, tree_map


class ShardLayout:
    """gid <-> slot map for one world size.  Blocks are assigned
    contiguously in gid order: for uniform costs as evenly as the count
    allows (the first ``nmb % world`` ranks one block more), else by the
    cost-weighted assignment of ``mesh.load_balance``.  Rank r holds
    ``nmb_eachrank[r]`` blocks, gids from ``first_gid[r]`` on; its slots
    are ``r * L + [0, nmb_eachrank[r])``, L the largest count, so that an
    all-gather of every rank's rows padded to L reads back by
    ``slot_of_gid``.  No rank computes on a pad: a rank holds its own
    blocks and nothing else."""

    def __init__(self, mesh, world: int) -> None:
        from ..mesh import load_balance

        nmb = mesh.nmb_total
        check_divisible(nmb, world)
        cost = np.asarray(getattr(mesh, "cost_eachmb",
                                  np.ones(nmb, np.float32)),
                          dtype=np.float64)
        self.nmb = nmb
        self.world = world
        self.uniform = bool(np.all(cost == cost[0]))
        if self.uniform:
            counts = nmb // world + (np.arange(world) < nmb % world)
            self.rank_eachmb = np.repeat(np.arange(world), counts)
        else:
            self.rank_eachmb = load_balance(cost, world)[0]
        self.nmb_eachrank = np.bincount(self.rank_eachmb, minlength=world)
        self.first_gid = np.concatenate(
            [[0], np.cumsum(self.nmb_eachrank)[:-1]]).astype(np.int64)
        self.L = int(self.nmb_eachrank.max())
        self.slot_of_gid = (self.rank_eachmb * self.L
                            + np.arange(nmb, dtype=np.int64)
                            - self.first_gid[self.rank_eachmb])
        self.cost_eachrank = np.bincount(self.rank_eachmb, weights=cost,
                                         minlength=world)
        # the reference's load-balance figure (driver.cpp:425-432): the
        # share of ideal throughput the heaviest rank leaves
        total = float(self.cost_eachrank.sum())
        self.lb_efficiency = total / (world * float(
            self.cost_eachrank.max())) if total > 0 else 1.0

    def gids(self, rank: int) -> np.ndarray:
        """The gids rank ``rank`` holds, in order."""
        return self.first_gid[rank] + np.arange(self.nmb_eachrank[rank])


def shard_layout(mesh, world: int) -> ShardLayout:
    """The mesh's layout for ``world`` ranks, made once and kept."""
    cache = mesh.__dict__.setdefault("_shard_layouts", {})
    lay = cache.get(world)
    if lay is None:
        lay = cache[world] = ShardLayout(mesh, world)
    return lay


class _Route:
    """The packed exchange of one gid map ``idx`` (out[g] = in[idx[g]])
    seen from rank ``rank``.

    send[p]   local block indices packed for peer p, in the order of its
              receiving blocks
    recv[q]   how many slabs peer q sends here
    src_slot  [n]: where local block i finds its donor in
              cat([local slabs] + [received from q, ascending q])
    """

    def __init__(self, idx: np.ndarray, layout: ShardLayout,
                 rank: int) -> None:
        if idx.shape != (layout.nmb,):
            raise ValueError(f"a block gid map has shape ({layout.nmb},), "
                             f"got {idx.shape}")
        owner = layout.rank_eachmb[idx]          # the donor's rank
        local = idx - layout.first_gid[owner]    # its index there
        self.send = {}
        for p in range(layout.world):
            if p == rank:
                continue
            recv = layout.gids(p)
            mine = owner[recv] == rank
            if mine.any():
                self.send[p] = local[recv][mine].astype(np.int64)
        own = layout.gids(rank)
        self.recv = {}
        src = np.empty(len(own), dtype=np.int64)
        off = len(own)
        for q in range(layout.world):
            pick = owner[own] == q
            if q == rank:
                src[pick] = local[own][pick]
                continue
            n = int(pick.sum())
            if n:
                self.recv[q] = n
                src[pick] = off + np.arange(n)
                off += n
        self.src_slot = src
        self.identity = (not self.recv and not self.send
                         and np.array_equal(src, np.arange(len(own))))
        self._dev = {}

    def tensors(self, device):
        """The send lists and src_slot on ``device``, copied once."""
        key = str(device)
        hit = self._dev.get(key)
        if hit is None:
            hit = ({p: torch.as_tensor(v, device=device)
                    for p, v in self.send.items()},
                   torch.as_tensor(self.src_slot, device=device))
            self._dev[key] = hit
        return hit


class ShardComm:
    """The exchange the port's block-axis code consults while the cycle
    runs on one rank's blocks (``comm.use_comm``)."""

    def __init__(self, mesh, ranks, nprtcl: int = 0) -> None:
        self.layout = shard_layout(mesh, ranks.world)
        self.ranks = ranks
        self.rank = ranks.rank
        self.world = ranks.world
        self.nmb = mesh.nmb_total
        self.L = self.layout.L
        # the blocks this rank holds
        self.local_gids = self.layout.gids(self.rank)
        self.n = len(self.local_gids)
        # the particle axis: ceil(nprtcl / world) slots a rank, the last
        # rank's tail dead (``prtcl_alive``)
        self.nprtcl = nprtcl
        self.Lp = math.ceil(nprtcl / self.world)
        self._routes: Dict[int, tuple] = {}
        self._rows: Dict[int, tuple] = {}
        self._idx: Dict[tuple, torch.Tensor] = {}

    # -- arbitrary block gather ------------------------------------------
    def route(self, idx) -> _Route:
        hit = self._routes.get(id(idx))
        if hit is None:
            hit = (idx, _Route(np.asarray(idx).astype(np.int64),
                               self.layout, self.rank))
            self._routes[id(idx)] = hit
        return hit[1]

    def gather(self, slab, idx):
        """slab: this rank's donor slabs [n, ...]; returns [n, ...] with
        out[local index of gid g] = global_slab[idx[g]]."""
        route = self.route(idx)
        if route.identity:
            return slab
        send, src = route.tensors(slab.device)
        if not route.recv and not send:
            return torch.index_select(slab, 0, src)
        rest = tuple(slab.shape[1:])
        got = self.ranks.exchange(
            {p: torch.index_select(slab, 0, t) for p, t in send.items()},
            {q: (n,) + rest for q, n in route.recv.items()},
            slab.dtype, slab.device)
        allbuf = torch.cat([slab] + [got[q] for q in sorted(got)], 0)
        return torch.index_select(allbuf, 0, src)

    # -- per-block host tables -------------------------------------------
    def local_rows(self, tab):
        """This rank's [n, ...] rows of a [nmb, ...] table (numpy or a
        tensor), made once a table."""
        if tab.ndim < 1 or tab.shape[0] != self.nmb:
            return tab
        hit = self._rows.get(id(tab))
        if hit is not None:
            return hit[1]
        if isinstance(tab, torch.Tensor):
            out = torch.index_select(tab, 0, torch.as_tensor(
                self.local_gids, device=tab.device))
        else:
            out = np.asarray(tab)[self.local_gids]
        self._rows[id(tab)] = (tab, out)
        return out

    def _index(self, name, make, device):
        """A host index array (``make()``) on ``device``, copied once."""
        key = (name, str(device))
        hit = self._idx.get(key)
        if hit is None:
            hit = self._idx[key] = torch.as_tensor(make(), device=device)
        return hit

    def whole_blocks(self, x):
        """This rank's [n, ...] rows -> every block's [nmb, ...] rows in
        gid order on every rank (``comm.whole_blocks``): one all-gather
        of every rank's rows padded to L, read back by ``slot_of_gid``."""
        if self.n < self.L:
            x = torch.cat([x, x.new_zeros((self.L - self.n,)
                                          + tuple(x.shape[1:]))], 0)
        allx = self.ranks.all_gather(x)
        return torch.index_select(allx, 0, self._index(
            "gid", lambda: self.layout.slot_of_gid, allx.device))

    def own_blocks(self, x):
        """Every block's [nmb, ...] rows in gid order -> this rank's
        [n, ...] rows (``comm.own_blocks``)."""
        return torch.index_select(x, 0, self._index(
            "own", lambda: self.local_gids, x.device))

    def prtcl_alive(self, device):
        """[Lp] bool: the particle slots of this rank that hold a
        particle (the last rank's tail is padding when the ranks do not
        divide the count)."""
        return self._index("alive", lambda: (
            self.rank * self.Lp + np.arange(self.Lp)) < self.nprtcl,
            device)

    # -- reductions --------------------------------------------------------
    def pmin(self, x):
        return self.ranks.all_min(x)

    def psum(self, x):
        return self.ranks.all_sum(x)

    # -- whole states ------------------------------------------------------
    def collect(self, state, everywhere: bool = False):
        """The global state in gid order: on rank 0 (the others get None)
        or, with ``everywhere``, on every rank.  Used for outputs, the
        returned state and a tree update, never inside a cycle.  The
        ranks' blocks in rank order are the blocks in gid order (the
        assignment is contiguous)."""
        counts = self.layout.nmb_eachrank

        def whole(key, a):
            if key.startswith("prtcl_"):
                # the particle slots in rank order, the dead tail dropped
                a = self.ranks.all_gather(a) if everywhere \
                    else self._to_root(a, [self.Lp] * self.world)
                return None if a is None else a[:self.nprtcl]
            if not block_leaf(key, a, self.n):
                return a
            return self.whole_blocks(a) if everywhere \
                else self._to_root(a, counts)

        out = {k: tree_map(lambda a, k=k: whole(k, a), v)
               for k, v in state.items()}
        return out if everywhere or self.rank == 0 else None

    def _to_root(self, a, rows):
        """Every rank's ``a`` concatenated in rank order on rank 0 (peer
        q's has ``rows[q]`` rows); None elsewhere."""
        ranks = self.ranks
        if self.rank != 0:
            ranks.exchange({0: a}, {}, a.dtype, a.device)
            return None
        rest = tuple(a.shape[1:])
        got = ranks.exchange({}, {q: (int(rows[q]),) + rest
                                  for q in range(1, self.world)},
                             a.dtype, a.device)
        return torch.cat([a] + [got[q] for q in range(1, self.world)], 0)


# ---------------------------------------------------------------------------
def unsupported(driver, state):
    """None where the rank-split cycle covers the configuration, else
    what it does not cover.  It covers every physics that
    ``main.make_physics`` builds (Hydro, MHD, Z4c, DynGRMHD, Radiation,
    RadiationFluid, IonNeutral) with every module the JAX package runs
    on more than one device: the ones of its shard cycle, and the ones
    it leaves to its NamedSharding gather path, which the port writes
    out as explicit collectives: self-gravity (the FFT and the multigrid
    solve on the whole mesh, ``comm.whole_blocks``), the shearing box
    (its ring remap through the exchange), the AMR block pool (a route
    choice; a tree update redistributes as without it), user boundary
    functions (each reads its tables through ``comm.local_blocks``), and
    drift particles of any count (``shard_state``).  What is left is a
    physics class this list does not name."""
    name = type(driver.phys).__name__
    if name not in ("Hydro", "MHD", "Z4c", "DynGRMHD", "Radiation",
                    "RadiationFluid", "IonNeutral"):
        return f"the {name} physics"
    return None


def build_shard_cycle(driver, comm):
    """The driver's cycle on one rank's blocks: ``fn(state, dt) -> (state,
    dtnew, counters)`` with the exchange of ``comm``, dtnew the MIN over
    the ranks in the state's dtype (JAX's ``lax.pmin`` keeps its dtype)
    and the counters their SUM."""
    inner = driver.make_cycle_fn()

    def cycle(state, dt):
        with use_comm(comm):
            state, dtnew, counters = inner(state, dt)
        dtnew = comm.pmin(torch.as_tensor(dtnew, dtype=state["u"].dtype))
        if counters:
            keys = sorted(counters)
            tot = comm.psum(torch.stack([
                torch.as_tensor(counters[k], dtype=torch.float64,
                                device=dtnew.device) for k in keys]))
            counters = {k: tot[i] for i, k in enumerate(keys)}
        return state, dtnew, counters

    return cycle
