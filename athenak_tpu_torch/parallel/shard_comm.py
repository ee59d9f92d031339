"""Block communication across ranks: per-peer packed slab exchange.

Counterpart of ``athenak_tpu/parallel/shard_comm.py`` (reference: the
rank-packed MPI messages of src/bvals/bvals_cc.cpp:42-255,
bvals.hpp:104-172).  Design:

  * Blocks are Z-ordered and assigned contiguously: rank r owns the pool
    slots ``[r*L, (r+1)*L)`` (the reference's ``Mesh::LoadBalance``
    ranges, load_balance.cpp:38-90).  With uniform costs gid g sits in
    slot g and the pool's tail is padding; with ``mesh.cost_eachmb``
    uneven, the cost-weighted assignment decides each rank's count and
    every rank's range is padded to the largest, L.  Pad slots clone
    block 0 and evolve as isolated periodic boxes.
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


def padded_nmb(nmb_total: int, world: int) -> int:
    """Pool capacity: the smallest multiple of ``world`` >= nmb_total."""
    return world * math.ceil(nmb_total / world)


class ShardLayout:
    """gid <-> pool-slot map for one world size (the JAX package's
    ``ShardLayout``): the identity layout for uniform costs, else the
    cost-weighted contiguous assignment padded to the largest rank."""

    def __init__(self, mesh, world: int) -> None:
        from ..mesh import load_balance

        nmb = mesh.nmb_total
        check_divisible(nmb, world)
        cost = np.asarray(getattr(mesh, "cost_eachmb",
                                  np.ones(nmb, np.float32)),
                          dtype=np.float64)
        self.nmb = nmb
        self.world = world
        if bool(np.all(cost == cost[0])):
            self.rank_eachmb = np.minimum(
                np.arange(nmb) // math.ceil(nmb / world), world - 1)
            self.L = math.ceil(nmb / world)
            self.slot_of_gid = np.arange(nmb, dtype=np.int64)
            self.identity = True
        else:
            self.rank_eachmb, gids_each, nmb_each = load_balance(cost,
                                                                 world)
            self.L = int(nmb_each.max())
            self.slot_of_gid = (self.rank_eachmb * self.L
                                + np.arange(nmb, dtype=np.int64)
                                - gids_each[self.rank_eachmb])
            self.identity = False
        self.nmb_pad = self.L * world
        self.gid_of_slot = np.full(self.nmb_pad, -1, dtype=np.int64)
        self.gid_of_slot[self.slot_of_gid] = np.arange(nmb)
        self.nmb_eachrank = np.bincount(self.rank_eachmb, minlength=world)
        self.cost_eachrank = np.bincount(self.rank_eachmb, weights=cost,
                                         minlength=world)
        # the reference's load-balance figure (driver.cpp:425-432): the
        # share of ideal throughput the heaviest rank leaves
        total = float(self.cost_eachrank.sum())
        self.lb_efficiency = total / (world * float(
            self.cost_eachrank.max())) if total > 0 else 1.0


def shard_layout(mesh, world: int) -> ShardLayout:
    """The mesh's layout for ``world`` ranks, made once and kept."""
    cache = mesh.__dict__.setdefault("_shard_layouts", {})
    lay = cache.get(world)
    if lay is None:
        lay = cache[world] = ShardLayout(mesh, world)
    return lay


def pad_state(state, layout: ShardLayout):
    """Every [nmb, ...] leaf arranged into the [nmb_pad] pool, pad slots
    cloning block 0."""
    if layout.nmb_pad == layout.nmb and layout.identity:
        return state
    rows = np.where(layout.gid_of_slot >= 0, layout.gid_of_slot, 0)

    def pad(key, a):
        if not block_leaf(key, a, layout.nmb):
            return a
        return torch.index_select(a, 0, torch.as_tensor(rows,
                                                        device=a.device))

    return {k: tree_map(lambda a, k=k: pad(k, a), v)
            for k, v in state.items()}


def unpad_state(state, layout: ShardLayout):
    """A [nmb_pad] pool state back in gid order."""
    if layout.nmb_pad == layout.nmb and layout.identity:
        return state
    idx = layout.slot_of_gid

    def unpad(key, a):
        if not block_leaf(key, a, layout.nmb_pad):
            return a
        return torch.index_select(a, 0, torch.as_tensor(idx,
                                                        device=a.device))

    return {k: tree_map(lambda a, k=k: unpad(k, a), v)
            for k, v in state.items()}


class _Route:
    """The packed exchange of one gid map ``idx`` (out[g] = in[idx[g]])
    seen from rank ``rank``.

    send[p]   local slab indices packed for peer p, in the order of the
              receiving slots
    recv[q]   how many slabs peer q sends here
    src_slot  [L]: where local slot i finds its donor in
              cat([local slabs] + [received from q, ascending q])
    """

    def __init__(self, idx: np.ndarray, layout: ShardLayout,
                 rank: int) -> None:
        if idx.shape != (layout.nmb,):
            raise ValueError(f"a block gid map has shape ({layout.nmb},), "
                             f"got {idx.shape}")
        L, world = layout.L, layout.world
        # gid-space donor map -> slot space; pads donate to themselves
        perm = np.arange(layout.nmb_pad, dtype=np.int64)
        real = layout.gid_of_slot >= 0
        perm[real] = layout.slot_of_gid[idx[layout.gid_of_slot[real]]]
        owner = perm // L
        self.send = {}
        for p in range(world):
            if p == rank:
                continue
            sl = slice(p * L, (p + 1) * L)
            mine = owner[sl] == rank
            if mine.any():
                self.send[p] = (perm[sl][mine] % L).astype(np.int64)
        sl = slice(rank * L, (rank + 1) * L)
        own, dn = owner[sl], perm[sl] % L
        self.recv = {}
        src = np.empty(L, dtype=np.int64)
        off = L
        for q in range(world):
            pick = own == q
            if q == rank:
                src[pick] = dn[pick]
                continue
            n = int(pick.sum())
            if n:
                self.recv[q] = n
                src[pick] = off + np.arange(n)
                off += n
        self.src_slot = src
        self.identity = (not self.recv and not self.send
                         and np.array_equal(src, np.arange(L)))
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
        self.nmb_pad = self.layout.nmb_pad
        self.L = self.layout.L
        self.nprtcl = nprtcl
        gos = self.layout.gid_of_slot[self.rank * self.L:
                                      (self.rank + 1) * self.L]
        self.local_gids = gos            # -1 in pad slots
        self._routes: Dict[int, tuple] = {}
        self._rows: Dict[tuple, tuple] = {}

    # -- arbitrary block gather ------------------------------------------
    def route(self, idx) -> _Route:
        hit = self._routes.get(id(idx))
        if hit is None:
            hit = (idx, _Route(np.asarray(idx).astype(np.int64),
                               self.layout, self.rank))
            self._routes[id(idx)] = hit
        return hit[1]

    def gather(self, slab, idx):
        """slab: this rank's donor slabs [L, ...]; returns [L, ...] with
        out[slot of gid g] = global_slab[idx[g]]."""
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
    def local_rows(self, tab, pad_edge: bool):
        """This rank's [L, ...] rows of a [nmb, ...] table (numpy or a
        tensor), made once a table; pad rows copy row 0 (``pad_edge``,
        geometry) or are zero (masks: pads take no physical BCs)."""
        if tab.ndim < 1 or tab.shape[0] != self.nmb:
            return tab
        key = (id(tab), pad_edge)
        hit = self._rows.get(key)
        if hit is not None:
            return hit[1]
        gos = self.local_gids
        rows = np.where(gos >= 0, gos, 0)
        if isinstance(tab, torch.Tensor):
            out = torch.index_select(tab, 0, torch.as_tensor(
                rows, device=tab.device))
            if not pad_edge and (gos < 0).any():
                keep = torch.as_tensor(gos >= 0, device=tab.device)
                out = torch.where(keep.reshape((-1,) + (1,) * (
                    out.ndim - 1)), out, torch.zeros_like(out))
        else:
            out = np.asarray(tab)[rows]
            if not pad_edge:
                out = np.where((gos >= 0).reshape(
                    (-1,) + (1,) * (out.ndim - 1)), out,
                    np.zeros_like(out))
        self._rows[key] = (tab, out)
        return out

    # -- reductions --------------------------------------------------------
    def pmin(self, x):
        return self.ranks.all_min(x)

    def psum(self, x):
        return self.ranks.all_sum(x)

    # -- whole states ------------------------------------------------------
    def collect(self, state, everywhere: bool = False):
        """The global state in gid order: on rank 0 (the others get None)
        or, with ``everywhere``, on every rank.  Used for outputs, the
        returned state and a tree update, never inside a cycle."""
        def whole(key, a):
            if not (block_leaf(key, a, self.L) or key.startswith("prtcl_")):
                return a
            return self.ranks.all_gather(a) if everywhere \
                else self._to_root(a)

        out = {k: tree_map(lambda a, k=k: whole(k, a), v)
               for k, v in state.items()}
        if not everywhere and self.rank != 0:
            return None
        return unpad_state(out, self.layout)

    def _to_root(self, a):
        ranks = self.ranks
        if self.rank != 0:
            ranks.exchange({0: a}, {}, a.dtype, a.device)
            return None
        got = ranks.exchange({}, {q: tuple(a.shape)
                                  for q in range(1, self.world)},
                             a.dtype, a.device)
        return torch.cat([a] + [got[q] for q in range(1, self.world)], 0)


# ---------------------------------------------------------------------------
def unsupported(driver, state):
    """None where the rank-split cycle covers the configuration (the JAX
    package's ``supports_shard_cycle``: Hydro, MHD, Z4c, DynGRMHD,
    Radiation, RadiationFluid and IonNeutral; uniform, SMR, and AMR
    without the block pool; Newtonian, SR and GR, with diffusion, source
    terms, FOFC, turbulence and drift particles), else what it does not
    cover.  The JAX package runs those on its NamedSharding gather path;
    PyTorch has no SPMD partitioner to stand in for XLA's, so under more
    than one rank the port raises for them."""
    phys = driver.phys
    name = type(phys).__name__
    if name not in ("Hydro", "MHD", "Z4c", "DynGRMHD", "Radiation",
                    "RadiationFluid", "IonNeutral"):
        return f"the {name} physics"
    if getattr(driver.mesh, "adaptive", False) \
            and getattr(driver.mesh, "amr_pool", False):
        return "the AMR block pool (mesh_refinement/block_pool = true)"
    for mod, what in (("psbox", "the shearing box"),
                      ("pgrav", "self-gravity")):
        if getattr(phys, mod, None) is not None:
            return what
    bvals = getattr(phys, "bvals", None)
    if bvals is None:
        return "a physics without block boundaries"
    ubc = bvals.user_bc_func
    if ubc is not None and not getattr(ubc, "shard_safe", False):
        # user BCs closing over [nmb] arrays must read them through
        # comm.local_blocks and say so with `fn.shard_safe = True`
        return "a user boundary function without shard_safe"
    ppart = getattr(phys, "ppart", None)
    if ppart is not None:
        world = driver.ranks.world
        nmb = driver.mesh.nmb_total
        if ppart.nprtcl % world != 0 or ppart.nprtcl in (
                nmb, padded_nmb(nmb, world)):
            return (f"{ppart.nprtcl} particles on {world} ranks (the "
                    "particle axis splits evenly and apart from the "
                    "block axis)")
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
