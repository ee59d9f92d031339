"""Donor-slab movement and reductions along the block axis.

Counterpart of ``athenak_tpu/comm.py:23-88``.  The boundary-values and
physics code asks this module to move donor slabs between blocks
(``BlockTables.gather``, whose index tables each mesh keeps on the
device), for a per-block table's rows (``BlockTables.mask``,
``local_blocks``), for all-block sums (``global_sum``) and for the whole
mesh's blocks of a module that solves on all of them (``whole_blocks``,
``own_blocks``: the self-gravity solves).  Outside any context a gather
is one ``index_select`` along the block axis and the others are
identities.  Inside ``use_comm(ShardComm(...))``
(``parallel/shard_comm.py``) the cycle runs on one rank's blocks of a
``torch.distributed`` group: the same gather becomes the per-peer packed
point-to-point exchange of the map's route (the reference's rank-packed
MPI messages, src/bvals/bvals_cc.cpp:42-255), a table gives the rank's
rows, a sum is an all-reduce, and the whole mesh's blocks are one
all-gather (the JAX package's NamedSharding gather path, where XLA
inserts it).
"""

from __future__ import annotations

from contextlib import contextmanager

import numpy as np
import torch

_CURRENT = None


def current_comm():
    """The ``ShardComm`` the running cycle uses, or None."""
    return _CURRENT


@contextmanager
def use_comm(comm):
    global _CURRENT
    prev = _CURRENT
    _CURRENT = comm
    try:
        yield comm
    finally:
        _CURRENT = prev


class BlockTables:
    """A mesh's host tables (gid maps and per-block masks, numpy) moved to
    a device once and kept there, keyed by the table and the device.  The
    entry holds the table too, so its id stays unique; the tables are the
    mesh's own and live as long as it does."""

    def __init__(self) -> None:
        self._on_device = {}

    def _get(self, tab, device, dtype):
        key = (id(tab), str(device), dtype)
        hit = self._on_device.get(key)
        if hit is None:
            arr = np.asarray(tab)
            hit = (tab, torch.as_tensor(arr, dtype=dtype, device=device),
                   arr.ndim == 1 and np.array_equal(arr, np.arange(len(arr))))
            self._on_device[key] = hit
        return hit

    def gather(self, slab, idx):
        """out[i] = slab[idx[i]] along the block axis; ``idx`` is a gid map
        (not necessarily a bijection).  The identity map returns ``slab``
        itself.  Under ``use_comm`` the current exchange moves it."""
        if _CURRENT is not None:
            return _CURRENT.gather(slab, idx)
        _, t, identity = self._get(idx, slab.device, torch.long)
        if identity and len(t) == slab.shape[0]:
            return slab
        return torch.index_select(slab, 0, t)

    def mask(self, tab, ndim: int, device):
        """A per-block boolean table as a [nmb, 1, ...] tensor of ``ndim``
        dimensions on ``device`` (the rank's rows under ``use_comm``)."""
        tab = local_blocks(tab)
        return self._get(tab, device, torch.bool)[1].reshape(
            (-1,) + (1,) * (ndim - 1))


def local_blocks(tab):
    """Per-block table [nmb_total, ...] (numpy or a tensor) -> the rows
    owned locally.  Outside ``use_comm`` the identity; inside, the rank's
    rows.  Scalars and arrays without a block axis pass through
    unchanged."""
    if _CURRENT is None or tab is None:
        return tab
    if not hasattr(tab, "ndim") or tab.ndim == 0:
        return tab
    return _CURRENT.local_rows(tab)


def local_tree(x):
    """``local_blocks`` on every table of nested lists, tuples and dicts
    (a metric's components, the cell sizes of each direction); the
    identity outside ``use_comm``."""
    if _CURRENT is None:
        return x
    if isinstance(x, dict):
        return {k: local_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(local_tree(v) for v in x)
    return local_blocks(x)


def whole_blocks(x):
    """This rank's rows -> the [nmb, ...] array of every block in gid
    order, on every rank (one all-gather under ``use_comm``); the
    identity outside it.  A module that solves on the whole
    mesh (the FFT, the multigrid) reads its source through this, so
    every rank does the same float work on the same data as one rank."""
    if _CURRENT is None:
        return x
    return _CURRENT.whole_blocks(x)


def own_blocks(x):
    """The [nmb, ...] array of every block in gid order -> this rank's
    rows; the identity outside ``use_comm``."""
    if _CURRENT is None:
        return x
    return _CURRENT.own_blocks(x)


def global_sum(x):
    """All-block reduction of a per-block partial sum: the identity on
    one rank (a torch reduction sees every block), an all-reduce SUM
    under ``use_comm`` (the reference's ``MPI_Allreduce`` in the
    turbulence normalisation, turb_driver.cpp:742)."""
    if _CURRENT is None:
        return x
    return _CURRENT.psum(x)


class LocalAttr:
    """A per-block table attribute (tensors, or lists and dicts of them)
    that a physics builds once for every block and reads as the running
    cycle's rows: set as usual, read through ``local_tree``."""

    def __set_name__(self, owner, name) -> None:
        self.key = "_all_" + name
        self.name = name

    def __get__(self, obj, cls=None):
        if obj is None:
            return self
        try:
            tab = obj.__dict__[self.key]
        except KeyError:
            raise AttributeError(self.name) from None
        return local_tree(tab)

    def __set__(self, obj, value) -> None:
        obj.__dict__[self.key] = value
