"""Donor-slab movement and reductions along the block axis, single
device.

Counterpart of ``athenak_tpu/comm.py:27-76`` outside any sharded region:
a gather along the block axis (``BlockTables.gather``, whose index tables
each mesh keeps on the device), the identity on per-block tables and on
all-block sums.  The multi-device exchange (``torch.distributed``) is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


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
        itself."""
        _, t, identity = self._get(idx, slab.device, torch.long)
        if identity and len(t) == slab.shape[0]:
            return slab
        return torch.index_select(slab, 0, t)

    def mask(self, tab, ndim: int, device):
        """A per-block boolean table as a [nmb, 1, ...] tensor of ``ndim``
        dimensions on ``device``."""
        return self._get(tab, device, torch.bool)[1].reshape(
            (-1,) + (1,) * (ndim - 1))


def local_blocks(tab, pad_edge: bool = False):
    """Per-block host table -> the rows owned locally: all of them."""
    return tab


def global_sum(x):
    """All-block reduction of a partial sum: on one device the identity,
    since a torch reduction already sees every block (the JAX package
    psums it inside its shard cycle)."""
    return x
