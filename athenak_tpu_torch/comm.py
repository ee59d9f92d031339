"""Donor-slab movement and reductions along the block axis, single
device.

Counterpart of ``athenak_tpu/comm.py:27-76`` outside any sharded region:
a gather along the block axis, the identity on per-block tables and on
all-block sums.  The multi-device exchange (``torch.distributed``) is not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def gather_blocks(slab, idx):
    """out[i] = slab[idx[i]] along the block axis; ``idx`` is a host gid
    map (not necessarily a bijection)."""
    idx = np.asarray(idx)
    if idx.ndim == 1 and np.array_equal(idx, np.arange(slab.shape[0])):
        return slab
    return torch.index_select(
        slab, 0, torch.as_tensor(idx, dtype=torch.long, device=slab.device))


def local_blocks(tab, pad_edge: bool = False):
    """Per-block host table -> the rows owned locally: all of them."""
    return tab


def global_sum(x):
    """All-block reduction of a partial sum: on one device the identity,
    since a torch reduction already sees every block (the JAX package
    psums it inside its shard cycle)."""
    return x
