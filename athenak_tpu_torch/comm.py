"""Donor-slab movement along the block axis, single device.

Counterpart of ``athenak_tpu/comm.py:27-63`` outside any sharded region:
a gather along the block axis and the identity on per-block tables.  The
multi-device exchange (``torch.distributed``) is not ported yet.
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
