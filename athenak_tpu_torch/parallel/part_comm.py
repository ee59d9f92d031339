"""Particle migration across ranks: per-peer packed exchange.

Counterpart of ``athenak_tpu/parallel/part_comm.py`` (reference:
src/particles/bvals_part.cpp: a destination rank for every particle,
counts exchanged ahead of the variable-size MPI sends).  The particle
arrays are split over the ranks along the particle axis, each rank
holding ``L`` slots with an ``alive`` mask.  The exchange runs
``world - 1`` rounds; in round r rank d ships to rank (d + r) % world and
receives from (d - r) % world: the receiver first advertises its free
slots (the quota), the sender packs at most ``min(quota, cap)`` of the
rows bound there (one ``index_select`` a key, in slot order) and says
how many, and the receiver places them into its first free slots.  Rows
that do not fit are counted in ``overflow`` and stay alive where they
are, so a later pass can move them; nothing is lost.

The drift pusher needs no migration (its particles never read grid
data, reference: particles_pushers.cpp:19-59), so the rank-split cycle
pushes each rank's share elementwise; this is the primitive a
grid-coupled pusher calls between its half-drifts.
"""

from __future__ import annotations

import numpy as np
import torch


def gids(ppart, x):
    """The gid of the block holding each position ``x`` [n, 3] (the
    device counterpart of ``Particles.gids``; the JAX ``gids_jnp``)."""
    dev, dt = x.device, x.dtype
    xmin = torch.as_tensor(ppart._xmin, dtype=dt, device=dev)
    width = torch.as_tensor(ppart._mb_width, dtype=dt, device=dev)
    nxyz = torch.as_tensor(ppart._nmb_xyz, device=dev)
    loc = torch.floor((x - xmin) / width).to(torch.int64)
    loc = torch.minimum(torch.clamp(loc, min=0), nxyz - 1)
    lut = torch.as_tensor(np.asarray(ppart._gid_lut), device=dev)
    return lut[loc[:, 2], loc[:, 1], loc[:, 0]]


def exchange_particles(ranks, parts, alive, dest, cap=None):
    """Move particle rows to their destination ranks.

    parts  dict of this rank's [L, ...] arrays (positions, velocities)
    alive  [L] bool: the slots that hold particles
    dest   [L] int: each slot's destination rank (dead slots ignored)
    cap    rows a round may ship (default L)

    Returns (parts, alive, dest, overflow): shipped rows are retired,
    received ones placed in free slots with ``dest`` set to this rank;
    ``overflow`` counts the rows that could not be shipped (the cap or
    the receiver's free slots) and stay alive here.  Every rank of
    ``ranks`` calls it."""
    L = alive.shape[0]
    cap = int(cap or L)
    d, world = ranks.rank, ranks.world
    keys = sorted(parts)
    parts = {k: v.clone() for k, v in parts.items()}
    alive, dest = alive.clone(), dest.clone()
    dev = alive.device
    overflow = 0

    def swap(send, to, frm):
        """Send one small int64 vector to ``to``, receive one from
        ``frm``."""
        got = ranks.exchange({to: send}, {frm: tuple(send.shape)},
                             torch.int64, send.device)
        return got[frm]

    for r in range(1, world):
        peer, src = (d + r) % world, (d - r) % world
        # the count handshake: the receiver advertises its free slots
        nfree = torch.tensor([int((~alive).sum())], dtype=torch.int64,
                             device=dev)
        quota = min(int(swap(nfree, src, peer)[0]), cap)
        bound = torch.nonzero(alive & (dest == peer)).flatten()
        rows = bound[:quota]
        overflow += int(bound.numel() - rows.numel())
        n_recv = int(swap(torch.tensor([rows.numel()], dtype=torch.int64,
                                       device=dev), peer, src)[0])
        # one packed buffer of every key's rows
        flat = [parts[k].index_select(0, rows).reshape(rows.numel(), -1)
                for k in keys]
        widths = [f.shape[1] for f in flat]
        buf = torch.cat(flat, 1)
        got = ranks.exchange({peer: buf} if rows.numel() else {},
                             {src: (n_recv, sum(widths))} if n_recv else {},
                             buf.dtype, dev)
        alive[rows] = False
        if n_recv:
            slots = torch.nonzero(~alive).flatten()[:n_recv]
            off = 0
            for k, w in zip(keys, widths):
                v = parts[k]
                v[slots] = got[src][:, off:off + w].reshape(
                    (n_recv,) + tuple(v.shape[1:]))
                off += w
            dest[slots] = d
            alive[slots] = True
    return parts, alive, dest, overflow
