"""The simulation state carried across packages.

The JAX package's state is a dict of arrays: ``u``, under MHD ``bfc`` (a
dict of the face arrays x1f, x2f, x3f) and, when present, ``w``, ``bcc``
and the turbulence driver's ``turb_force`` and threefry key
``turb_key`` (two uint32 words; an int64 tensor in the port,
``prng.py``).  A Z4c state holds ``u`` (and ``w``, the same array), no
``bfc``, and with puncture trackers their positions ``co_pos`` [nco, 3]
at the state's dtype.  A state whose problem generator has a
time-dependent source term carries the time ``t`` (0-d, at the state's
dtype).  A multigrid gravity run carries the last stage's potential
``phi`` [nmb, 1, n3, n2, n1], the next solve's first guess.  A shearing
box carries ``t`` (its sheared boundaries read it), a deck with
particles their positions and velocities ``prtcl_x`` and ``prtcl_v``
[np, 3], and an ion-neutral state the ions' ``ui`` and ``wi`` beside the
neutrals' ``u`` and ``w``, with the stiff residuals of its implicit
stages ``ru`` [nmb, 4, 8, n3, n2, n1].  A radiation-only state
holds its intensities in ``u`` (and ``w``, the same array), a
radiation-fluid state the fluid's entries and the intensities ``i0``
[nmb, nangles, n3, n2, n1].  A dynamical-GRMHD state holds the
temperature ``T`` [nmb, n3, n2, n1] beside ``u``, ``w``, ``bfc`` and
``bcc`` and, coupled to Z4c, the spacetime ``z`` [nmb, 22, n3, n2, n1]
(with ``co_pos`` under trackers).  These two functions move such a dict (as
numpy arrays) into the port and back, so both packages can start from
one state.
"""

from __future__ import annotations

import numpy as np
import torch

_KEYS = ("u", "w", "bcc", "turb_force", "co_pos", "t", "phi",
         "prtcl_x", "prtcl_v", "ui", "wi", "ru", "i0", "T", "z")


def _check_keys(d) -> None:
    extra = set(d) - set(_KEYS) - {"turb_key", "bfc"}
    if extra:
        raise KeyError(f"state entries the port does not carry: "
                       f"{sorted(extra)}")


def state_from_numpy(d, device, dtype):
    """numpy state dict -> tensors on ``device`` at ``dtype``; an entry
    the port does not carry raises."""
    _check_keys(d)

    def t(a):
        return torch.tensor(np.asarray(a), device=device, dtype=dtype)

    out = {k: t(d[k]) for k in _KEYS if k in d}
    if "turb_key" in d:
        out["turb_key"] = torch.tensor(
            np.asarray(d["turb_key"]).astype(np.int64), device=device)
    if "bfc" in d:
        out["bfc"] = {k: t(v) for k, v in d["bfc"].items()}
    return out


def state_to_numpy(state):
    """Tensor state dict -> numpy arrays on the host; an entry the port
    does not carry raises."""
    _check_keys(state)

    def a(x):
        return x.detach().cpu().numpy()

    out = {k: a(state[k]) for k in _KEYS if k in state}
    if "turb_key" in state:
        out["turb_key"] = a(state["turb_key"]).astype(np.uint32)
    if "bfc" in state:
        out["bfc"] = {k: a(v) for k, v in state["bfc"].items()}
    return out
