"""Problem generators: initial conditions for a deck.

Counterpart of ``athenak_tpu/pgen/__init__.py`` (reference:
src/pgen/pgen.hpp:27-93).  Each generator is a module with

    init(pin, mesh, phys) -> state      # tensors on phys.device

selected by <problem>/pgen_name.  The blast wave, the Orszag-Tang vortex
and driven turbulence (MHD) and the Z4c single puncture are ported so
far.
"""

from __future__ import annotations

from importlib import import_module

import numpy as np
import torch

_REGISTRY = {
    "blast": "athenak_tpu_torch.pgen.blast",
    "orszag_tang": "athenak_tpu_torch.pgen.orszag_tang",
    "turb": "athenak_tpu_torch.pgen.turb",
    "z4c_one_puncture": "athenak_tpu_torch.pgen.z4c_one_puncture",
}


def get_pgen(name: str):
    if name not in _REGISTRY:
        raise NotImplementedError(
            f"problem/pgen_name = '{name}' is not ported to "
            f"athenak_tpu_torch yet (ported: {sorted(_REGISTRY)})")
    return import_module(_REGISTRY[name])


def state_from_prims(phys, w, bfc):
    """Build the initial state from host primitive arrays: move (w, bfc)
    to the device at the run's dtype, then bcc and prim -> cons there."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=phys.dtype,
                               device=phys.device)

    wt = dev(w)
    bfct = {k: dev(v) for k, v in bfc.items()}
    bcc = phys.compute_bcc(bfct)
    return phys.make_state(phys.prim_to_cons(wt, bcc), wt, bfct, bcc=bcc)
