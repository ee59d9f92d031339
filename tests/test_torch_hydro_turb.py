"""Driven hydro turbulence through both packages.

``inputs/hydro/turb.athinput`` (PLM, HLLC, the ideal gas, driven) at
16^3 on one block and on a 2x2x2 pool of 8^3 blocks, and isothermal on
the pool, in float64: three cycles through the port's ``main.run``
against the JAX package's jitted forcing and stage
(``torch_deck_parity.DeckPair``).  The port draws from the JAX
package's own threefry stream (``athenak_tpu_torch/prng.py``,
``test_torch_turb_slice.py``), so the forcing is the same realisation.
The ``kernels`` route opens the fill kernels' gate for CPU tensors: the
single block then takes kernel B's wrapper and the pool kernel G's,
each running its plain version on the hydro state's five channels.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from athenak_tpu_torch import bvals as torch_bvals  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.ops import fill, pool_fill  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (DeckPair, assert_close,  # noqa: E402
                               check_pair, deck_text)

CUT = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
POOL = ["meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8"]
LAYOUTS = {"block": CUT, "pool": CUT + POOL,
           "pool isothermal": CUT + POOL + ["hydro/eos=isothermal",
                                            "hydro/rsolver=hlle"]}


@pytest.mark.parametrize("route", ["general", "kernels"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_turb_matches_jax(layout, route, monkeypatch, tmp_path):
    calls = []
    if route == "kernels":
        monkeypatch.setattr(torch_bvals, "kernel_dtype_ok", lambda t: True)
        for mod, name in ((fill, "periodic_fill_cc"),
                          (pool_fill, "pool_fill_cc")):
            fn = getattr(mod, name)
            monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name: (
                calls.append(_n), _f(*a))[1])
    p = check_pair(DeckPair(deck_text("inputs/hydro/turb.athinput"),
                            LAYOUTS[layout], rundir=str(tmp_path)))
    assert p.mesh.nmb_total == (1 if layout == "block" else 8)
    assert p.phys.pturb is not None and p.phys.nvar == (
        4 if "isothermal" in layout else 5)
    np.testing.assert_array_equal(p.state["turb_key"],
                                  p.jax_state["turb_key"])
    assert_close(p.state["turb_force"], p.jax_state["turb_force"], 1e-10,
                 "turb_force")
    # the forcing moved the gas and kept the net momentum at zero
    mom = p.state["u"][:, 1:4, 2:-2, 2:-2, 2:-2]
    assert np.abs(mom).max() > 1e-3
    assert np.abs(mom.sum(axis=(0, 2, 3, 4))).max() <= \
        1e-12 * np.abs(mom).sum()
    # each stage's fill (and the initial one) took the gated wrapper
    want = {"general": [],
            "kernels": ["periodic_fill_cc" if layout == "block"
                        else "pool_fill_cc"] * (2 * 3 + 2)}[route]
    assert calls == want
    assert all(k.launches == 0 for k in kernels.ALL)
