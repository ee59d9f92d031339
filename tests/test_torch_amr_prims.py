"""Prolongation in primitive variables
(``<mesh_refinement>/prolong_primitives``) through both packages, in
float64 on the CPU (``torch_deck_parity.DeckPair``: the initial and
initialised states to 1e-12, three cycles to 1e-10):

  * hydro: ``inputs/hydro/blast_smr.athinput`` at 32^2 with 8^2 blocks
    (two levels), its refined region cut to x1 > 0 so that the level
    boundary crosses the blast;
  * MHD: the 2-D Orszag-Tang vortex on two levels
    (``test_torch_refinement.py``'s ``2d`` deck).

With the option the ghosts of the mixed-level faces are prolonged from
the donors' primitives after every c2p and the conserved ghosts rebuilt
from them, so the run must differ from the one without it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from test_torch_refinement import deck, one_torch_thread  # noqa: E402,F401
from torch_deck_parity import DeckPair, check_pair, deck_text  # noqa: E402

PRIMS = ["mesh_refinement/prolong_primitives=true"]
DECKS = {
    "hydro": (deck_text("inputs/hydro/blast_smr.athinput"),
              ["mesh/nx1=32", "mesh/nx2=32", "meshblock/nx1=8",
               "meshblock/nx2=8", "refined_region1/x1min=0.0"]),
    "mhd": (deck("2d"), []),
}


@pytest.mark.parametrize("name", sorted(DECKS))
def test_prolong_primitives_matches_jax(name, tmp_path):
    text, extra = DECKS[name]
    pair = check_pair(DeckPair(text, extra + PRIMS,
                               rundir=str(tmp_path / "prims")))
    assert pair.phys.bvals.prolong_prims and pair.jax_phys.bvals.prolong_prims
    assert pair.mesh.multilevel
    # the option changes the run (the port alone, without it)
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(extra + [f"time/nlim={pair.ncyc}",
                                     f"job/basename={tmp_path}/cons"])
    _, phys, _, st = torch_main.run(pin, device="cpu")
    assert not phys.bvals.prolong_prims
    assert np.abs(st["u"].numpy() - pair.state["u"]).max() > 1e-6
