"""Do the JAX block pool's pad slots move dt?  (Not a test file.)

The JAX package runs an adaptive deck on a fixed-capacity block pool by
default (``athenak_tpu/amr_pool.py``): the slots past the last block
clone block 0 and evolve as isolated periodic boxes, and they take part
in the pooled dt reduction.  The port has no pads.  This script runs the
JAX package's ``main.run`` on each deck twice, with
``mesh_refinement/block_pool`` true and false (XLA at backend
optimisation level 0, in float64 on the CPU), and prints whether the
trees, the dt of every cycle and the final u are bitwise equal:

  * ``mhd3d``: ``inputs/mhd/blast_amr.athinput`` as
    ``tests/test_torch_amr_mhd.py`` cuts it (16^3 root of 8^3 blocks,
    two levels, the domain shifted by 0.3 of a root cell);
  * ``mhd2d``: ``tests/test_amr.py``'s 2-D MHD blast, 8 cycles.

The 2-D hydro blast is held so in ``tests/test_torch_amr_slice.py``; the
3-D pool cycle takes minutes to compile on the CPU, so that comparison
lives here.  Run from the repository root:

    python tests/jax_pool_dt.py [mhd3d] [mhd2d]
"""

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import test_amr  # noqa: E402
import test_torch_amr_mhd as amr_mhd  # noqa: E402
import torch_deck_parity as tdp  # noqa: E402
from athenak_tpu import amr as jax_amr  # noqa: E402
from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput  # noqa: E402

DECKS = {
    "mhd3d": (tdp.deck_text("inputs/mhd/blast_amr.athinput"),
              amr_mhd.BLAST_AMR),
    "mhd2d": (test_amr.MHD_DECK, ["time/nlim=8"]),
}


def run(text, overrides, pool):
    """(trees, dts, final u, seconds) of one JAX run."""
    trees, dts = [], []
    with pytest.MonkeyPatch.context() as mp, \
            tempfile.TemporaryDirectory() as tmp:
        mp.setattr(jax_amr.AMR, "step",
                   tdp._recording(jax_amr.AMR.step, trees, dts))
        mp.setattr(jax, "jit", tdp._jit_o0(jax.jit))
        pin = ParameterInput.from_string(text)
        pin.modify_from_cmdline(
            tdp.JAX_EXTRA + list(overrides)
            + [f"mesh_refinement/block_pool={str(pool).lower()}"])
        mp.chdir(tmp)
        t0 = time.perf_counter()
        mesh, _, _, state = jax_main.run(pin)
        assert mesh.amr_pool == pool
        return trees, dts, np.asarray(state["u"]), time.perf_counter() - t0


def main(names) -> int:
    same = True
    for name in names or sorted(DECKS):
        text, overrides = DECKS[name]
        (t1, d1, u1, s1), (t0, d0, u0, s0) = (run(text, overrides, p)
                                              for p in (True, False))
        eq = {"trees": t1 == t0, "dts": d1 == d0,
              "u": u1.shape == u0.shape and np.array_equal(u1, u0)}
        same &= all(eq.values())
        print(f"{name}: pool vs no pool bitwise {eq}; "
              f"{len(d1)} cycles, trees at cycles {[c for c, _ in t1]}; "
              f"{s1:.1f} s with the pool, {s0:.1f} s without")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
