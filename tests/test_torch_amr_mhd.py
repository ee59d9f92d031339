"""Adaptive MHD through both packages, in float64 on the CPU.

  * ``tests/test_amr.py``'s 3-D div(B) deck (the MHD blast with an
    oblique field at a 16^3 root of 8^3 blocks, two levels), 6 cycles:
    refines and derefines;
  * ``inputs/mhd/blast_amr.athinput`` at a 16^3 root of 8^3 blocks, two
    levels, with ``value_max`` 1.05 (at this root the blast spans a cell
    and the shipped 1.5 is not reached within the run).

Both decks put the blast at rest on the corner of eight blocks, where
the mass flux through the symmetry planes is zero up to rounding and the
corner EMFs' upwind selects follow the sign of that noise, which differs
between torch's CPU square root and XLA's (ROADMAP F4,
``test_torch_smr_slice.py``).  Their domains are shifted by 0.3 of a
root cell: the quarter cell of the SMR tests puts the blast's centre on
a cell centre of the fine level, and once every block has refined the
two packages part there by 2.6e-10 of the face field in 8 cycles.

For each (``torch_deck_parity.AmrPair``): the leaf list at every tree
update, the counts of blocks created and deleted, u, w and the face
field and the time within 1e-10; div(B) at round-off on every block of
the final tree in both packages.  The JAX side runs without its block
pool (its 3-D pool cycle takes a minute to compile on the CPU); the
port runs the deck's default route, which is the pool's (mixed-level
from the first cycle), and ``test_torch_amr_slice.py`` shows the JAX
pool and no-pool runs bitwise equal on the 2-D blast.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import AmrPair, deck_text  # noqa: E402

DIVB_DECK = """
<job>
basename = AMRDivB3
<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = 16
x3min = -0.5
x3max = 0.5
<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8
<mesh_refinement>
refinement = adaptive
num_levels = 2
ncycle_check = 2
refinement_interval = 2
<amr_criterion1>
method = min_max
variable = mhd_u_d
value_max = 1.5
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 6
tlim = 0.5
<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
gamma = 1.6666666666666667
<problem>
pgen_name = blast
prat = 10.0
drat = 4.0
inner_radius = 0.02
outer_radius = 0.12
pi_amb = 1.0
di_amb = 1.0
b_amb = 0.7071067811865476
"""

NOPOOL = ["mesh_refinement/block_pool=false"]


def shift(lo, hi, cell):
    """The domain [lo, hi]^3 moved by 0.3 of ``cell``."""
    q = 0.3 * cell
    return [f"mesh/x{d}{e}={v + q}" for d in (1, 2, 3)
            for e, v in (("min", lo), ("max", hi))]


BLAST_AMR = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
             "meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8",
             "mesh_refinement/num_levels=2", "job/precision=double",
             "amr_criterion1/value_max=1.05",
             "time/nlim=6"] + shift(-1.0, 1.0, 2.0 / 16)


def max_divb(mesh, state):
    """max |div B| * dx over the interiors (per block, on its level)."""
    mbi = mesh.mb_indcs
    b = {k: np.asarray(v, dtype=np.float64) for k, v in state["bfc"].items()}
    dx = [np.asarray(mesh.mb_size[f"dx{d}"]).reshape(-1, 1, 1, 1)
          for d in (1, 2, 3)]
    div = ((b["x1f"][..., 1:] - b["x1f"][..., :-1]) / dx[0]
           + (b["x2f"][..., 1:, :] - b["x2f"][..., :-1, :]) / dx[1]
           + (b["x3f"][:, 1:] - b["x3f"][:, :-1]) / dx[2]) * dx[0]
    a = (slice(None), slice(mbi.ks, mbi.ke + 1),
         slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    return float(np.abs(div[a]).max())


def _check(pair):
    pair.check()
    bmax = max(float(np.abs(v).max()) for v in pair.state["bfc"].values())
    assert max_divb(pair.mesh, pair.state) <= 1e-13 * bmax
    assert max_divb(pair.jax_mesh, pair.jax_state) <= 1e-13 * bmax
    assert pair.mesh.amr_pool and pair.phys.multilevel
    assert not pair.jax_mesh.amr_pool
    return pair


def test_divb_deck_3d(tmp_path):
    pair = _check(AmrPair(DIVB_DECK, shift(-0.5, 0.5, 1.0 / 16), NOPOOL,
                          rundir=str(tmp_path)))
    amr = pair.driver.pamr
    assert amr.nmb_created > 0 and amr.nmb_deleted > 0
    assert pair.phys.rsolver == "hlld"


def test_blast_amr_deck(tmp_path):
    pair = _check(AmrPair(deck_text("inputs/mhd/blast_amr.athinput"),
                          BLAST_AMR, NOPOOL, rundir=str(tmp_path)))
    assert pair.driver.pamr.nmb_created > 0
    assert int(pair.mesh.mb_lev.max()) == 1
