"""Adaptive hydrodynamics through both packages, and AMR restarts.

Each deck runs through the JAX package's ``main.run`` (its driver and
AMR step) and the port's, in float64 on the CPU
(``torch_deck_parity.AmrPair``): the leaf list at every tree update, the
counts of blocks created and deleted, the state (u, w) and the time must
agree to 1e-10.

  * ``tests/test_amr.py``'s 2-D hydro blast (32^2 root of 8^2 blocks,
    three levels, ``min_max`` on the density), 6 cycles: refines and
    derefines.  The JAX package runs it twice, on its block pool (the
    deck's default) and without it: the pool's pad slots (copies of
    block 0 that evolve as isolated periodic boxes) take part in its dt
    reduction, and the two JAX runs give the same dt sequence and state
    to the last bit, so the pads do not move dt here;
  * ``tests/test_amr.py``'s 2-D linear wave at 32 x 16 (4^2 blocks, two
    levels), 5 cycles: the wave crest refines at the check of cycle 4;
  * ``inputs/hydro/blast_hydro_amr.athinput`` at a 16^3 root of 8^3
    blocks.  As shipped its ``slope`` criterion (value_max 2.0) is never
    met: the density slope of this blast peaks at 0.88 within the first
    120 cycles at the shipped 32^3 root, so the tree stays flat; the
    test runs it so for 2 cycles and with value_max 0.5, which refines.
    The JAX side runs without its block pool here (compiling the 3-D
    pool cycle takes a minute on the CPU); the port runs the deck's
    default, the mixed-level route, and the two agree to round-off, as
    the pool and no-pool JAX runs of the 2-D blast do bitwise.

A restart (``-r``) of the 2-D hydro blast at cycle 4 resumes the evolved
tree and the AMR bookkeeping, and its 6th cycle is bitwise the straight
run's (after ``tests/test_amr.py::test_amr_restart_bit_exact_continuation``)
and within 1e-10 of the JAX package's; the JAX package's own restart
file of cycle 4 (its ``tree_leaves`` and ``amr_ncyc_since_ref``) resumed
by the port ends there too.
"""

import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (AmrPair, assert_states_close,  # noqa: E402
                               deck_text)

HYDRO_DECK = """
<job>
basename = AMRBlob
<mesh>
nghost = 2
nx1 = 32
x1min = -0.5
x1max = 0.5
nx2 = 32
x2min = -0.5
x2max = 0.5
nx3 = 1
x3min = -0.5
x3max = 0.5
<meshblock>
nx1 = 8
nx2 = 8
nx3 = 1
<mesh_refinement>
refinement = adaptive
num_levels = 3
ncycle_check = 2
refinement_interval = 2
<amr_criterion1>
method = min_max
variable = hydro_u_d
value_max = 1.5
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = 6
tlim = 0.5
<hydro>
eos = ideal
reconstruct = plm
rsolver = hllc
gamma = 1.6666666666666667
<problem>
pgen_name = blast
prat = 10.0
drat = 4.0
inner_radius = 0.02
outer_radius = 0.12
pi_amb = 1.0
di_amb = 1.0
"""

LWAVE_DECK = """
<job>
basename = AMRLinWave
<mesh>
nghost = 2
nx1 = 32
x1min = 0.0
x1max = 2.0
nx2 = 16
x2min = 0.0
x2max = 1.0
nx3 = 1
x3min = 0.0
x3max = 1.0
<meshblock>
nx1 = 4
nx2 = 4
nx3 = 1
<mesh_refinement>
refinement = adaptive
num_levels = 2
ncycle_check = 4
refinement_interval = 4
<amr_criterion1>
method = min_max
variable = hydro_u_d
value_max = 1.0000004
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.4
nlim = 5
tlim = 1.0
<hydro>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.6666666666666667
<problem>
pgen_name = linear_wave
wave_flag = 0
amp = 1.0e-6
dens = 1.0
pgas = 0.6
vx0 = 0.0
"""

RST = "\n<output1>\nfile_type = rst\ndcycle = 4\n"
HYDRO_AMR = "inputs/hydro/blast_hydro_amr.athinput"
SMALL_ROOT = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
              "meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8"]


@pytest.fixture(scope="module")
def blast(tmp_path_factory):
    """The 2-D hydro blast through both packages (the JAX side on its
    block pool), and the JAX run without the pool."""
    d = tmp_path_factory.mktemp("amr_blast")
    pair = AmrPair(HYDRO_DECK + RST, jax_overrides=["job/basename=JaxBlob"],
                   rundir=str(d / "pool"))
    pair.rundir = d / "pool"
    nopool = AmrPair(HYDRO_DECK, jax_overrides=[
        "mesh_refinement/block_pool=false"], rundir=str(d / "nopool"))
    return pair, nopool


def test_hydro_blast_2d(blast):
    pair, nopool = blast
    assert pair.jax_mesh.amr_pool and not nopool.jax_mesh.amr_pool
    # the port takes the route the JAX pool takes: mixed-level from the
    # first cycle
    assert pair.mesh.amr_pool and pair.phys.multilevel
    pair.check()
    amr = pair.driver.pamr
    assert amr.nmb_created > 0 and amr.nmb_deleted > 0
    assert len(pair.trees) >= 2 and int(pair.mesh.mb_lev.max()) == 2
    # the JAX pool's pad slots do not move dt: both JAX runs agree bitwise
    assert nopool.jax_trees == pair.jax_trees
    assert nopool.jax_dts == pair.jax_dts
    assert nopool.jax_mesh.time == pair.jax_mesh.time
    np.testing.assert_array_equal(nopool.jax_state["u"],
                                  pair.jax_state["u"])
    # the zone-cycles count the blocks each cycle updated
    assert pair.driver.zone_cycles == pair.driver.nmb_updated * 64
    assert pair.driver.nmb_updated == pair.jax_driver.nmb_updated


def test_linear_wave_2d(tmp_path):
    pair = AmrPair(LWAVE_DECK, rundir=str(tmp_path)).check()
    assert pair.driver.pamr.nmb_created > 0


def test_blast_hydro_amr_deck(tmp_path):
    text = deck_text(HYDRO_AMR)
    nopool = ["mesh_refinement/block_pool=false"]
    flat = AmrPair(text, SMALL_ROOT + ["time/nlim=2"], nopool,
                   rundir=str(tmp_path / "a")).check()
    assert flat.trees == [] and flat.mesh.nmb_total == 8
    assert flat.phys.multilevel and not flat.jax_phys.multilevel
    pair = AmrPair(text, SMALL_ROOT + ["time/nlim=6",
                                       "amr_criterion1/value_max=0.5"],
                   nopool, rundir=str(tmp_path / "b")).check()
    assert pair.driver.pamr.nmb_created > 0
    assert pair.phys.rsolver == "hllc" and pair.phys.recon_method == "plm"


def test_restart_bitwise(blast, tmp_path, monkeypatch):
    """6 cycles straight against 4 + ``-r`` 2, through ``main.cli``."""
    pair, _ = blast
    deck = tmp_path / "blob.athinput"
    deck.write_text(HYDRO_DECK + RST)
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    torch_main.cli(["-i", str(deck), "-d", str(tmp_path / "half"),
                    "time/nlim=4"])
    rst = sorted(glob.glob(str(tmp_path / "half" / "AMRBlob.*.rst")))[-1]
    mesh, phys, driver, st = torch_main.cli(
        ["-r", rst, "-d", str(tmp_path / "resumed"), "time/nlim=6"])
    z = np.load(rst)
    assert "amr_ncyc_since_ref" in z and "tree_leaves" in z
    assert int(z["tree_leaves"][:, 3].max()) >= 1, "refined by cycle 4"
    assert mesh.leaves == pair.mesh.leaves
    assert mesh.time == pair.mesh.time and mesh.ncycle == 6
    got = state_to_numpy(phys.unpack_state(st))
    for k in ("u", "w"):
        np.testing.assert_array_equal(got[k], pair.state[k])
    assert_states_close(got, pair.jax_state, 1e-10)
    # the JAX package's file of cycle 4, resumed by the port
    mesh, phys, driver, st = torch_main.cli(
        ["-r", str(pair.rundir / "JaxBlob.00001.rst"), "-d",
         str(tmp_path / "from_jax"), "time/nlim=6"])
    assert np.load(pair.rundir / "JaxBlob.00001.rst")["ncycle"] == 4
    assert mesh.leaves == pair.mesh.leaves and mesh.ncycle == 6
    np.testing.assert_allclose(mesh.time, pair.jax_mesh.time, rtol=1e-10)
    assert_states_close(state_to_numpy(phys.unpack_state(st)),
                        pair.jax_state, 1e-10)
