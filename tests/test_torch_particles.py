"""Test particles of the port (``athenak_tpu_torch/particles.py``: the
initial draw, the drift push, the owner gids, ``new_dt``) and the ``trk``
output against the JAX package, on the CPU.

  * The draw: ``particles.uniform`` bit-equal to ``jax.random.uniform``
    in float32 and float64, and the initial positions and velocities
    bit-equal to the JAX package's, float64 with x64 on and float32 with
    it off (the JAX package's default on the TPU).
  * Three cycles (float64) of ``inputs/particles/random_drift`` at 16^3
    and of ``tests/test_particles.py``'s statically refined deck (15
    blocks, two levels) through both packages' whole cycles: ``prtcl_x``
    and ``prtcl_v`` to 0 ulp, the ``trk`` files byte-equal, the owner
    gids equal (the containing leaf on the refined mesh), the fluid and
    the time to 1e-10; the root-grid table of ``tests/test_particles.py``'s
    eight-block deck on random positions.
  * A ``-r`` restart of ``random_drift`` bitwise against a straight run,
    and the MHD blast with particles (the v1 route's physics) drifting
    exactly.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu.particles import Particles as JaxParticles  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch import prng  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.mesh import Mesh  # noqa: E402
from athenak_tpu_torch.particles import Particles, uniform  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_cycle_parity import CyclePair, read_bytes  # noqa: E402
from torch_deck_parity import deck_text, port_run  # noqa: E402

DRIFT = "inputs/particles/random_drift.athinput"
DRIFT_CUT = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
             "output1/dt=0.02"]


def _test_decks():
    from test_particles import DECK, SMR_DECK
    return DECK, SMR_DECK


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(7, 3), (1000, 3), (5,)])
def test_uniform_is_jax_uniform(dtype, shape):
    key = jax.random.PRNGKey(3)
    for k in range(2):
        kj = jax.random.split(key)[k]
        kt = prng.split(prng.prng_key(3))[k]
        want = np.asarray(jax.random.uniform(kj, shape,
                                             dtype=getattr(jnp, dtype)))
        got = uniform(kt, shape, getattr(torch, dtype)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _pins(text, extra=()):
    pj, pt = JaxInput.from_string(text), ParameterInput.from_string(text)
    pj.modify_from_cmdline(list(extra))
    pt.modify_from_cmdline(list(extra))
    return pj, pt


@pytest.mark.parametrize("prec", ["double", "single"])
def test_initial_particles_bit_equal(prec):
    """The initial draw in the deck's precision against the JAX
    package's at its matching x64 setting (on for float64, off for
    float32)."""
    pj, pt = _pins(deck_text(DRIFT), DRIFT_CUT)
    dt = torch.float64 if prec == "double" else torch.float32
    mine = Particles(pt, Mesh(pt), "cpu", dt).init_state_entries(dt)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", prec == "double")
    try:
        jp = JaxParticles(pj, JaxMesh(pj))
        ref = jp.init_state_entries(jnp.float64 if prec == "double"
                                    else jnp.float32)
        ref = {k: np.asarray(v) for k, v in ref.items()}
    finally:
        jax.config.update("jax_enable_x64", x64)
    assert mine["prtcl_x"].shape == (int(0.1 * 16 ** 3), 3)
    for k in ("prtcl_x", "prtcl_v"):
        got = mine[k].numpy()
        assert got.dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got, ref[k])


@pytest.fixture(scope="module")
def drift_pairs(tmp_path_factory):
    deck, smr = _test_decks()
    cases = {"random_drift": (deck_text(DRIFT), DRIFT_CUT),
             "smr": (smr, ["output1/dt=0.02"])}
    return {name: CyclePair(text, cut, outputs=True,
                            rundir=str(tmp_path_factory.mktemp(name)))
            for name, (text, cut) in cases.items()}


@pytest.mark.parametrize("name", ["random_drift", "smr"])
def test_particle_deck_three_cycles(drift_pairs, name):
    pair = drift_pairs[name]
    pair.check()
    for k in ("prtcl_x", "prtcl_v"):
        np.testing.assert_array_equal(pair.state[k], pair.jax_state[k])
    x0, v0 = pair.port_init["prtcl_x"], pair.port_init["prtcl_v"]
    assert np.abs(pair.state["prtcl_x"] - x0).max() > 0.01
    np.testing.assert_array_equal(pair.state["prtcl_v"], v0)
    # the owner gids, from the final positions
    gt = pair.phys.ppart.gids(torch.as_tensor(pair.state["prtcl_x"]))
    gj = pair.jax_phys.ppart.gids(pair.jax_state["prtcl_x"])
    np.testing.assert_array_equal(gt, gj)
    assert pair.phys.ppart.new_dt() == pair.jax_phys.ppart.new_dt()


@pytest.mark.parametrize("name", ["random_drift", "smr"])
def test_trk_file_byte_equal(drift_pairs, name):
    pair = drift_pairs[name]
    files = [f for f in os.listdir(pair.port_dir) if f.endswith(".trk")]
    assert len(files) == 1
    mine = read_bytes(os.path.join(pair.port_dir, files[0]))
    ref = read_bytes(os.path.join(pair.jax_dir, files[0]))
    assert mine == ref
    assert mine.count(b"\n") > 1 + 2 * 10


def test_gids_on_a_block_grid():
    """The root-grid table of ``tests/test_particles.py``'s deck (16^3
    in eight blocks) on random positions, the box's faces among them:
    the port's gids equal the JAX package's."""
    deck, _ = _test_decks()
    pj, pt = _pins(deck)
    jp = JaxParticles(pj, JaxMesh(pj))
    tp = Particles(pt, Mesh(pt), "cpu", torch.float64)
    rng = np.random.default_rng(4)
    x = rng.uniform(-0.5, 0.5, size=(2000, 3))
    x[:6] = [[-0.5, 0.0, 0.5], [0.5, 0.5, 0.5], [0.0, 0.0, 0.0],
             [-0.5, -0.5, -0.5], [0.25, -0.25, 0.0], [0.0, 0.5, -0.5]]
    got = tp.gids(torch.as_tensor(x))
    np.testing.assert_array_equal(got, jp.gids(x))
    assert set(got.tolist()) == set(range(8))


def test_smr_gids_are_containing_leaves(drift_pairs):
    pair = drift_pairs["smr"]
    assert pair.mesh.multilevel and pair.mesh.nmb_total == 15
    x = pair.state["prtcl_x"]
    g = pair.phys.ppart.gids(x)
    sz = pair.mesh.mb_size
    for d, (lo, hi) in enumerate((("x1min", "x1max"), ("x2min", "x2max"),
                                  ("x3min", "x3max"))):
        assert (x[:, d] >= sz[lo][g]).all() and (x[:, d] <= sz[hi][g]).all()


def test_random_drift_restart_is_bitwise(tmp_path, monkeypatch):
    """random_drift at 16^3: four cycles straight against two, a
    ``.rst`` (with the particles), then ``-r`` and two more; u and the
    particles bitwise equal."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    deck = tmp_path / "drift.athinput"
    deck.write_text(deck_text(DRIFT)
                    + "\n<output9>\nfile_type = rst\ndcycle = 2\n")
    common = DRIFT_CUT
    cwd = os.getcwd()
    try:
        _, _, _, s1 = torch_main.cli(["-i", str(deck), "-d",
                                      str(tmp_path / "straight"), *common,
                                      "time/nlim=4"])
        os.chdir(cwd)
        torch_main.cli(["-i", str(deck), "-d", str(tmp_path / "first"),
                        *common, "time/nlim=2"])
        os.chdir(cwd)
        rst = str(tmp_path / "first" / "random_drift.00001.rst")
        m2, _, _, s2 = torch_main.cli(["-r", rst, "-d",
                                       str(tmp_path / "first"),
                                       "time/nlim=4"])
    finally:
        os.chdir(cwd)
    assert m2.ncycle == 4
    for k in ("u", "prtcl_x", "prtcl_v"):
        assert torch.equal(s1[k], s2[k]), k


def test_mhd_blast_with_particles(tmp_path):
    """The MHD blast with random_drift's particles (kernel A's physics;
    the particles close A and leave E + F) at 16^3 in float64 on the
    CPU: the drift is x0 + v t wrapped into the box."""
    from test_torch_shearing_box import PARTICLES
    text = deck_text("inputs/mhd/blast.athinput") + PARTICLES
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
                             "job/precision=double", "output1/dt=100"])
    _, phys, _, _, st0 = torch_main.build(pin, device="cpu")
    x0 = st0["prtcl_x"].numpy().copy()
    v0 = st0["prtcl_v"].numpy().copy()
    mesh, phys, _, st = port_run(text, ["mesh/nx1=16", "mesh/nx2=16",
                                        "mesh/nx3=16", "job/precision=double",
                                        "output1/dt=100"],
                                 ncyc=3, rundir=str(tmp_path))
    assert phys.use_mega_stage and not phys.use_mega_v2
    want = -1.0 + np.mod(x0 + v0 * mesh.time + 1.0, 2.0)   # x in [-1, 1]
    np.testing.assert_allclose(st["prtcl_x"], want, rtol=0, atol=1e-12)
    assert np.isfinite(st["u"]).all()
