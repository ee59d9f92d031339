"""The Newtonian hydro slice through both packages.

Each deck of ``inputs/hydro/`` that the slice ports runs three cycles
through the port's ``main.run`` and through the JAX package's jitted
stage (``torch_deck_parity.DeckPair``), in float64 on the CPU: the
problem generator's state and the initialised state to 1e-12, the state
after the cycles (u, w, on the interior) and the time to 1e-10 of each
field's scale.  The 3-D decks are cut to 16^3, the 2-D ones to 32^2;
``blast_smr`` keeps its two levels at 32^2 with 8^2 blocks.  The linear
wave's error file at the end of the run is the JAX package's; the Sod
deck's ``tab`` dump is the JAX writer's text.  Nothing launches a
CUDA kernel.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from athenak_tpu_torch import kernels  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import DeckPair, check_pair, deck_text  # noqa: E402

CUT3 = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
DECKS = {
    "sod": ("inputs/hydro/sod.athinput", []),
    "shu_osher": ("inputs/hydro/shu_osher.athinput", ["mesh/nx1=128"]),
    "kh2d-lecoanet": ("inputs/hydro/kh2d-lecoanet.athinput",
                      ["mesh/nx1=32", "mesh/nx2=32"]),
    "kh2d-sin": ("inputs/hydro/kh2d-sin.athinput",
                 ["mesh/nx1=32", "mesh/nx2=16"]),
    "blast_hydro": ("inputs/hydro/blast_hydro.athinput", CUT3),
    "blast_smr": ("inputs/hydro/blast_smr.athinput",
                  ["mesh/nx1=32", "mesh/nx2=32", "meshblock/nx1=8",
                   "meshblock/nx2=8"]),
    "linear_wave_hydro": ("inputs/tests/linear_wave_hydro.athinput",
                          ["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8"]),
}
NG = {"shu_osher": 3, "kh2d-lecoanet": 3, "blast_hydro": 3}

_PAIRS = {}


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    return tmp_path_factory.mktemp("hydro_slice")


def pair(name, rundir):
    if name not in _PAIRS:
        path, extra = DECKS[name]
        _PAIRS[name] = DeckPair(deck_text(path), extra,
                                rundir=str(rundir / name))
    return _PAIRS[name]


@pytest.mark.parametrize("name", sorted(DECKS))
def test_deck_matches_jax(name, rundir):
    p = check_pair(pair(name, rundir), ng=NG.get(name, 2))
    assert not p.phys.is_mhd and p.phys.nvar == 5
    assert p.mesh.multilevel == (name == "blast_smr")
    # the flow moved and nothing launched a CUDA kernel
    assert np.abs(p.state["u"] - p.port_ready["u"]).max() > 0.0
    assert all(k.launches == 0 for k in kernels.ALL)


def test_linear_wave_error_file(rundir, tmp_path):
    """The ``-errs.dat`` row the port's ``final`` writes and the one the
    JAX package's ``final`` writes from its own state: the same header,
    sizes and cycle count, each error to its printed precision."""
    p = pair("linear_wave_hydro", rundir)
    p.jax_final(str(tmp_path))
    got = (rundir / "linear_wave_hydro" / "linear_wave_hydro-errs.dat")
    ref = tmp_path / "linear_wave_hydro-errs.dat"
    g, r = got.read_text().splitlines(), ref.read_text().splitlines()
    assert len(g) == len(r) == 2 and g[0] == r[0]
    gt, rt = g[1].split(), r[1].split()
    assert gt[:4] == rt[:4] == ["0016", "0008", "0008", "00003"]
    np.testing.assert_allclose([float(x) for x in gt[4:]],
                               [float(x) for x in rt[4:]], rtol=2e-6)
    # tlim is read in wave periods, as in the JAX package
    assert p.port_pin.get_real("time", "tlim") == \
        p.jax_pin.get_real("time", "tlim")


def test_sod_tab_matches_jax_writer(rundir, tmp_path):
    """The Sod deck's ``tab`` dump of the final state: the JAX package's
    TabularOutput, given the port's state, writes the same text."""
    from athenak_tpu.outputs import TabularOutput as JaxTab
    p = pair("sod", rundir)
    files = sorted(os.listdir(rundir / "sod"))
    tabs = [f for f in files if f.endswith(".tab")]
    assert tabs[0] == "Sod.hydro_w.00000.tab" and len(tabs) == 2
    out = JaxTab(p.jax_pin, p.jax_mesh, p.jax_phys, "output1")
    out.params.file_number = len(tabs) - 1
    p.jax_mesh.time, p.jax_mesh.ncycle = p.mesh.time, p.mesh.ncycle
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        out.write(p.jax_mesh, p.state["u"], p.state["w"])
    finally:
        os.chdir(cwd)
    assert (tmp_path / tabs[-1]).read_text() == \
        (rundir / "sod" / tabs[-1]).read_text()


def test_hydro_use_kernels_switch():
    """``hydro/use_kernels`` clears the fill kernels' flags, as
    ``mhd/use_kernels`` does; the deck's mesh sets them."""
    from athenak_tpu_torch import main as torch_main
    from athenak_tpu_torch.athinput import ParameterInput
    text = deck_text("inputs/hydro/turb.athinput")
    for extra, fill, pool in (
            (CUT3, True, False),
            (CUT3 + ["meshblock/nx1=8", "meshblock/nx2=8",
                     "meshblock/nx3=8"], False, True),
            (CUT3 + ["hydro/use_kernels=false"], False, False),
            (CUT3 + ["meshblock/nx1=8", "hydro/use_kernels=false"],
             False, False)):
        pin = ParameterInput.from_string(text)
        pin.modify_from_cmdline(extra)
        _, phys, _, _, _ = torch_main.build(pin, device="cpu")
        assert phys.bvals.use_fill_kernel == fill, extra
        assert phys.bvals.use_pool_fill == pool, extra
