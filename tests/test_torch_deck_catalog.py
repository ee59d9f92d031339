"""Every deck under ``inputs/`` validates through the port's ``-v``: the
mesh, the physics, the problem generator's initial state, the outputs
(whose constructors make their directories, so each deck runs under
``-d tmp_path``) and no unused parameter (the JAX package's
``tests/test_deck_catalog.py`` through ``main.cli``), on the CPU.

Cut in size by command-line overrides, each cut listed in ``CUTS``:

  * ``tests/gr_monopole`` (256 x 256 x 128 in two blocks, nghost 3): the
    generator's GR initial state over 8.4 M cells takes some 28 s, so it
    is cut to 64 x 64 x 32 in two blocks;
  * ``radiation/snake`` (the tetrad geometry of every cell and angle):
    cut to 32 x 64 in blocks of 32 x 32 (7.5 s as shipped).
"""

import glob
import os

import pytest

torch = pytest.importorskip("torch")

from athenak_tpu_torch import main as torch_main  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401

ROOT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "inputs")
DECKS = sorted(glob.glob(os.path.join(ROOT, "**", "*.athinput"),
                         recursive=True))
CUTS = {
    "tests/gr_monopole.athinput": [
        "mesh/nx1=64", "mesh/nx2=64", "mesh/nx3=32", "meshblock/nx1=32",
        "meshblock/nx2=64", "meshblock/nx3=32"],
    "radiation/snake.athinput": [
        "mesh/nx1=32", "mesh/nx2=64", "meshblock/nx1=32",
        "meshblock/nx2=32"],
}


def test_catalog_has_every_deck():
    assert len(DECKS) == 75
    assert set(CUTS) <= {os.path.relpath(d, ROOT) for d in DECKS}


@pytest.mark.parametrize(
    "deck", DECKS, ids=[os.path.relpath(d, ROOT) for d in DECKS])
def test_deck_validates(deck, tmp_path, monkeypatch, capsys,
                        one_torch_thread):
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    cut = CUTS.get(os.path.relpath(deck, ROOT), [])
    assert torch_main.cli(["-i", deck, "-d", str(tmp_path / "run"), "-v",
                           *cut]) is None
    assert "validation complete" in capsys.readouterr().out
