"""``-p``: the run traced by ``torch.profiler`` (``main.profiled``).

On the CPU the trace holds the host's activity: ``main.cli -p DIR`` on
the 3-D blast at 8^3 writes one ``*.pt.trace.json`` into DIR (under the
run directory of ``-d``, as the JAX package's ``-p`` writes its trace),
which parses as JSON and names the torch operators of the stage; ``-p``
with ``-r`` traces the resumed run; without ``-p`` nothing is traced.
The trace a rank under two gloo ranks is held by
``tests/test_torch_shard.py::test_profile_writes_a_trace_a_rank``.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from athenak_tpu_torch import main as torch_main  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import ROOT  # noqa: E402

BLAST = os.path.join(ROOT, "inputs", "mhd", "blast.athinput")
SMALL = ["job/precision=double", "mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8",
         "time/nlim=2", "output1/file_type=rst", "output1/dcycle=1"]


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _cli(tmp_path, monkeypatch, args):
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    return torch_main.cli(args)


def test_p_writes_one_json_trace(tmp_path, monkeypatch, one_torch_thread):
    mesh, _, _, _ = _cli(tmp_path, monkeypatch,
                         ["-i", BLAST, "-d", "run", "-p", "prof", *SMALL])
    assert mesh.ncycle == 2
    prof = tmp_path / "run" / "prof"
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    assert os.path.getsize(prof / traces[0]) > 0
    names = {e.get("name", "") for e in _events(prof / traces[0])}
    # the torch operators of the run's stages and fills
    assert any(n.startswith("aten::") for n in names)
    assert "aten::roll" in names or "aten::index_select" in names


def test_p_with_a_restart(tmp_path, monkeypatch, one_torch_thread):
    _cli(tmp_path, monkeypatch, ["-i", BLAST, "-d", "a", *SMALL])
    os.chdir(tmp_path)
    mesh, _, _, _ = torch_main.cli(["-r", "a/Blast.00001.rst", "-d", "b",
                                    "-p", "prof", "time/nlim=3"])
    assert mesh.ncycle == 3
    traces = os.listdir(tmp_path / "b" / "prof")
    assert len(traces) == 1 and _events(tmp_path / "b" / "prof"
                                        / traces[0])


def test_no_p_no_trace(tmp_path, monkeypatch, one_torch_thread):
    _cli(tmp_path, monkeypatch, ["-i", BLAST, "-d", "run", *SMALL])
    assert not os.path.exists(tmp_path / "run" / "prof")
    with torch_main.profiled(None) as ctx:
        assert ctx is None
