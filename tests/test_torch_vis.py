"""The port's post-processing tools (``athenak_tpu_torch/vis``).

The port writes ``bin``, ``cbin``, ``hst``, ``tab`` and ``vtk`` files of
the 3-D blast at 8^3 (two blocks) and of Sod's shock tube; the port's
``read_binary``, ``read_hst``, ``read_tab`` and ``read_vtk`` read each
exactly as the JAX package's readers do (every key, every array
bitwise).  ``convert`` writes an ``.athdf`` whose arrays are the dump's
and an ``.xdmf`` naming it (skipped without ``h5py``); ``plot`` draws a
slice of a dump and a history column into PNG files, as the JAX
package's does (skipped without ``matplotlib``).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from athenak_tpu.vis import readers as jax_readers  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.vis import readers  # noqa: E402
from torch_deck_parity import ROOT  # noqa: E402

BLAST = os.path.join(ROOT, "inputs", "mhd", "blast.athinput")
SOD = os.path.join(ROOT, "inputs", "hydro", "sod.athinput")
BLAST_OUT = ["job/precision=double", "mesh/nx1=8", "mesh/nx2=8",
             "mesh/nx3=8", "meshblock/nx1=8", "meshblock/nx2=8",
             "meshblock/nx3=4", "time/nlim=2", "output1/dcycle=1",
             "output2/file_type=hst", "output2/dcycle=1",
             "output3/file_type=vtk", "output3/variable=mhd_w_bcc",
             "output3/dcycle=2", "output4/file_type=cbin",
             "output4/variable=mhd_u", "output4/dcycle=2",
             "output5/file_type=tab", "output5/variable=mhd_w",
             "output5/dcycle=2", "output5/slice_x3=0.3"]


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    base = tmp_path_factory.mktemp("vis")
    cwd = os.getcwd()
    try:
        with one_thread():
            os.chdir(base)
            torch_main.run(torch_main.read_deck(BLAST, BLAST_OUT),
                           device="cpu")
            os.makedirs("sod")
            os.chdir("sod")
            torch_main.run(torch_main.read_deck(SOD, ["time/nlim=3"]),
                           device="cpu")
    finally:
        os.chdir(cwd)
    return base


class one_thread:
    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def _files(root, suffix):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.join(d, f) for f in fs if f.endswith(suffix)]
    return sorted(out)


def _same(a, b, label):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), label
        for k in b:
            _same(a[k], b[k], f"{label}/{k}")
    elif isinstance(b, tuple):
        assert len(a) == len(b), label
        for x, y in zip(a, b):
            _same(x, y, label)
    elif isinstance(b, np.ndarray):
        assert a.dtype == b.dtype, label
        np.testing.assert_array_equal(a, b, err_msg=label)
    else:
        assert a == b, label


@pytest.mark.parametrize("kind,reader", [
    (".bin", "read_binary"), (".cbin", "read_binary"),
    (".hst", "read_hst"), (".tab", "read_tab"), (".vtk", "read_vtk")])
def test_readers_read_as_jax(rundir, kind, reader):
    files = _files(rundir, kind)
    assert files, kind
    for f in files:
        _same(getattr(readers, reader)(f), getattr(jax_readers, reader)(f),
              os.path.basename(f))


def test_binary_reader_sees_the_dump(rundir):
    """The dump's header, blocks and cells as the port wrote them."""
    f = readers.read_binary(_files(rundir, ".bin")[-1])
    assert f["var_names"] == ["dens", "velx", "vely", "velz", "eint",
                              "bcc1", "bcc2", "bcc3"]
    assert f["n_mbs"] == 2 and f["cycle"] == 2
    assert f["mb_data"]["dens"].shape == (2, 4, 8, 8)
    assert np.isfinite(f["mb_data"]["eint"]).all()


def test_convert_writes_athdf(rundir, tmp_path):
    h5py = pytest.importorskip("h5py")
    from athenak_tpu_torch.vis import convert
    src = _files(rundir, ".bin")[-1]
    dst = tmp_path / os.path.basename(src)
    dst.write_bytes(open(src, "rb").read())
    athdf = convert.convert(str(dst))
    f = readers.read_binary(str(dst))
    with h5py.File(athdf, "r") as h:
        assert h.attrs["NumMeshBlocks"] == f["n_mbs"]
    assert os.path.basename(athdf) in open(athdf + ".xdmf").read()


def test_plot_draws_pngs(rundir, tmp_path):
    pytest.importorskip("matplotlib")
    from athenak_tpu_torch.vis import plot
    png = plot.plot_slice(_files(rundir, ".bin")[-1], "dens",
                          str(tmp_path / "slice.png"), dim="x3",
                          coord=0.1)
    hst = plot.plot_hst(_files(rundir, ".hst")[0], "mass",
                        str(tmp_path / "mass.png"))
    for p in (png, hst):
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
