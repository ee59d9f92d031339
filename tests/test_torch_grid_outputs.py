"""The ``cbin``, ``pdf``, ``cartgrid``, ``sphsurf`` and ``log`` outputs
against the JAX package's, on the CPU in float64.

  (i) Writer parity: both packages' writers, built from the same
      parameters, are handed the same state (the port's after three
      cycles, as numpy and then JAX arrays) and write byte-equal files:
      ``cbin`` with and without moments on the 3-D blast (two blocks) and
      the 2-D Orszag-Tang deck; ``pdf`` log and linear, volume- and
      mass-weighted, and joint; ``cartgrid`` uniform and Chebyshev, also
      on a two-level 3-D blast; ``sphsurf`` on one radius and on linear
      and log ladders, also on the two-level blast; ``log``.
 (ii) End to end: the 3-D blast (16^3 in two blocks, moved by a quarter
      of a root cell, ROADMAP F4) with every one of these outputs for
      three cycles through both CLIs: the same files, their headers
      byte-equal (but for a binary preheader's time, whose 17th digit
      carries the dt chain's round-off: 1e-12), float64 payloads within
      1e-10 of their scale and float32 payloads within one float32 ulp
      (or 1e-10 of the scale where the value is round-off).  Both command lines name
      each package's stage gate (``mhd/use_pallas``, ``mhd/use_kernels``)
      so that the parameter dumps the headers carry are the same.
"""

import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu import outputs as jax_outputs  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch import outputs as torch_outputs  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from athenak_tpu_torch.vis.readers import read_binary  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import JAX_EXTRA, deck_text  # noqa: E402

BLAST3 = ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16",
          "mesh/nx3=16", "meshblock/nx1=16", "meshblock/nx2=16",
          "meshblock/nx3=8"]
DECKS = {
    "mhd3d": ("inputs/mhd/blast.athinput", BLAST3),
    "mhd2d": ("inputs/mhd/orszag_tang.athinput",
              ["mesh/nx1=16", "mesh/nx2=16", "meshblock/nx1=8",
               "meshblock/nx2=16"]),
    "smr": ("inputs/mhd/blast_smr.athinput",
            ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16",
             "mesh/nx3=16", "meshblock/nx1=8", "meshblock/nx2=8",
             "meshblock/nx3=8"]),
}
# no bin edge at the ambient density 1 or field 0.1, where the two
# packages' cells may lie an ulp apart
PDF = {"file_type": "pdf", "variable": "mhd_w_d", "bin_min": 0.05,
       "bin_max": 20.0, "nbin": 15}
JOINT = dict(PDF, variable_2="mhd_bmag", bin2_min=1e-3, bin2_max=10.0,
             nbin2=7)
CART = {"file_type": "cartgrid", "variable": "mhd_w_bcc", "extent_x": 0.7,
        "extent_y": 0.7, "extent_z": 0.7, "numpoints_x": 5,
        "numpoints_y": 4, "numpoints_z": 3}
SPH = {"file_type": "sphsurf", "variable": "mhd_w", "ntheta": 6}
# case -> (deck, the <output9> block)
WRITERS = {
    "cbin 3d": ("mhd3d", {"file_type": "cbin", "variable": "mhd_w_bcc"}),
    # a name the registry does not know: w, as the JAX package's bin
    "cbin unknown name": ("mhd3d", {"file_type": "cbin",
                                    "variable": "mhd_nope"}),
    "cbin 3d moments": ("mhd3d", {"file_type": "cbin", "variable": "mhd_u",
                                  "coarsen_factor": 4,
                                  "compute_moments": "true"}),
    "cbin 2d": ("mhd2d", {"file_type": "cbin", "variable": "mhd_w_bcc"}),
    "cbin 2d moments": ("mhd2d", {"file_type": "cbin", "variable": "mhd_j2",
                                  "coarsen_factor": 4,
                                  "compute_moments": "true"}),
    "pdf log": ("mhd3d", PDF),
    "pdf linear": ("mhd3d", dict(PDF, logscale="false", bin_min=0.0)),
    "pdf mass": ("mhd3d", dict(PDF, mass_weighted="true")),
    "pdf joint": ("mhd3d", JOINT),
    "pdf 2d joint mass": ("mhd2d", dict(JOINT, mass_weighted="true",
                                        logscale2="false", bin2_min=0.0)),
    "cartgrid uniform": ("mhd3d", CART),
    "cartgrid chebyshev": ("mhd3d", dict(CART, chebyshev="true",
                                         center_x=0.1)),
    "cartgrid smr": ("smr", dict(CART, variable="mhd_divb")),
    "cartgrid smr chebyshev": ("smr", dict(CART, chebyshev="true")),
    "sphsurf radius": ("mhd3d", dict(SPH, radius=0.4)),
    "sphsurf linear": ("mhd3d", dict(SPH, nradii=3, r_min=0.2, r_max=0.6,
                                     xc=0.05)),
    "sphsurf log": ("mhd3d", dict(SPH, nradii=4, r_min=0.1, r_max=0.8,
                                  r_spacing="log")),
    "sphsurf smr": ("smr", dict(SPH, variable="mhd_curv", nradii=2,
                                r_min=0.3, r_max=0.7)),
    "log": ("mhd3d", {"file_type": "log", "dcycle": 1}),
}


def _block(spec, n=9):
    return [f"output{n}/{k}={v}" for k, v in spec.items()]


def _in(path, fn):
    cwd = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jax.numpy.asarray(tree)


_STATES = {}


def _state(deck):
    """The port's state of a deck after three cycles (shared), with its
    mesh, physics and driver."""
    if deck not in _STATES:
        path, over = DECKS[deck]
        pin = ParameterInput.from_string(deck_text(path))
        pin.modify_from_cmdline(over + ["time/nlim=3"])
        mesh, phys, _, driver, state = torch_main.build(pin, device="cpu")
        state = driver.execute(driver.initialize(state))
        _STATES[deck] = (mesh, driver.phys, driver, state)
    return _STATES[deck]


class _Counters:
    def __init__(self, ecounters):
        self.ecounters = ecounters


def _files(root):
    out = []
    for d, _, fs in os.walk(root):
        out += [os.path.relpath(os.path.join(d, f), root) for f in fs]
    return sorted(out)


@pytest.mark.parametrize("case", sorted(WRITERS))
def test_writer_bytes_match_jax(case, tmp_path, one_torch_thread):
    deck, spec = WRITERS[case]
    mesh, phys, driver, state = _state(deck)
    path, over = DECKS[deck]
    text = deck_text(path)
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + over + _block(spec))
    jmesh, jphys, _, _, _ = jax_main.build(pj)
    # the header is the parameter dump: the port's writer gets the JAX
    # build's (with the defaults it added)
    pt = ParameterInput.from_string(pj.dump())
    jmesh.time, jmesh.ncycle = mesh.time, mesh.ncycle
    jst = _to_jax(state_to_numpy(state))
    ft = spec["file_type"]
    tout = _in(str(tmp_path / "port"), lambda: torch_outputs._TYPES[ft](
        pt, mesh, phys, "output9"))
    jout = _in(str(tmp_path / "jax"), lambda: jax_outputs._TYPES[ft](
        pj, jmesh, jphys, "output9"))
    tout.driver = driver
    jout.driver = _Counters(dict(driver.ecounters))
    assert driver.ecounters
    for _ in range(2):   # the bins file once, the file numbers
        _in(str(tmp_path / "port"),
            lambda: tout.maybe_write(mesh, state, force=True))
        _in(str(tmp_path / "jax"), lambda: jout.maybe_write(
            jmesh, jst["u"], jst["w"], force=True, state=jst))
    names = _files(tmp_path / "port")
    assert names == _files(tmp_path / "jax") and names
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name


def test_output_directories_made_as_jax(tmp_path):
    """``pdf``, ``cartgrid`` and ``sphsurf`` make their directories when
    they are built, ``cbin`` when it writes (so ``-v`` makes them)."""
    path, over = DECKS["mhd3d"]
    specs = [PDF, CART, dict(SPH, radius=0.4),
             {"file_type": "cbin", "variable": "mhd_w_bcc"}]
    args = over + [a for n, s in enumerate(specs, 2) for a in _block(s, n)]
    pt = ParameterInput.from_string(deck_text(path))
    pt.modify_from_cmdline(args)
    mesh, phys, _, _, _ = torch_main.build(pt, device="cpu")
    _in(str(tmp_path), lambda: torch_outputs.make_outputs(pt, mesh, phys))
    assert sorted(os.listdir(tmp_path)) == ["cart", "pdf_mhd_w_d", "sph"]


# --------------------------------------------------------------- end to end
E2E = ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
       "meshblock/nx1=16", "meshblock/nx2=16", "meshblock/nx3=8",
       "time/nlim=3"]
Q = 0.25 * 2.0 / 16
E2E += [f"mesh/x{a}min={-1.0 + Q}" for a in (1, 2, 3)] \
    + [f"mesh/x{a}max={1.0 + Q}" for a in (1, 2, 3)]
E2E_OUT = [a for n, s in enumerate([
    {"file_type": "bin", "variable": "mhd_curv", "dcycle": 3},
    {"file_type": "cbin", "variable": "mhd_w_bcc", "coarsen_factor": 4,
     "compute_moments": "true", "dcycle": 1},
    dict(PDF, mass_weighted="true", dcycle=1),
    dict(JOINT, dcycle=1),
    dict(CART, chebyshev="true", dcycle=1),
    dict(SPH, nradii=3, r_min=0.1, r_max=0.7, r_spacing="log", dcycle=1),
    {"file_type": "log", "dcycle": 1}], 2) for a in _block(s, n)]


@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """The blast with every output through both CLIs."""
    base = tmp_path_factory.mktemp("e2e")
    deck = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "inputs", "mhd", "blast.athinput")
    # each package's stage gate named, so that both dumps hold both keys
    args = ["-i", deck, *JAX_EXTRA, "mhd/use_pallas=auto",
            "mhd/use_kernels=true", *E2E, *E2E_OUT]
    old = os.environ.get("ATHENAK_DEVICE")
    os.environ["ATHENAK_DEVICE"] = "cpu"
    cwd = os.getcwd()
    try:
        torch_main.cli(["-d", str(base / "port"), *args])
        os.chdir(cwd)
        jax_main.main(["-d", str(base / "jax"), *args])
    finally:
        os.chdir(cwd)
        if old is None:
            del os.environ["ATHENAK_DEVICE"]
        else:
            os.environ["ATHENAK_DEVICE"] = old
    return base / "port", base / "jax"


def _ulp_close(got, ref, label):
    """Within one float32 ulp of the value, or 1e-10 of the scale where
    the value is round-off in float64 (a velocity of 1e-18 at rest)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, label
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(ref)))
    tol = np.maximum(ulp, 1e-10 * float(np.abs(ref).max()))
    assert (np.abs(got.astype(np.float64) - ref) <= tol).all(), label


def _close(got, ref, label):
    scale = max(float(np.abs(ref).max()), 1e-300)
    assert float(np.abs(got - ref).max()) <= 1e-10 * scale, label


def _same_header(a, b, label):
    """Byte-equal but for the preheader's time, whose last of 17 digits
    carry the round-off of the dt chain (the time to 1e-12)."""
    la, lb = a.split(b"\n"), b.split(b"\n")
    assert len(la) == len(lb), label
    for x, y in zip(la, lb):
        if x.startswith(b"  time=") and y.startswith(b"  time="):
            assert abs(float(x[7:]) - float(y[7:])) <= 1e-12 * abs(
                float(y[7:])), label
        else:
            assert x == y, label


def _split_header(data, marker):
    i = data.index(marker)
    return data[:i], data[i:]


def test_e2e_same_files(e2e):
    port, jaxdir = e2e
    names = _files(port)
    assert names == _files(jaxdir)
    kinds = {n.split(os.sep)[0] if os.sep in n else n.rsplit(".", 1)[-1]
             for n in names}
    assert kinds == {"bin", "cbin_mhd_w_bcc_4", "pdf_mhd_w_d",
                     "pdf_mhd_w_d_mhd_bmag", "cart", "sph", "log"}


def test_e2e_bin_and_cbin(e2e):
    port, jaxdir = e2e
    for name in _files(port):
        if not name.endswith((".bin", ".cbin")) or name.startswith("cart"):
            continue
        a, b = (port / name).read_bytes(), (jaxdir / name).read_bytes()
        off = a.index(b"header offset=")
        end = a.index(b"\n", off) + 1 + int(a[off + 14:a.index(b"\n", off)])
        _same_header(a[:end], b[:end], name)
        fa, fb = read_binary(str(port / name)), read_binary(str(jaxdir / name))
        for k in ("mb_index", "mb_logical", "mb_geometry"):
            np.testing.assert_array_equal(fa[k], fb[k])
        assert fa["var_names"] == fb["var_names"]
        for v in fb["var_names"]:
            if name.endswith(".cbin"):
                _ulp_close(fa["mb_data"][v], fb["mb_data"][v], f"{name} {v}")
            else:
                _close(fa["mb_data"][v], fb["mb_data"][v], f"{name} {v}")


def test_e2e_cartgrid(e2e):
    port, jaxdir = e2e
    head = struct.calcsize("=if3f3f3i?3xi")
    for name in _files(port):
        if not name.startswith("cart"):
            continue
        a, b = (port / name).read_bytes(), (jaxdir / name).read_bytes()
        n = head + 4 + struct.unpack("=i", a[head:head + 4])[0]
        assert a[:n] == b[:n] and len(a) == len(b), name
        _ulp_close(np.frombuffer(a[n:], np.float32),
                   np.frombuffer(b[n:], np.float32), name)


def test_e2e_sphsurf(e2e):
    port, jaxdir = e2e
    for name in _files(port):
        if not name.startswith("sph"):
            continue
        a, b = (port / name).read_bytes(), (jaxdir / name).read_bytes()
        ha, ra = _split_header(a, b"\nSCALARS weights")
        hb, rb = _split_header(b, b"\nSCALARS weights")
        assert ha == hb and len(a) == len(b), name
        # the weights and the labels as written, each variable's values
        # within an ulp
        recs_a, recs_b = ra.split(b"\nSCALARS "), rb.split(b"\nSCALARS ")
        for x, y in zip(recs_a, recs_b):
            xa, xb = x.split(b"LOOKUP_TABLE default\n", 1), \
                y.split(b"LOOKUP_TABLE default\n", 1)
            assert xa[0] == xb[0], name
            if len(xa) == 2:
                _ulp_close(np.frombuffer(xa[1], ">f4"),
                           np.frombuffer(xb[1], ">f4"), name)


def test_e2e_pdf_and_log(e2e):
    port, jaxdir = e2e
    for name in _files(port):
        if name.endswith(".log") or name.endswith(".bins.pdf"):
            assert (port / name).read_text() == \
                (jaxdir / name).read_text(), name
        elif name.endswith(".pdf"):
            a = (port / name).read_text().splitlines()
            b = (jaxdir / name).read_text().splitlines()
            assert a[0] == b[0] and len(a) == len(b), name
            _close(np.loadtxt(str(port / name)),
                   np.loadtxt(str(jaxdir / name)), name)
