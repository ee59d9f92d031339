"""History, VTK and restart outputs, and ``-r``, through both packages.

  * ``hst``: ``inputs/hydro/lw_implode.athinput`` at 32^2 for 4 cycles
    with a history row every cycle in ``%.17e``, through the port's
    ``main.run`` and the JAX package's ``main.run``: both files read by
    ``athenak_tpu.vis.readers.read_hst`` have the same columns and rows,
    every value within 1e-12 of the JAX value (relative), the header
    text equal.
  * ``vtk``: the same runs' dumps; the first (the initial state) is
    byte for byte the JAX package's, and the JAX writer given the port's
    final state writes the port's last file byte for byte.
  * ``rst`` and ``-r``, float64 on the CPU:
      - the port straight against the port restarted, bitwise, on
        ``inputs/turb/turb.athinput`` at 16^3 (hydro, FOFC, forcing; u,
        w, the force and the threefry key) and ``inputs/mhd/blast`` at
        16^3 (u, w, the face field); the history rows after the restart
        point equal the straight run's;
      - the port resumed from a JAX-written ``.rst`` of the turbulence
        deck against the JAX package resumed from it (``run_restart``),
        to 1e-10;
      - the JAX package's ``load_restart`` reads the port's ``.rst``:
        the same keys, parameters, time, dt, cycle and arrays.
  * ``bin`` of an isothermal run, byte for byte the JAX package's file
    from the same state: ``hydro_w`` of ``inputs/tests/advect_hyd`` with
    its passive scalar and without (four channels), ``mhd_w_bcc`` of the
    isothermal ``linear_wave_mhd`` (seven).
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu import outputs as jax_outputs  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.vis.readers import read_hst  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch import outputs as torch_outputs  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (JAX_EXTRA, ROOT, assert_states_close,  # noqa
                               interior)

IMPLODE = os.path.join(ROOT, "inputs", "hydro", "lw_implode.athinput")
TURB = os.path.join(ROOT, "inputs", "turb", "turb.athinput")
BLAST = os.path.join(ROOT, "inputs", "mhd", "blast.athinput")
IMPLODE_CUT = ["mesh/nx1=32", "mesh/nx2=32", "meshblock/nx1=32",
               "meshblock/nx2=32", "time/nlim=4", "output1/dcycle=1",
               "output1/data_format=%.17e", "output2/dcycle=2"]
CUT3 = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
TURB_CUT = ["job/precision=double", "output1/data_format=%.17e"] + CUT3
BLAST_CUT = ["job/precision=double", "output8/file_type=hst",
             "output8/dcycle=1", "output8/data_format=%.17e"] + CUT3
RST = ["output9/file_type=rst", "output9/dcycle=3"]


def _in(path, fn):
    cwd = os.getcwd()
    os.makedirs(path, exist_ok=True)
    os.chdir(path)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _port_cli(rundir, args):
    return _in(rundir, lambda: torch_main.cli(list(args)))


@pytest.fixture(scope="module")
def implode(tmp_path_factory):
    """The implosion through both packages: (port dir, JAX dir, port
    result)."""
    base = tmp_path_factory.mktemp("implode")
    pj = JaxInput.from_file(IMPLODE)
    pj.modify_from_cmdline(IMPLODE_CUT + JAX_EXTRA)
    _in(str(base / "jax"), lambda: jax_main.run(pj))
    pt = torch_main.read_deck(IMPLODE, IMPLODE_CUT)
    res = _in(str(base / "port"), lambda: torch_main.run(pt, device="cpu"))
    return base / "port", base / "jax", res


def test_hst_matches_jax(implode):
    port, jaxdir, _ = implode
    got, ref = read_hst(str(port / "Implode.hst")), \
        read_hst(str(jaxdir / "Implode.hst"))
    assert list(got) == list(ref) == [
        "time", "dt", "mass", "1-mom", "2-mom", "3-mom", "tot-E", "1-KE",
        "2-KE", "3-KE"]
    # a row at t = 0, one a cycle, and the final one
    assert len(ref["time"]) == 6
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-12,
                                   atol=1e-12 * np.abs(ref[name]).max(),
                                   err_msg=name)
    assert (port / "Implode.hst").read_text().splitlines()[:2] == \
        (jaxdir / "Implode.hst").read_text().splitlines()[:2]


def test_vtk_matches_jax(implode, tmp_path):
    port, jaxdir, (mesh, phys, _, state) = implode
    names = sorted(os.path.basename(f) for f in glob.glob(
        str(port / "*.vtk")))
    assert names == sorted(os.path.basename(f) for f in glob.glob(
        str(jaxdir / "*.vtk")))
    assert names[0] == "Implode.hydro_w.00000.vtk" and len(names) == 4
    assert (port / names[0]).read_bytes() == (jaxdir / names[0]).read_bytes()
    # the JAX writer on the port's final state
    pj = JaxInput.from_file(IMPLODE)
    pj.modify_from_cmdline(IMPLODE_CUT + JAX_EXTRA)
    jmesh, jphys, _, _, _ = jax_main.build(pj)
    jmesh.time, jmesh.ncycle = mesh.time, mesh.ncycle
    out = jax_outputs.VtkOutput(pj, jmesh, jphys, "output2")
    out.params.file_number = len(names) - 1
    sv = state_to_numpy(state)
    _in(str(tmp_path), lambda: out.write(jmesh, sv["u"], sv["w"]))
    assert (tmp_path / names[-1]).read_bytes() == \
        (port / names[-1]).read_bytes()


# ------------------------------------------------------------ restarts
def _straight_and_restarted(tmp_path, deck, cut, basename):
    """(straight result, restarted result, the restart time) of 6
    cycles: the second run stops at cycle 3, writes its .rst, and
    resumes with ``-r``."""
    common = ["-i", deck, *cut, *RST]
    straight = _port_cli(str(tmp_path / "straight"),
                         common + ["time/nlim=6"])
    _port_cli(str(tmp_path / "first"), common + ["time/nlim=3"])
    # the .rst files: t = 0, cycle 3 (dcycle) and the final one
    rst = sorted(glob.glob(str(tmp_path / "first" / f"{basename}.*.rst")))
    assert [os.path.basename(f)[-9:] for f in rst] == \
        ["00000.rst", "00001.rst", "00002.rst"]
    t_rst = torch_outputs.load_restart(rst[1])[1]
    resumed = _port_cli(str(tmp_path / "first"),
                        ["-r", rst[1], "time/nlim=6"])
    return straight, resumed, t_rst


@pytest.mark.parametrize("deck", ["turb", "blast"])
def test_restart_is_bitwise(deck, tmp_path, monkeypatch):
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    path, cut, base = {"turb": (TURB, TURB_CUT, "Turb"),
                       "blast": (BLAST, BLAST_CUT, "Blast")}[deck]
    straight, resumed, t_rst = _straight_and_restarted(tmp_path, path,
                                                       cut, base)
    (m1, p1, d1, s1), (m2, p2, d2, s2) = straight, resumed
    assert m1.ncycle == m2.ncycle == 6 and m1.time == m2.time
    assert m1.dt == m2.dt
    a, b = state_to_numpy(s1), state_to_numpy(s2)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            for c in a[k]:
                np.testing.assert_array_equal(b[k][c], a[k][c], err_msg=c)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    if deck == "turb":
        assert p1.use_fofc and "turb_key" in a and "nfofc" in d2.ecounters
    else:
        assert p1.is_mhd
    # the history rows after the restart point are the straight run's
    rows = [[r for r in (tmp_path / run / f"{base}.hst").read_text()
             .splitlines()[2:] if float(r.split()[0]) > t_rst]
            for run in ("straight", "first")]
    assert rows[0] and rows[1] == rows[0]
    assert len(rows[0]) == (4 if deck == "blast" else 1)


def test_resume_from_jax_restart(tmp_path, monkeypatch):
    """A JAX-written .rst of the driven, FOFC turbulence deck, resumed
    by both packages for three more cycles."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    pj = JaxInput.from_file(TURB)
    pj.modify_from_cmdline(TURB_CUT + RST + JAX_EXTRA + ["time/nlim=3"])
    _in(str(tmp_path / "jax"), lambda: jax_main.run(pj))
    rst = str(tmp_path / "jax" / "Turb.00001.rst")
    _, jphys, _, jst = _in(str(tmp_path / "jax_resumed"),
                           lambda: jax_main.run_restart(
                               rst, overrides=["time/nlim=6"]))
    mesh, phys, _, st = _port_cli(str(tmp_path / "port"),
                                  ["-r", rst, "time/nlim=6"])
    assert mesh.ncycle == 6
    ref = jax.tree_util.tree_map(np.asarray, jst)
    got = state_to_numpy(st)
    assert_states_close(got, ref, 1e-10)
    np.testing.assert_array_equal(got["turb_key"], ref["turb_key"])
    np.testing.assert_allclose(interior(got["turb_force"]),
                               interior(ref["turb_force"]), rtol=0,
                               atol=1e-10 * np.abs(ref["turb_force"]).max())


def test_jax_reads_port_restart(tmp_path, monkeypatch):
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    mesh, _, _, st = _port_cli(str(tmp_path), [
        "-i", TURB, *TURB_CUT, *RST, "time/nlim=3"])
    path = str(tmp_path / "Turb.00001.rst")
    params, t, dt, ncyc, jst = jax_outputs.load_restart(path)
    tparams, tt, tdt, tncyc, tst = torch_outputs.load_restart(path)
    assert (params, t, dt, ncyc) == (tparams, tt, tdt, tncyc)
    assert ncyc == 3 and t == mesh.time and dt == mesh.dt
    assert "<turb_driving>" in params and "fofc = true" in params
    assert sorted(jst) == sorted(tst) == ["turb_force", "turb_key", "u",
                                          "w"]
    got = state_to_numpy(st)
    for k in jst:
        np.testing.assert_array_equal(np.asarray(jst[k]), tst[k])
        np.testing.assert_array_equal(tst[k], got[k])
    assert tst["turb_key"].dtype == np.uint32


def test_restart_cli_flags(tmp_path, monkeypatch):
    """``-r`` with a path relative to the caller's directory and ``-d``
    (the file is found before the directory changes); ``-p`` traces the
    run into a directory of the run directory."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    _port_cli(str(tmp_path / "a"), ["-i", TURB, *TURB_CUT, *RST,
                                    "time/nlim=3"])
    monkeypatch.chdir(tmp_path)
    mesh, _, _, _ = torch_main.cli(["-r", "a/Turb.00001.rst", "-d", "b",
                                    "time/nlim=4"])
    assert mesh.ncycle == 4 and os.getcwd() == str(tmp_path / "b")
    assert os.path.exists(tmp_path / "b" / "Turb.hst")
    monkeypatch.chdir(tmp_path)
    torch_main.cli(["-i", TURB, "-d", "c", "-p", "prof", *TURB_CUT,
                    "time/nlim=1"])
    assert len(os.listdir(tmp_path / "c" / "prof")) == 1


# ------------------------------------------------------------ bin (F14)
ADVECT = os.path.join(ROOT, "inputs", "tests", "advect_hyd.athinput")
LWAVE_MHD = os.path.join(ROOT, "inputs", "tests", "linear_wave_mhd.athinput")
BIN_CASES = {
    "hydro_w scalar": (ADVECT, ["output7/variable=hydro_w"], 4),
    "hydro_w no scalar": (ADVECT, ["output7/variable=hydro_w",
                                   "hydro/nscalars=0"], 4),
    "mhd_w_bcc isothermal": (LWAVE_MHD, ["output7/variable=mhd_w_bcc",
                                         "mhd/eos=isothermal",
                                         "mesh/nx1=16", "mesh/nx2=8",
                                         "mesh/nx3=8"], 7),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_isothermal_bin_matches_jax(case, tmp_path):
    """The ``bin`` of an isothermal run: min(nhydro, 5) fluid channels
    under their labels (four here, a passive scalar left out), with the
    three bcc for ``*_bcc`` (seven), byte for byte the JAX package's file
    from the same state and parameters."""
    deck, extra, nvar = BIN_CASES[case]
    pj = JaxInput.from_file(deck)
    pj.modify_from_cmdline(JAX_EXTRA + extra + ["output7/file_type=bin"])
    jmesh, jphys, _, _, st = jax_main.build(pj)
    st = jax.tree_util.tree_map(np.asarray, jax.jit(jphys.init_ghosts)(st))
    jout = jax_outputs.BinaryOutput(pj, jmesh, jphys, "output7")
    from athenak_tpu_torch.athinput import ParameterInput
    pt = ParameterInput.from_string(pj.dump())
    tmesh, tphys, _, _, _ = torch_main.build(
        ParameterInput.from_string(pj.dump()), device="cpu")
    tout = torch_outputs.BinaryOutput(pt, tmesh, tphys, "output7")
    tst = {k: (torch.tensor(v) if not isinstance(v, dict) else
               {c: torch.tensor(a) for c, a in v.items()})
           for k, v in st.items()}
    _in(str(tmp_path / "port"), lambda: tout.write(tmesh, tst))
    jst = jax.tree_util.tree_map(jax.numpy.asarray, st)
    _in(str(tmp_path / "jax"), lambda: jout.write(
        jmesh, jst["u"], jst["w"], bcc=jst.get("bcc"), state=jst))
    name = os.listdir(tmp_path / "port")[0]
    got = (tmp_path / "port" / name).read_bytes()
    assert got == (tmp_path / "jax" / name).read_bytes()
    assert f"number of variables={nvar}\n".encode() in got
