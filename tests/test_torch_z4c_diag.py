"""The Z4c diagnostics and their files: the port against the JAX package
on the CPU in float64.

On one state (``tests/test_cce.py``'s single puncture at 16^3, after
the port's ghost initialisation, given to both packages):

  * the CCE worldtube and horizon-cube dumps written by each package:
    each package's reader reads the other's file, the values to 1e-10;
    the ETK parameter files equal;
  * ``bin`` of ``z4c``, ``adm``, ``con`` and ``con_H`` read by the JAX
    package's reader: equal names, the values against the JAX package's
    ``bin`` (its variable registry) to 1e-10, and the port's ``tab``
    (printed to 17 digits) to 1e-10 and ``vtk`` (float32) of them
    against the same registry values (the JAX package's
    ``tab`` and ``vtk`` do not consult it, ROADMAP F11); ``adm_psi4``
    (which the JAX registry cannot compute, F11) equals psi^2;
  * the deck itself through the port's ``main.run``: ``<cce>`` and
    ``dump_horizon_0`` write on their own cadence (the JAX package's
    driver stops at them, ROADMAP F11);

and ``FastFlow`` on the Schwarzschild puncture with
``tests/test_ahf.py``'s mesh and finder settings: the same horizon to
1e-10, M_irr within 0.01 of 1 and the mean radius within 0.03 of 1/2.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.outputs import make_outputs as jax_outputs  # noqa: E402
from athenak_tpu.outputs.variables import resolve  # noqa: E402
from athenak_tpu.vis.readers import read_binary  # noqa: E402
from athenak_tpu.z4c import ahf as jax_ahf  # noqa: E402
from athenak_tpu.z4c import cce as jax_cce  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.outputs import make_outputs  # noqa: E402
from athenak_tpu_torch.z4c import ahf, cce  # noqa: E402
from test_cce import DECK as CCE_DECK  # noqa: E402
from test_ahf import DECK as AHF_DECK  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import JAX_EXTRA, interior  # noqa: E402

VARS = ["z4c", "adm", "con", "con_H"]
# the tables print 17 digits, so that they can be held to 1e-10
OUTS = "".join(
    f"\n<output{n + 1}>\nfile_type = {kind}\nvariable = {v}\n"
    f"data_format = %24.16e\n"
    for n, (kind, v) in enumerate(
        [("bin", v) for v in VARS + ["adm_psi4"]]
        + [("tab", v) for v in ("z4c", "adm", "con")] + [("vtk", "adm")]))


@pytest.fixture(scope="module")
def puncture():
    """Both packages built on the CCE deck (with the output blocks); the
    port's initialised state, as tensors and as JAX arrays."""
    text = CCE_DECK + OUTS
    pt = ParameterInput.from_string(text)
    mesh, phys, _, driver, st = torch_main.build(pt, device="cpu")
    st = driver.initialize(st)
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA)
    jmesh, jphys, *_ = jax_main.build(pj)
    jst = {"u": jnp.asarray(st["u"].numpy()), "w": jnp.asarray(
        st["u"].numpy())}
    return (pt, mesh, phys, st), (pj, jmesh, jphys, jst)


def test_cce_and_horizon_files_cross_read(puncture, tmp_path, monkeypatch):
    (pt, mesh, phys, st), (pj, jmesh, jphys, jst) = puncture
    monkeypatch.chdir(tmp_path)
    mesh.time = jmesh.time = 0.25
    files = {}
    for tag, mod, pin, m, p, z in (
            ("port", cce, pt, mesh, phys, st["u"]),
            ("jax", jax_cce, pj, jmesh, jphys, jst["u"])):
        files[tag] = (
            mod.CCE(pin, m, 0).dump(m, p, z, outdir=f"{tag}/cce"),
            mod.HorizonDump(pin, m, 0).dump(m, p, z, center=(0.1, 0.0, -0.2),
                                            outdir=tag))
    for reader_c, reader_h in ((cce.read_cce, cce.read_horizon_dump),
                               (jax_cce.read_cce,
                                jax_cce.read_horizon_dump)):
        a, b = (reader_c(files[t][0]) for t in ("port", "jax"))
        assert a["nr"] == b["nr"] == 3 and a["num_l_modes"] == 4
        assert (a["time"], a["rin"], a["rout"]) == (0.25, 2.0, 5.0)
        for k in ("real", "imag"):
            assert np.abs(a[k] - b[k]).max() <= 1e-10 * np.abs(b[k]).max()
        a, b = (reader_h(files[t][1], 6) for t in ("port", "jax"))
        assert a["common_horizon"] == b["common_horizon"] == 0
        assert a["time"] == 0.25 and a["data"].shape == (16, 6, 6, 6)
        assert np.abs(a["data"] - b["data"]).max() \
            <= 1e-10 * np.abs(b["data"]).max()
    pars = [open(os.path.join(os.path.dirname(files[t][1]),
                              "ET_analyze_BHaH_data_horizon.par")).read()
            for t in ("port", "jax")]
    assert pars[0] == pars[1] and "Driver::global_nsize = 6" in pars[0]


def test_bin_tab_vtk_of_z4c_variables(puncture, tmp_path, monkeypatch):
    (pt, mesh, phys, st), (pj, jmesh, jphys, jst) = puncture
    mbi = mesh.mb_indcs
    sl = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
          slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    for tag, outs, m, state in (
            ("port", make_outputs(pt, mesh, phys), mesh, st),
            ("jax", jax_outputs(pj, jmesh, jphys), jmesh, jst)):
        (tmp_path / tag).mkdir()
        monkeypatch.chdir(tmp_path / tag)
        for out in outs:
            if not hasattr(out, "params"):
                continue             # the CCE and horizon dumps
            if tag == "port":
                out.write(m, state)
            elif out.params.variable == "adm_psi4":
                # the JAX registry takes the six-component list for a
                # 3 x 3 one (ROADMAP F11)
                with pytest.raises(IndexError):
                    out.write(m, state["u"], state["w"], state=state)
            elif out.params.file_type == "bin":
                out.write(m, state["u"], state["w"], state=state)
    for n, v in enumerate(VARS):
        name = f"punc.{v}.00000.bin"
        a = read_binary(str(tmp_path / "port" / name))
        b = read_binary(str(tmp_path / "jax" / name))
        assert a["var_names"] == b["var_names"] and a["n_mbs"] == 1
        for k in b["var_names"]:
            x, y = a["mb_data"][k], b["mb_data"][k]
            assert np.isfinite(y).all()
            assert np.abs(x - y).max() <= 1e-10 * max(np.abs(y).max(),
                                                      1e-300), (v, k)
    # tab and vtk against the JAX registry's values on the interior
    for v in ("z4c", "adm", "con"):
        labels, want = resolve(v, jphys, jst, jmesh)
        want = np.asarray(want)[sl]
        name = tmp_path / "port" / f"punc.{v}.00000.tab"
        tab = np.loadtxt(name)
        assert tab.shape == (16 ** 3, 7 + len(labels))
        got = tab[:, 7:].T.reshape(want.shape[1:])
        scale = np.maximum(np.abs(want).max(axis=(0, 2, 3, 4)), 1e-300)
        assert (np.abs(got - want[0]).max(axis=(1, 2, 3))
                <= 1e-10 * scale).all(), v
        with open(name) as f:
            f.readline()
            assert f.readline().split()[-len(labels):] == labels
    vtk = (tmp_path / "port" / "punc.adm.00000.vtk").read_bytes()
    labels, want = resolve("adm", jphys, jst, jmesh)
    want = np.asarray(want)[sl][0].astype(">f4")
    for c, lab in enumerate(labels):
        i = vtk.index(f"SCALARS {lab} float\nLOOKUP_TABLE default\n"
                      .encode()) + len(lab) + 36
        got = np.frombuffer(vtk[i:i + 4 * 16 ** 3], ">f4")
        np.testing.assert_allclose(got, want[c].ravel(), rtol=1e-7)
    # adm_psi4 = det(gamma)^(1/6) = psi^2 of the conformally flat data
    psi4 = read_binary(str(tmp_path / "port" / "punc.adm_psi4.00000.bin"))
    chi = st["u"][sl].numpy()[0, 0]
    np.testing.assert_allclose(psi4["mb_data"]["adm_psi4"][0], chi ** -0.5,
                               rtol=1e-13)


def test_cce_deck_writes_through_the_driver(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    torch_main.run(ParameterInput.from_string(CCE_DECK), device="cpu")
    files = sorted(glob.glob("cce/cce_*.bin"))
    assert len(files) == 2          # t = 0 and the final time
    d = jax_cce.read_cce(files[0])
    assert d["real"].shape == (3, 10, 25) and np.isfinite(d["real"]).all()
    assert 0.3 < d["real"][0, 0, 0] / np.sqrt(4 * np.pi) < 1.0
    h = sorted(glob.glob("horizon_0/output_*/etk_output_file.dat"))
    assert len(h) == 2
    assert jax_cce.read_horizon_dump(h[0], 6)["time"] == 0.0


def test_cce_deck_resumes_through_r(tmp_path, monkeypatch):
    """The CCE deck with a restart file each cycle: 2 cycles straight
    against ``-r`` of the cycle-1 file.  The resumed run takes back the
    dumps' cadence and counts from the file, so it writes only the
    final dumps, byte for byte the straight run's, under the same
    names."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    text = CCE_DECK + "\n<output1>\nfile_type = rst\ndcycle = 1\n"
    (tmp_path / "punc.athinput").write_text(text)
    monkeypatch.chdir(tmp_path)
    torch_main.cli(["-i", "punc.athinput", "-d", "a"])
    os.chdir(tmp_path)
    torch_main.cli(["-r", "a/punc.00001.rst", "-d", "b"])

    def dumps(d):
        return sorted(os.path.relpath(f, d) for f in glob.glob(
            f"{d}/cce/*.bin") + glob.glob(f"{d}/horizon_0/*/*.dat"))

    a, b = dumps(tmp_path / "a"), dumps(tmp_path / "b")
    assert len(a) == 4                      # t = 0 and the final time
    assert b == [f for f in a if not f.startswith("cce/cce_0000000")
                 and "output_0" not in f] and len(b) == 2
    for f in b:
        assert (tmp_path / "a" / f).read_bytes() == \
            (tmp_path / "b" / f).read_bytes(), f


@pytest.mark.parametrize("nco", [0, 1])
def test_horizon_dumps_follow_the_trackers(nco, tmp_path, monkeypatch):
    """Horizon n is centred on tracker n (the device's co_pos), a
    horizon without a tracker (n >= nco) on its deck centre: each final
    dump equals a dump of the final state at that centre."""
    text = CCE_DECK.replace("dump_horizon_0 = true", f"""dump_horizon_0 = true
dump_horizon_1 = true
horizon_1_Nx = 6
nco = {nco}
co_0_x = 0.7
co_0_y = 0.4
co_1_x = -1.5""")
    monkeypatch.chdir(tmp_path)
    pin = ParameterInput.from_string(text)
    mesh, phys, _, st = torch_main.run(pin, device="cpu")
    pos = st["co_pos"].numpy() if nco else np.zeros((0, 3))
    if nco:
        assert np.abs(pos - phys.tracker_pos0).max() > 0.0
    for n in (0, 1):
        fname = cce.HorizonDump(pin, mesh, n).dump(
            mesh, phys, st["u"], center=pos[n] if n < nco else None,
            outdir="check")
        got = open(f"horizon_{n}/output_1/etk_output_file.dat", "rb").read()
        assert got == open(fname, "rb").read(), n
        if n < nco:      # the tracker's centre is not the deck's
            deck = cce.HorizonDump(pin, mesh, n).dump(
                mesh, phys, st["u"], outdir="deck")
            assert got != open(deck, "rb").read()


def test_post_cycle_needs_the_trackers():
    """A tracked run whose state lost ``co_pos`` stops with an error, not
    with trackers that silently stay put."""
    pin = ParameterInput.from_string(CCE_DECK.replace(
        "dump_horizon_0 = true", "dump_horizon_0 = true\nnco = 1"))
    _, phys, _, _, st = torch_main.build(pin, device="cpu")
    assert "co_pos" in phys.post_cycle(st, 0.01)
    with pytest.raises(ValueError, match="co_pos"):
        phys.post_cycle({"u": st["u"], "w": st["w"]}, 0.01)


def test_fastflow_matches_jax():
    """The apparent horizon of the puncture (M = 1) on 64^3 over
    [-2, 2]^3 with nghost 4: the port's ADM fields and finder against
    the JAX package's."""
    pt = ParameterInput.from_string(AHF_DECK)
    mesh, phys, _, driver, st = torch_main.build(pt, device="cpu")
    st = driver.initialize(st)
    fields = ahf.adm_fields_from_z4c(phys, st["u"])
    pj = JaxInput.from_string(AHF_DECK)
    pj.modify_from_cmdline(JAX_EXTRA)
    jmesh, jphys, *_ = jax_main.build(pj)
    jfields = jax_ahf.adm_fields_from_z4c(jphys, jnp.asarray(st["u"]))
    for k in ("g3d", "K_dd"):
        for a, b in zip(fields[k], jfields[k]):
            assert np.abs(a - b).max() <= 1e-12 * max(np.abs(b).max(), 1.0)
    for d in range(3):
        for a, b in zip(fields["dg"][d], jfields["dg"][d]):
            assert np.abs(interior(a[:, None], 4)
                          - interior(b[:, None], 4)).max() \
                <= 1e-10 * np.abs(b).max()
    got = ahf.FastFlow(lmax=6, ntheta=16, flow_iterations=300).find(
        mesh, fields, r_guess=0.7)
    want = jax_ahf.FastFlow(lmax=6, ntheta=16, flow_iterations=300).find(
        jmesh, jfields, r_guess=0.7)
    assert got is not None and want is not None
    assert got["iterations"] == want["iterations"]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-10 * max(abs(v), 1.0), k
    assert abs(got["mass_irr"] - 1.0) < 0.01
    assert abs(got["mean_radius"] - 0.5) < 0.03
