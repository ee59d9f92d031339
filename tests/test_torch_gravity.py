"""Self-gravity (``athenak_tpu_torch/gravity.py``, ``multigrid.py``, the
self-gravity source terms) against the JAX package, float64 on the CPU.

  * The FFT solve on a 2 x 2 x 1-block periodic mesh, phi (ghosts
    filled) to 1e-12.
  * One multigrid solve each from the same random source: uniform
    periodic 16^3, one statically refined box level (16^3 root) and
    ``zerofixed`` boundaries at 16^3: the verbose solve's defect history
    (the same number of V-cycles, each defect to 1e-10 of the first) and
    its potential to 1e-10; the port's ``solve`` takes the verbose
    solve's V-cycles.
  * Three cycles of ``inputs/tests/jeans_wave`` (16 x 8 x 8) and of
    tests/test_jeans.py's deck (its source term on, two blocks),
    ``selfgravity`` at 16^3 (its spheres lie inside a cell: a uniform
    density), ``binary_gravity`` on a 16^3 root of 4^3 blocks with its
    two refined levels (the generator's state, the verbose solve from the
    full-multigrid start with the bars of tests/test_multigrid.py, the
    error report; one cycle through the port's CLI), the Bonnor-Ebert
    collapse on a 16^3 root of 4^3 blocks
    through a tree update (two ghost cells; refinement checked every
    cycle), and ``be_collapse_mhd`` (multipole, outflow, barotropic
    hook) for two cycles (from the third, noise-level fields in the
    resting ambient gas flip the corner EMFs' upwind selects between the
    packages, ROADMAP F4): u, w and phi to 1e-10; on its final state the
    multipole coefficients (order 4, about the centre of mass), origin
    and boundary values of phi_mp to 1e-12.
  * The ``bin`` of ``mhd_w`` and ``mhd_bcc`` (be_collapse_mhd's state)
    byte for byte the JAX package's, and of ``grav_phi`` (the Jeans
    deck's) with the JAX package's header and the potential of its FFT
    solve (the JAX package's own file holds no cell data, ROADMAP F18).
  * A gravity restart: four cycles straight and two + ``-r`` two bitwise
    in u, the face field and phi (the ``.rst`` carries phi, as the JAX
    package's does).
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.bvals import BoundaryValues as JaxBV  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.bvals import BoundaryValues  # noqa: E402
from athenak_tpu_torch.mesh import Mesh  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (JAX_EXTRA, AmrPair, DeckPair,  # noqa: E402
                               JaxInput, assert_close, check_pair,
                               deck_text, interior)

JEANS = "inputs/tests/jeans_wave.athinput"
SELFG = "inputs/tests/selfgravity.athinput"
BINARY = "inputs/tests/binary_gravity.athinput"
BE = "inputs/tests/be_collapse.athinput"
BE_MHD = "inputs/tests/be_collapse_mhd.athinput"
ROOT16 = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
BLOCKS4 = ["meshblock/nx1=4", "meshblock/nx2=4", "meshblock/nx3=4"]
# the BE sphere on a 16^3 root of 4^3 blocks: two ghost cells (a 4-cell
# block holds no more) and njeans 4, so that only the blocks at the
# centre refine (at njeans 16 the refined region would reach the
# domain's faces, which the JAX package's box levels do not take)
BE_CUT = ROOT16 + BLOCKS4 + ["mesh/nghost=2", "problem/njeans=4"]
OUTFLOW = ["mesh/ix1_bc=outflow", "mesh/ox1_bc=outflow",
           "mesh/ix2_bc=outflow", "mesh/ox2_bc=outflow",
           "mesh/ix3_bc=outflow", "mesh/ox3_bc=outflow"]
NCYC = 3


def _pins(deck, extra):
    text = deck_text(deck)
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + list(extra))
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(list(extra))
    return pj, pt


def _physics(deck, extra):
    pj, pt = _pins(deck, extra)
    jm = JaxMesh(pj)
    jp = jax_main.make_physics(pj, jm, JaxBV(jm))
    tm = Mesh(pt)
    tp = torch_main.make_physics(pt, tm, BoundaryValues(tm), "cpu",
                                 torch.float64)
    return jp, tp


def _source(tp, seed=16):
    """A smooth positive density with a random part, [nmb, nvar, ...]."""
    mesh = tp.mesh
    mbi = mesh.mb_indcs
    rng = np.random.default_rng(seed)
    u = np.zeros((mesh.nmb_total, tp.nvar, mbi.ncells3, mbi.ncells2,
                  mbi.ncells1))
    for g in range(mesh.nmb_total):
        x, y, z = mesh.cell_centers(g)
        r2 = (x[None, None, :] ** 2 + y[None, :, None] ** 2
              + z[:, None, None] ** 2)
        u[g, 0] = 1.0 + 4.0 * np.exp(-r2 / 0.05)
    u[:, 0] *= 1.0 + 0.1 * rng.uniform(size=u[:, 0].shape)
    return u


def test_fft_solve_2x2x1_blocks():
    extra = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=8", "meshblock/nx1=8",
             "meshblock/nx2=8", "meshblock/nx3=8"]
    jp, tp = _physics(JEANS, extra)
    assert type(tp.pgrav).__name__ == "SelfGravity"
    assert tp.mesh.nmb_total == 4 and (tp.mesh.nmb_x1, tp.mesh.nmb_x2,
                                       tp.mesh.nmb_x3) == (2, 2, 1)
    u = _source(tp)
    got = tp.pgrav.solve(torch.as_tensor(u), tp.bvals).numpy()
    ref = np.asarray(jax.jit(lambda a: jp.pgrav.solve(a, jp.bvals))(
        jnp.asarray(u)))
    assert_close(got, ref, 1e-12, "phi")


MG_CASES = {
    "uniform": (SELFG, ROOT16 + ["gravity/threshold=1e-9"]),
    "smr_box": (BINARY, ROOT16 + BLOCKS4 + [
        "refined_region2/level=1", "gravity/threshold=1e-9",
        "gravity/full_multigrid=false", "gravity/show_defect=2"]),
    "zerofixed": (SELFG, ROOT16 + OUTFLOW + [
        "gravity/mg_bc=zerofixed", "gravity/threshold=1e-9"]),
}


@pytest.fixture(scope="module", params=sorted(MG_CASES))
def mg(request):
    """The verbose solve of one case in both packages."""
    deck, extra = MG_CASES[request.param]
    jp, tp = _physics(deck, extra)
    u = _source(tp)
    jhist = jp.pgrav.solve_verbose(jnp.asarray(u))
    thist = tp.pgrav.solve_verbose(torch.as_tensor(u))
    return types.SimpleNamespace(
        name=request.param, jp=jp, tp=tp, u=u, jhist=jhist, thist=thist,
        jphi=np.asarray(jp.pgrav._last_phi),
        tphi=tp.pgrav._last_phi.numpy())


def test_mg_defect_history(mg):
    """The same V-cycles, each defect to 1e-10 of the start guess's (a
    defect near the threshold is a residual at round-off of the
    source)."""
    assert len(mg.thist) == len(mg.jhist) > 1, (mg.thist, mg.jhist)
    assert_close(mg.thist, mg.jhist, 1e-10, "defects", scale=mg.jhist[0])
    assert mg.thist[-1] <= 1e-9


def test_mg_potential(mg):
    assert_close(mg.tphi, mg.jphi, 1e-10, f"{mg.name} phi")
    if mg.name == "smr_box":
        assert len(mg.tp.pgrav.boxes) == 1 and mg.tp.mesh.multilevel


def test_mg_solve_cycles(mg):
    """``solve`` (threshold mode: a host read of the defect a V-cycle)
    from the same start takes the verbose solve's V-cycles, or none where
    the start already meets the threshold, and fills the ghosts."""
    pg = mg.tp.pgrav
    phi = pg.solve(torch.as_tensor(mg.u), mg.tp.bvals)
    assert pg.last_cycles == (len(mg.thist) - 1
                              if mg.thist[0] > pg.eps else 0)
    assert phi.shape == (mg.u.shape[0], 1) + mg.u.shape[2:]
    assert torch.isfinite(phi).all()


# ---------------------------------------------------------------------------
# decks
# ---------------------------------------------------------------------------
JEANS_TEST_DECK = """
<job>
basename = JeansWave
<mesh>
nghost = 2
nx1 = 16
x1min = 0.0
x1max = 1.0
nx2 = 8
x2min = 0.0
x2max = 0.5
nx3 = 8
x3min = 0.0
x3max = 0.5
<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = 0.1
<hydro>
eos = isothermal
reconstruct = plm
rsolver = hlle
iso_sound_speed = 1.0
<gravity>
four_pi_G = 1.0
<hydro_srcterms>
self_gravity = true
<problem>
pgen_name = gravity
amp = 1.0e-6
n_jeans = 0.5
"""


def _check_phi(pair, tol=1e-10):
    assert_close(interior(pair.state["phi"]), interior(pair.jax_state["phi"]),
                 tol, "phi")


def test_jeans_wave_three_cycles(tmp_path):
    pair = check_pair(DeckPair(deck_text(JEANS), ["mesh/nx1=16",
                                                  "mesh/nx2=8",
                                                  "mesh/nx3=8"],
                               ncyc=NCYC, rundir=str(tmp_path)))
    assert type(pair.phys.pgrav).__name__ == "SelfGravity"


@pytest.fixture(scope="module")
def jeans2(tmp_path_factory):
    return DeckPair(JEANS_TEST_DECK, [], ncyc=NCYC,
                    rundir=str(tmp_path_factory.mktemp("jeans2")))


def test_jeans_source_term_three_cycles(jeans2):
    pair = check_pair(jeans2)
    assert pair.mesh.nmb_total == 2 and pair.phys.srcterms.self_gravity
    # the Jeans frequency of n_jeans = 0.5 has set four_pi_G
    assert pair.phys.pgrav.four_pi_G != 1.0
    np.testing.assert_allclose(pair.phys.pgrav.four_pi_G,
                               pair.jax_phys.pgrav.four_pi_G, rtol=1e-15)


def test_selfgravity_three_cycles(tmp_path):
    """As shipped at 16^3: the spheres (radius 6/1024) lie inside one
    cell, and the mass renormalisation leaves a uniform density, whose
    potential the multigrid finds in no V-cycle."""
    pair = check_pair(DeckPair(deck_text(SELFG), ROOT16, ncyc=NCYC,
                               rundir=str(tmp_path)))
    _check_phi(pair)
    rho = interior(pair.port_init["u"])[:, 0]
    assert np.ptp(rho) <= 1e-12 * rho.max()
    assert pair.phys.pgrav.nsolve == 2 * NCYC + 1
    assert pair.phys.pgrav.ncycles == 0


@pytest.fixture(scope="module")
def binary():
    """binary_gravity on a 16^3 root of 4^3 blocks with its two refined
    levels: both packages' generator state and verbose solve (the
    full-multigrid start, the deck's threshold 1e-9)."""
    from athenak_tpu.pgen import binary_gravity as jax_binary
    from athenak_tpu_torch.pgen import binary_gravity
    pj, pt = _pins(BINARY, ROOT16 + BLOCKS4)
    jm = JaxMesh(pj)
    jp = jax_main.make_physics(pj, jm, JaxBV(jm))
    jst = jax_binary.init(pj, jm, jp)
    tm = Mesh(pt)
    tp = torch_main.make_physics(pt, tm, BoundaryValues(tm), "cpu",
                                 torch.float64)
    tst = binary_gravity.init(pt, tm, tp)
    jhist = jp.pgrav.solve_verbose(jst["u"])
    thist = tp.pgrav.solve_verbose(tst["u"])
    return types.SimpleNamespace(pj=pj, pt=pt, jm=jm, tm=tm, jp=jp, tp=tp,
                                 jst=jst, tst=tst, jhist=jhist,
                                 thist=thist)


def test_binary_gravity_state_and_solve(binary):
    """The generator's state to 1e-12, the verbose solve's V-cycles and
    defects (the bars of tests/test_multigrid.py: 1e-9 in at most 13)
    and its potential to 1e-10; one cycle through the port's CLI."""
    b = binary
    assert b.tm.multilevel and len(b.tp.pgrav.boxes) == 2
    assert_close(interior(b.tst["u"].numpy()), interior(np.asarray(
        b.jst["u"])), 1e-12, "u")
    assert len(b.thist) == len(b.jhist) and len(b.thist) - 1 <= 13
    assert_close(b.thist, b.jhist, 1e-10, "defects", scale=b.jhist[0])
    assert b.thist[-1] <= 1e-9
    assert_close(b.tp.pgrav._last_phi.numpy(),
                 np.asarray(b.jp.pgrav._last_phi), 1e-10, "phi")


def test_binary_gravity_final(binary, capsys, monkeypatch):
    """The error report of both packages from one potential: the port's
    verbose-solve potential with its ghosts filled (each report's own
    fill made the identity)."""
    from athenak_tpu.pgen import binary_gravity as jax_binary
    from athenak_tpu_torch.pgen import binary_gravity
    b = binary
    phi = b.tp.bvals.fill_ghosts(b.tp.pgrav._last_phi.clone())
    monkeypatch.setattr(b.tp.bvals, "fill_ghosts", lambda a: a)
    monkeypatch.setattr(b.jp.bvals, "fill_ghosts", lambda a: a)
    got = binary_gravity.final(b.pt, b.tm, b.tp, b.tst, phi=phi)
    ref = jax_binary.final(b.pj, b.jm, b.jp, b.jst,
                           phi=jnp.asarray(phi.numpy()))
    assert "Potential    L2" in capsys.readouterr().out
    for k in ("pot_l2", "acc_l2", "pot_max", "acc_max"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-10)
    assert got["acc_l2"] < 1.0


def test_binary_gravity_cli_cycle(tmp_path, monkeypatch, capsys):
    """The deck as cut, one cycle (its nlim) through ``main.cli``: the
    defect printout of ``show_defect`` and the final report."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    deck = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), BINARY)
    cwd = os.getcwd()
    try:
        mesh, phys, _, st = torch_main.cli(["-i", deck, "-d", str(tmp_path),
                                            *ROOT16, *BLOCKS4])
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert mesh.ncycle == 1 and "MG initial defect" in out
    assert "MG iteration 0: defect" in out and "Potential    L2" in out
    assert torch.isfinite(st["u"]).all() and torch.isfinite(st["phi"]).all()


@pytest.fixture(scope="module")
def be(tmp_path_factory):
    return AmrPair(deck_text(BE), BE_CUT + [
        "mesh_refinement/refinement_interval=1", "time/nlim=2"],
        rundir=str(tmp_path_factory.mktemp("be")))


def test_be_collapse_tree_update(be):
    """One tree update (the centre's 8 blocks refine at cycle 1), the
    solves on both trees, the first on the new tree warm-started from
    the old tree's potential at the new gids, as the JAX package's."""
    be.check(tol=1e-10)
    assert [(c, len(t)) for c, t in be.trees] == [(1, 120)]
    assert_close(interior(be.state["phi"]), interior(be.jax_state["phi"]),
                 1e-10, "phi")
    assert be.phys.pgrav.nsolve == 2 and be.phys.mesh.multilevel


@pytest.fixture(scope="module")
def be_mhd(tmp_path_factory):
    """be_collapse_mhd on a 16^3 root of 4^3 blocks for two cycles."""
    return DeckPair(deck_text(BE_MHD), BE_CUT, ncyc=2,
                    rundir=str(tmp_path_factory.mktemp("bemhd")))


def test_be_collapse_mhd_two_cycles(be_mhd):
    pair = check_pair(be_mhd)
    _check_phi(pair)
    pg = pair.phys.pgrav
    assert pg.mg_bc == "multipole" and pg.mask_radius > 0.0
    assert pair.phys.srcterms_func is not None and pair.phys.use_flux_dir


def test_multipole_coefficients(be_mhd):
    """The expansion's coefficients and origin from the final state (sums:
    the order of summation differs between the packages, 1e-12) and the
    boundary values of phi_mp on every global level."""
    jpg, tpg = be_mhd.jax_phys.pgrav, be_mhd.phys.pgrav
    u = be_mhd.state["u"]
    tpg._multipole_setup(torch.as_tensor(u))
    ju = jnp.asarray(u)
    rho = ju[:, 0][(slice(None),) + jpg.act_in]
    vol = (np.asarray(jpg.mesh.mb_size["dx1"])
           * np.asarray(jpg.mesh.mb_size["dx2"])
           * np.asarray(jpg.mesh.mb_size["dx3"]))
    s = -jpg.four_pi_G * rho * jnp.asarray(vol.reshape(-1, 1, 1, 1))
    xs, ys, zs = [jnp.asarray(a) for a in jpg._block_coords()]
    tot = jnp.sum(s)
    origin = [jnp.sum(s * a) / tot for a in (xs, ys, zs)]
    mpc = jpg._mp_harmonics(xs - origin[0], ys - origin[1], zs - origin[2],
                            s) * jnp.asarray(jpg._mp_scale())
    assert tpg.mporder == 4 and float(mpc[0]) < 0.0
    assert_close(tpg.mp_coeffs.numpy(), np.asarray(mpc), 1e-12, "mpc")
    for a, b in zip(tpg.mp_origin, origin):
        assert abs(float(a) - float(b)) <= 1e-12 * 16.0
    jpg._multipole_setup(ju)
    for lev, (got, ref) in enumerate(zip(tpg._mp, jpg._mp)):
        assert sorted(got) == sorted(ref)
        for key in ref:
            assert_close(got[key].numpy(), np.asarray(ref[key]), 1e-12,
                         f"phi_mp level {lev} {key}")


def _read_bin(path):
    """(header text up to the cell data, the rest)."""
    data = open(path, "rb").read()
    i = data.index(b"header offset=")
    j = data.index(b"\n", i)
    off = int(data[i + len(b"header offset="):j])
    return data[:j + 1 + off], data[j + 1 + off:]


@pytest.mark.parametrize("variable", ["mhd_w", "mhd_bcc", "grav_phi"])
def test_gravity_bin_outputs(be_mhd, jeans2, variable, tmp_path):
    """The port's and the JAX package's writers on the port's final state
    of be_collapse_mhd (``mhd_w``, ``mhd_bcc``) and of the Jeans deck with
    its FFT solve (``grav_phi``)."""
    from athenak_tpu import outputs as jax_outputs
    from athenak_tpu_torch import outputs as torch_outputs
    pair = jeans2 if variable == "grav_phi" else be_mhd
    for pin in (pair.port_pin, pair.jax_pin):
        pin.set_value("output7", "file_type", "bin")
        pin.set_value("output7", "variable", variable)
    st = pair.state
    tst = {k: (torch.as_tensor(v) if not isinstance(v, dict) else
               {c: torch.as_tensor(a) for c, a in v.items()})
           for k, v in st.items()}
    jst = jax.tree_util.tree_map(jnp.asarray, st)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        torch_outputs.BinaryOutput(pair.port_pin, pair.mesh, pair.phys,
                                   "output7").write(pair.mesh, tst)
        pair.jax_mesh.time, pair.jax_mesh.ncycle = pair.mesh.time, NCYC
        os.makedirs("jax")
        os.chdir("jax")
        jax_outputs.BinaryOutput(pair.jax_pin, pair.jax_mesh, pair.jax_phys,
                                 "output7").write(
            pair.jax_mesh, jst["u"], jst["w"], bcc=jst.get("bcc"),
            state=jst)
    finally:
        os.chdir(cwd)
    name = [f for f in os.listdir(tmp_path) if f.endswith(".bin")][0]
    th, td = _read_bin(tmp_path / name)
    jh, jd = _read_bin(tmp_path / "jax" / name)
    # the time and cycle lines and the variables (the parameter dumps
    # differ in the JAX-only mesh keys)
    pre = [ln for ln in th.split(b"header offset=")[0].splitlines()
           if not ln.startswith((b"  time=", b"  cycle="))]
    assert pre == [ln for ln in jh.split(b"header offset=")[0].splitlines()
                   if not ln.startswith((b"  time=", b"  cycle="))]
    if variable != "grav_phi":
        assert td == jd
        return
    # the JAX package's grav_phi has the per-block records and no cells;
    # the port's cells are the JAX package's solve on the state
    mbi = pair.mesh.mb_indcs
    nmb = pair.mesh.nmb_total
    rec = 6 * 4 + 4 * 4 + 6 * 8
    ncell = mbi.nx1 * mbi.nx2 * mbi.nx3
    assert len(jd) == nmb * rec and len(td) == nmb * (rec + 8 * ncell)
    phi = np.asarray(pair.jax_phys.pgrav.solve(jst["u"],
                                               pair.jax_phys.bvals))
    for g in range(nmb):
        blk = td[g * (rec + 8 * ncell):(g + 1) * (rec + 8 * ncell)]
        assert blk[:rec] == jd[g * rec:(g + 1) * rec]
        cells = np.frombuffer(blk[rec:], dtype=np.float64)
        ref = phi[g, 0, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                  mbi.is_:mbi.ie + 1].ravel()
        assert_close(cells, ref, 1e-12, f"phi block {g}",
                     scale=float(np.abs(phi).max()))


def test_gravity_restart_is_bitwise(tmp_path, monkeypatch):
    """be_collapse_mhd at 16^3 / 4^3: four cycles straight against two, a
    ``.rst``, then ``-r`` and two more; u, the face field and phi
    bitwise equal."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    deck = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), BE_MHD)
    common = BE_CUT + ["output4/dcycle=2", "output1/dt=100",
                       "output2/dt=100", "output3/dt=100"]
    cwd = os.getcwd()
    try:
        _, _, _, s1 = torch_main.cli(["-i", deck, "-d",
                                      str(tmp_path / "straight"), *common,
                                      "time/nlim=4"])
        os.chdir(cwd)
        torch_main.cli(["-i", deck, "-d", str(tmp_path / "first"), *common,
                        "time/nlim=2"])
        os.chdir(cwd)
        rst = str(tmp_path / "first" / "be_collapse.00001.rst")
        from athenak_tpu_torch.outputs import load_restart
        stored = load_restart(rst)[4]
        assert "phi" in stored and np.abs(stored["phi"]).max() > 0.0
        m2, _, _, s2 = torch_main.cli(["-r", rst, "-d",
                                       str(tmp_path / "first"),
                                       "time/nlim=4"])
    finally:
        os.chdir(cwd)
    assert m2.ncycle == 4
    assert torch.equal(s1["u"], s2["u"]) and torch.equal(s1["phi"],
                                                         s2["phi"])
    for c in s1["bfc"]:
        assert torch.equal(s1["bfc"][c], s2["bfc"][c])
