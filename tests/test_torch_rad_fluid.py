"""The port's radiation coupled to a GR fluid, held against the JAX
package on the CPU (float64): the quartic root (ROADMAP F23), the
implicit coupling on random states (flat and Kerr, gray, Compton and
power-law opacities), three cycles of the coupled decks (relax with and
without Compton and moving, the shadow, the radiating linear wave along
x1 and oblique, the diffusing pulse, the linear wave of
tests/test_rad_gr.py), its adaptive run with the rad_coord_e criterion,
a restart, the fluid-frame outputs, and the fill kernels' launches on
the radiation path.

Tolerances: 1e-12 of the scale for the components (the quartic root to
F23's limit), 1e-10 for the decks.  The oblique wave is cut to 8 x 4 x 4
cells.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenak_tpu import main as jax_main
from athenak_tpu.athinput import ParameterInput as JaxInput
from athenak_tpu_torch import main as torch_main
from athenak_tpu_torch.athinput import ParameterInput
from torch_deck_parity import (JAX_EXTRA, AmrPair, DeckPair, assert_close,
                               assert_states_close, check_pair,
                               deck_literal, deck_text, interior,
                               read_bin)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = float(np.finfo(np.float64).eps)


RELAX = deck_text("inputs/radiation/relax.athinput")
LINWAVE = deck_text("inputs/tests/rad_linwave.athinput")
SHADOW = deck_text("inputs/radiation/shadow.athinput")
DIFF = deck_literal("test_radiation.py", "DIFF_DECK").format(tlim=1.0)
LWAVE = deck_literal("test_rad_gr.py", "RAD_LWAVE_DECK")
AMR_BLOCK = ("\n<mesh_refinement>\nrefinement = adaptive\nnum_levels = 2\n"
             "ncycle_check = 2\nrefinement_interval = 2\n"
             "<amr_criterion1>\nmethod = min_max\nvariable = {var}\n"
             "value_max = {vmax}\n")
UNITS = "\n<units>\ndensity_cgs = 1.0\nbhmass_msun = 1.0\nmu = 5.486e-5\n"


def compton_deck():
    """tests/test_radiation.py's Compton relaxation deck: pure scattering
    with the thermal Compton exchange, units on."""
    deck = deck_literal("test_radiation.py", "RELAX_DECK")
    deck = deck.replace("kappa_a = 1.0", "kappa_a = 0.0") \
               .replace("kappa_s = 0.0", "kappa_s = 2.0") \
               .replace("temp = 100.0", "temp = 10.0") \
               .replace("cfl_number = 0.3", "cfl_number = 0.1") \
               .replace("tlim = 10.0", "tlim = 6.0")
    return deck.replace("<problem>", UNITS + "\n<problem>")


# ---------------------------------------------------------------------------
# the quartic root
# ---------------------------------------------------------------------------
def test_fourth_poly_root_within_f23():
    """fourth_poly_root on 60,000 draws of coef4 in [1e-12, 1e12] and
    tconst in [-1e6, -1e-6] against the JAX package's (ROADMAP F23).  The
    root subtracts nearly equal numbers twice: two cube roots where
    delta1 is large, and 0.5 (sqrt(delta2) - rcoef) where coef4 |tconst|^3
    is small; an ulp grows by K = max(delta1, 1 / (coef4 |tconst|^3))^(2/3).
    Where delta1 <= 1e3 or delta1 > 1e11 (no cube roots) and coef4
    |tconst|^3 >= 1e-6 the roots agree to 1e-10 of |tconst|; elsewhere
    the port's root satisfies the quartic to a relative residual of at
    most 1.01 max(JAX's residual, 1e4 eps K).  ``ok`` is equal where
    JAX's root is not round-off zero."""
    from athenak_tpu.radiation.coupling import fourth_poly_root as jroot
    from athenak_tpu_torch.radiation.coupling import fourth_poly_root
    rng = np.random.default_rng(3)
    n = 60000
    c4 = 10.0 ** rng.uniform(-12.0, 12.0, n)
    t = -10.0 ** rng.uniform(-6.0, 6.0, n)
    d1 = np.sqrt(np.maximum(0.25 - 64.0 * t ** 3 * c4 / 27.0, 0.0))
    ct3 = c4 * np.abs(t) ** 3
    xj, okj = (np.asarray(a) for a in jroot(jnp.asarray(c4),
                                            jnp.asarray(t)))
    xt, okt = (a.numpy() for a in fourth_poly_root(torch.tensor(c4),
                                                   torch.tensor(t)))
    real = np.abs(xj) > 4.0 * EPS * np.abs(t)
    assert np.array_equal(okj[real], okt[real])
    ok = okj & okt
    tight = ok & ((d1 <= 1e3) | (d1 > 1e11)) & (ct3 >= 1e-6)
    assert tight.sum() > 15000
    assert (np.abs(xt - xj)[tight] <= 1e-10 * np.abs(t)[tight]).all()

    def residual(x):
        return np.abs(c4 * x ** 4 + x + t) / (c4 * x ** 4 + np.abs(x)
                                              + np.abs(t))

    loose = ok & ~tight
    assert loose.sum() > 15000
    kk = np.maximum(d1, 1.0 / ct3) ** (2.0 / 3.0)
    bound = 1.01 * np.maximum(residual(xj), 1e4 * EPS * kk)
    assert (residual(xt)[loose] <= bound[loose]).all()


# ---------------------------------------------------------------------------
# the coupling on random states
# ---------------------------------------------------------------------------
KERR = """
<job>
basename = kerr_rad
<mesh>
nghost = 2
nx1 = 8
x1min = 2.0
x1max = 6.0
nx2 = 8
x2min = -2.0
x2max = 2.0
nx3 = 4
x3min = -1.0
x3max = 1.0
<coord>
general_rel = true
a = 0.7
excise = false
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0
<hydro>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlle
<radiation>
nlevel = 2
kappa_a = 3.0
kappa_s = 2.0
kappa_p = 0.5
<problem>
pgen_name = rad_relax
erad = 1.0
temp = 1.0
"""

COUPLINGS = {"flat": "rad_linwave_oblique", "compton": "relax_compton",
             "power": "shadow", "kerr": None}


@pytest.mark.parametrize("name", sorted(COUPLINGS))
def test_coupling_matches_jax(pairs, name):
    """rad_fluid_coupling on a random state (seeded: the intensities 0.5-2
    of their n^0 n_0 scale, rho, the internal energy and the velocities
    perturbed), the new intensities and the fluid's u on the interior
    (the caller refills the ghosts; the shadow's inflow ghosts hold
    T ~ 1e-38, where 1 - suma1 cancels to round-off, F23) to 1e-12 of
    their scales, with and without the feedback on the fluid: on the oblique
    wave's flat 3-D mesh with scattering and kappa_p added, the Compton
    relaxation, the shadow's power-law opacity, and a spin-0.7 Kerr
    deck."""
    from athenak_tpu.radiation.coupling import rad_fluid_coupling as jcpl
    from athenak_tpu_torch.radiation.coupling import rad_fluid_coupling
    if COUPLINGS[name] is None:
        pj = JaxInput.from_string(KERR)
        pj.modify_from_cmdline(JAX_EXTRA)
        _, jp, _, _, js = jax_main.build(pj)
        _, tp, _, _, _ = torch_main.build(ParameterInput.from_string(KERR),
                                          device="cpu")
        w = np.array(js["w"])
    else:
        pair = pairs[COUPLINGS[name]]
        jp, tp, w = pair.jax_phys, pair.phys, np.array(pair.jax_ready["w"])
    saved = [(r, r.kappa_s, r.kappa_p) for r in (jp.rad, tp.rad)]
    if name == "flat":
        for r in (jp.rad, tp.rad):
            r.kappa_s, r.kappa_p = 2.0, 0.5
    rng = np.random.default_rng(17)
    w[:, 0] *= rng.uniform(0.5, 2.0, w[:, 0].shape)
    w[:, 4] *= rng.uniform(0.5, 2.0, w[:, 4].shape)
    w[:, 1:4] += rng.uniform(-0.3, 0.3, w[:, 1:4].shape)
    u = np.asarray(jp.prim_to_cons(jnp.asarray(w)))
    nn = np.broadcast_to(tp.rad.n0.numpy() * tp.rad.n_0.numpy(),
                         tp.rad.shape)
    i0 = nn * rng.uniform(0.5, 2.0, tp.rad.shape)
    gm1 = tp.eos.gamma - 1.0
    try:
        for affect in (True, False):
            ji, ju = jcpl(jp.rad, jnp.asarray(i0), jnp.asarray(u),
                          jnp.asarray(w), gm1, 0.05, affect_fluid=affect)
            ti, tu = rad_fluid_coupling(
                tp.rad, torch.tensor(i0), torch.tensor(u), torch.tensor(w),
                gm1, 0.05, affect_fluid=affect)
            assert_close(interior(ti.numpy()), interior(np.asarray(ji)),
                         1e-12, f"i0 {affect}")
            assert_close(interior(tu.numpy()), interior(np.asarray(ju)),
                         1e-12, f"u {affect}")
            assert not np.array_equal(np.asarray(ji), i0)
    finally:
        for r, ks, kp in saved:
            r.kappa_s, r.kappa_p = ks, kp


# ---------------------------------------------------------------------------
# decks
# ---------------------------------------------------------------------------
DECKS = {"relax": (RELAX, []),
         "relax_compton": (compton_deck(), ["radiation/compton=true"]),
         "relax_moving": (RELAX, ["problem/v1=0.3"]),
         "shadow": (SHADOW, []),
         "rad_linwave": (LINWAVE, []),
         "rad_linwave_oblique": (LINWAVE, [
             "mesh/nx1=8", "mesh/nx2=4", "mesh/nx3=4",
             "problem/along_x1=false"]),
         "diffusion": (DIFF, []),
         "lwave_test": (LWAVE, [])}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    return {name: DeckPair(text, over, ncyc=3,
                           rundir=str(tmp_path_factory.mktemp(name)))
            for name, (text, over) in DECKS.items()}


@pytest.mark.parametrize("name", sorted(DECKS))
def test_coupled_deck_three_cycles(pairs, name):
    """Three RK2 cycles of each coupled deck through ``main.run``: u, w
    and i0 with their ghosts and the time to 1e-10, the generator's state
    to 1e-12."""
    pair = pairs[name]
    check_pair(pair, ng=pair.mesh.mb_indcs.ng)
    assert_states_close(pair.port_init, pair.jax_init, 1e-12,
                        pair.mesh.mb_indcs.ng, keys=("i0",))
    for key in ("u", "w", "i0"):
        assert np.isfinite(pair.jax_state[key]).all()
        assert_close(pair.state[key], pair.jax_state[key], 1e-10,
                     f"{key} with ghosts")
    assert not np.array_equal(interior(pair.state["i0"]),
                              interior(pair.port_init["i0"]))


def test_port_stage_from_the_jax_state(pairs):
    """``state.state_from_numpy`` carries the JAX package's initialised
    coupled state (u, w, i0) into the port, and one port stage from it
    equals the JAX stage to 1e-12."""
    from athenak_tpu_torch.state import state_from_numpy
    from torch_deck_parity import jit_o0
    pair = pairs["rad_linwave"]
    st = state_from_numpy(pair.jax_ready, "cpu", torch.float64)
    assert {"u", "w", "i0"} <= set(st)
    dt = pair.jax_dts[0]
    out, _ = pair.phys.stage_update(st, pair.phys.save_state(st), 0.0, 1.0,
                                    dt)
    js = jax.tree_util.tree_map(jnp.asarray, pair.jax_ready)
    jout = jit_o0(lambda s, sv: pair.jax_phys.stage_update(
        s, sv, 0.0, 1.0, dt)[0])(js, pair.jax_phys.save_state(js))
    for k in ("u", "w", "i0"):
        assert_close(out[k].numpy(), np.asarray(jout[k]), 1e-12, k)


def test_linwave_final_errors(pairs, tmp_path):
    """The linear wave's error file (``final``) after the three cycles
    equals the JAX package's: the sizes and cycle exactly, each error to
    1e-10 of the RMS error."""
    pair = pairs["rad_linwave"]
    pair.jax_mesh.time = pair.jax_time
    pair.jax_final(str(tmp_path))
    jax_row = np.loadtxt(tmp_path / "rad_linwave-errs.dat")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        os.rename("rad_linwave-errs.dat", "jax-errs.dat")
        from athenak_tpu_torch.pgen import rad_linear_wave
        rad_linear_wave.final(pair.port_pin, pair.mesh, pair.phys,
                              {k: torch.as_tensor(v)
                               for k, v in pair.state.items()})
        row = np.loadtxt("rad_linwave-errs.dat")
    finally:
        os.chdir(cwd)
    assert row[:4].tolist() == jax_row[:4].tolist()
    # each L1 error to 1e-10 of the RMS error (M2 and M3 are round-off)
    np.testing.assert_allclose(row[4:], jax_row[4:], rtol=1e-10,
                               atol=1e-10 * jax_row[4])


def test_lwave_amr_matches_jax(tmp_path):
    """tests/test_rad_gr.py's adaptive linear wave (a check every two
    cycles) refined on the radiation energy density R^00 (rad_coord_e):
    the same trees at the same cycles, i0 remapped and the state to
    1e-12.  The JAX package's criterion keeps the first tree's tables
    and fails at the check after its first tree update (ROADMAP F25), so
    the pair runs three cycles (the blocks on the crest refine at cycle
    2) and the port alone runs on to ten, checking the refined tree
    every two cycles."""
    text = LWAVE + AMR_BLOCK.format(var="rad_coord_e", vmax=0.07494)
    pair = AmrPair(text, ["time/nlim=3"], rundir=str(tmp_path))
    pair.check(tol=1e-12, ng=4)
    assert pair.driver.pamr.nmb_created > 0
    assert_close(interior(pair.state["i0"], 4),
                 interior(pair.jax_state["i0"], 4), 1e-12, "i0")
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(["time/nlim=10"])
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        mesh, _, driver, state = torch_main.run(pin, device="cpu")
    finally:
        os.chdir(cwd)
    assert mesh.ncycle == 10 and driver.pamr.updates
    assert torch.isfinite(state["i0"]).all()


def test_relax_restart_is_bitwise(tmp_path, monkeypatch):
    """The linear wave: six cycles straight against three, a ``.rst``,
    then ``-r`` and three more; u, w and i0 bitwise equal."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    deck = tmp_path / "lw.athinput"
    deck.write_text(LINWAVE + "\n<output9>\nfile_type = rst\ndcycle = 3\n")
    cwd = os.getcwd()
    try:
        _, _, _, s1 = torch_main.cli(["-i", str(deck), "-d",
                                      str(tmp_path / "straight"),
                                      "time/nlim=6"])
        os.chdir(cwd)
        torch_main.cli(["-i", str(deck), "-d", str(tmp_path / "first"),
                        "time/nlim=3"])
        os.chdir(cwd)
        rst = str(tmp_path / "first" / "rad_linwave.00001.rst")
        from athenak_tpu_torch.outputs import load_restart
        assert "i0" in load_restart(rst)[4]
        m2, _, _, s2 = torch_main.cli(["-r", rst, "-d",
                                       str(tmp_path / "first"),
                                       "time/nlim=6"])
    finally:
        os.chdir(cwd)
    assert m2.ncycle == 6
    for k in ("u", "w", "i0"):
        assert torch.equal(s1[k], s2[k]), k


@pytest.mark.parametrize("variable", ["rad_coord_fluid", "rad_hydro_w"])
def test_coupled_bin_outputs_match_jax(pairs, variable, tmp_path):
    """The moving relax deck's final state through both packages' ``bin``
    writers: the coordinate and fluid-frame moments (20 channels) and the
    ``rad_hydro_`` prefix, headers and block records equal, the cells to
    1e-12."""
    from athenak_tpu import outputs as jax_outputs
    from athenak_tpu_torch import outputs as torch_outputs
    pair = pairs["relax_moving"]
    for pin in (pair.port_pin, pair.jax_pin):
        pin.set_value("output7", "file_type", "bin")
        pin.set_value("output7", "variable", variable)
    tst = {k: torch.as_tensor(v) for k, v in pair.state.items()}
    jst = jax.tree_util.tree_map(jnp.asarray, pair.state)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        torch_outputs.BinaryOutput(pair.port_pin, pair.mesh, pair.phys,
                                   "output7").write(pair.mesh, tst)
        pair.jax_mesh.time, pair.jax_mesh.ncycle = pair.mesh.time, 3
        os.makedirs("jax")
        os.chdir("jax")
        jax_outputs.BinaryOutput(pair.jax_pin, pair.jax_mesh, pair.jax_phys,
                                 "output7").write(
            pair.jax_mesh, jst["u"], jst["w"], state=jst)
    finally:
        os.chdir(cwd)
    name = [f for f in os.listdir(tmp_path) if f.endswith(".bin")][0]
    th, td = read_bin(tmp_path / name)
    jh, jd = read_bin(tmp_path / "jax" / name)
    pre = [ln for ln in th.split(b"header offset=")[0].splitlines()
           if not ln.startswith((b"  time=", b"  cycle="))]
    assert pre == [ln for ln in jh.split(b"header offset=")[0].splitlines()
                   if not ln.startswith((b"  time=", b"  cycle="))]
    mbi = pair.mesh.mb_indcs
    nvar = 20 if variable == "rad_coord_fluid" else 5
    rec = 6 * 4 + 4 * 4 + 6 * 8
    size = rec + 8 * nvar * mbi.nx1 * mbi.nx2 * mbi.nx3
    assert len(td) == len(jd) == pair.mesh.nmb_total * size
    for g in range(pair.mesh.nmb_total):
        blk, jblk = (d[g * size:(g + 1) * size] for d in (td, jd))
        assert blk[:rec] == jblk[:rec]
        assert_close(np.frombuffer(blk[rec:], dtype=np.float64),
                     np.frombuffer(jblk[rec:], dtype=np.float64), 1e-12,
                     f"{variable} block {g}")


# ---------------------------------------------------------------------------
# the CLI and the fill kernels' launches
# ---------------------------------------------------------------------------
def test_coupled_decks_through_the_cli(tmp_path, monkeypatch):
    """relax, shadow and the radiating linear wave as shipped run
    through ``main.cli`` (two cycles); the linear wave writes its error
    file."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    cwd = os.getcwd()
    try:
        for deck in ("inputs/radiation/relax.athinput",
                     "inputs/radiation/shadow.athinput",
                     "inputs/tests/rad_linwave.athinput"):
            out = tmp_path / os.path.basename(deck)
            mesh, phys, _, state = torch_main.cli(
                ["-i", os.path.join(ROOT, deck), "-d", str(out),
                 "time/nlim=2"])
            os.chdir(cwd)
            assert mesh.ncycle == 2 and torch.isfinite(state["i0"]).all()
        assert (tmp_path / "rad_linwave.athinput"
                / "rad_linwave-errs.dat").exists()
    finally:
        os.chdir(cwd)


WIDE = ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8"]
POOL = WIDE + ["meshblock/nx1=4", "meshblock/nx2=4", "meshblock/nx3=4"]


@pytest.mark.parametrize("label,extra,kernel", [
    ("rad_wide", WIDE, "periodic_fill_cc"),
    ("rad_pool", POOL, "pool_fill_cc")])
def test_fill_launches_on_the_radiation_path(label, extra, kernel,
                                             monkeypatch):
    """The 3-D periodic linear wave (RAD_WIDE and RAD_POOL cut to 8^3)
    with the fill kernels' gate opened for CPU tensors: kernel B (one
    block) or G (a pool) fills 2 + 6 n times in n RK2 cycles (u and i0
    at the start; a stage fills u in the fluid stage, u again after the
    coupling, and i0) and nothing else takes its place; the state is
    bitwise the plain path's (``hydro/use_kernels=false``)."""
    from athenak_tpu_torch import bvals
    from athenak_tpu_torch.ops import fill, pool_fill
    ncyc = 2
    monkeypatch.setattr(bvals, "kernel_dtype_ok", lambda t: True)
    calls = {"periodic_fill_cc": 0, "pool_fill_cc": 0}

    def counted(mod, fn):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[fn] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)

    counted(fill, "periodic_fill_cc")
    counted(pool_fill, "pool_fill_cc")
    states = {}
    for use in ("true", "false"):
        for k in calls:
            calls[k] = 0
        pin = ParameterInput.from_string(LINWAVE)
        pin.modify_from_cmdline(extra + [f"time/nlim={ncyc}",
                                         f"hydro/use_kernels={use}"])
        _, phys, _, states[use] = torch_main.run(pin, device="cpu")
        want = 2 + 6 * ncyc if use == "true" else 0
        assert calls == {k: (want if k == kernel else 0) for k in calls}
    for k in ("u", "w", "i0"):
        assert torch.equal(states["true"][k], states["false"][k]), k
