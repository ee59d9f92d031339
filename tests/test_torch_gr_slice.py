"""The GR slice of the port against the JAX package, float64 on the CPU.

Decks through the port's ``main.run`` and the JAX package's jitted stage
(``torch_deck_parity.DeckPair``): the Bondi accretion deck of
``tests/test_gr_bondi.py`` at 16^3 in GR hydro and in GR MHD, the FM
torus of ``tests/test_gr_torus.py`` (32 x 32 x 16, FOFC) in hydro and
with the SANE loop and the pressure perturbations in MHD, the split
monopole of ``tests/test_gr_monopole.py`` cut to 16 x 16 x 8 in four
blocks of 8^3, and the two-level static-refinement Bondi deck of
``tests/test_smr.py`` cut to a 16^3 root of 8^3 blocks with one block
refined.  Each checks the problem generator's initial state to 1e-12,
the initialised state to 1e-12 and three cycles (two on the refined
mesh) to 1e-10: u and the face field of the interior to that fraction of
their scale, the time, and the primitives through their conserved image
(the JAX package's p2c of both packages' w, to u's scale).  The
primitives are compared through p2c because the GR c2p is
ill-conditioned in the near-vacuum atmospheres and the magnetically
dominated monopole: there one unit in the last place of u moves the
velocities by up to 1e-7 of their scale (ROADMAP Queue 3, F12).

The magnetised torus and the monopole are symmetric about faces of the
grid (z = 0, and x = 0, y = 0), where a zero mass flux's rounding noise
picks the GS07 upwind branch of the corner EMFs (ROADMAP F4): their
domains are moved by 0.3 of a cell, as in ``test_torch_amr_mhd.py``.

The files: the Bondi ``-errs.dat`` rows of both packages to their
printed precision, the monopole ``-diag.dat`` of the JAX package's
``final`` on the port's state as the port writes it, the torus history
(the flux-sphere columns every cycle) against the JAX package's hook on
the same state to 1e-12.  Restarts: Bondi (the user boundary enrolled
again) and the magnetised torus (its ``hst`` rows) 4 cycles straight
against 2 + ``-r`` 2, bitwise.
"""

import glob
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch import outputs as torch_outputs  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (DeckPair, assert_close,  # noqa: E402
                               assert_states_close, deck_text, interior)

BONDI = """
<job>
basename = gr_bondi

<mesh>
nghost = 2
nx1 = 16
x1min = -10.0
x1max = 10.0
ix1_bc = user
ox1_bc = user
nx2 = 16
x2min = -10.0
x2max = 10.0
ix2_bc = user
ox2_bc = user
nx3 = 16
x3min = -10.0
x3max = 10.0
ix3_bc = user
ox3_bc = user

<coord>
general_rel = true
a = 0.0
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-12

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 3.0

<{phys}>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.3333333333333

<problem>
pgen_name = gr_bondi
k_adi = 1.0
r_crit = 8.0
"""

TORUS = """
<job>
basename = torus

<mesh>
nghost = 2
nx1 = 32
x1min = -20.0
x1max = 20.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 32
x2min = -20.0
x2max = 20.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 16
x3min = -10.0
x3max = 10.0
ix3_bc = outflow
ox3_bc = outflow

<coord>
general_rel = true
a = 0.0
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-10

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 5.0

<{phys}>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.4444444444444444
fofc = true

<problem>
pgen_name = gr_torus
r_edge = 6.0
r_peak = 12.0
{extra}

<output1>
file_type = hst
dcycle = 1
data_format = %.17e
"""

MONOPOLE = """
<job>
basename = monopole

<mesh>
nghost = 2
nx1 = 16
x1min = -6.0
x1max = 6.0
ix1_bc = diode
ox1_bc = diode
nx2 = 16
x2min = -6.0
x2max = 6.0
ix2_bc = diode
ox2_bc = diode
nx3 = 8
x3min = 0.0
x3max = 6.0
ix3_bc = diode
ox3_bc = diode

<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<coord>
general_rel = true
a = 0.5
excise = true
dexcise = 1.0e-4
pexcise = 0.333e-6

<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
nlim = -1
tlim = 4.0

<mhd>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.3333333333333
dfloor = 1.0e-6
pfloor = 0.333e-8
fofc = true
gamma_max = 10.0

<problem>
pgen_name = gr_monopole
nlevel = 5
sigma_norm = 5000.0
rhomin = 1.0e-6
umin = 1.0e-8
a_norm = 1.0
"""

SMR = """
<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8

<mesh_refinement>
refinement = static

<refined_region1>
level = 1
x1min = 0.5
x1max = 5.0
x2min = 0.5
x2max = 5.0
x3min = 0.5
x3max = 5.0
"""


def shift(cells, los, his):
    """mesh/x*min and x*max moved by 0.3 of a cell on each axis."""
    out = []
    for ax, n, lo, hi in zip((1, 2, 3), cells, los, his):
        q = 0.3 * (hi - lo) / n
        out += [f"mesh/x{ax}min={lo + q}", f"mesh/x{ax}max={hi + q}"]
    return out


MAG_TORUS = "b_norm = 0.1\npotential_cutoff = 0.2\npert_amp = 0.02"
DECKS = {
    "bondi": (BONDI.format(phys="hydro"), [], 3),
    "bondi_mhd": (BONDI.format(phys="mhd"), [], 3),
    "torus": (TORUS.format(phys="hydro", extra=""), [], 3),
    "torus_mhd": (TORUS.format(phys="mhd", extra=MAG_TORUS),
                  shift((32, 32, 16), (-20, -20, -10), (20, 20, 10)), 3),
    "monopole": (MONOPOLE, shift((16, 16, 8), (-6, -6, 0), (6, 6, 6)), 3),
    "bondi_smr": (BONDI.format(phys="hydro") + SMR, [], 2),
}
_PAIRS = {}


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    return tmp_path_factory.mktemp("gr")


def pair(name, rundir):
    if name not in _PAIRS:
        text, over, ncyc = DECKS[name]
        _PAIRS[name] = DeckPair(text, over, ncyc=ncyc,
                                rundir=str(rundir / name))
    return _PAIRS[name]


def _image(phys, w, bcc):
    """The JAX package's p2c of host primitives."""
    if phys.is_mhd:
        return np.asarray(phys.prim_to_cons(jnp.asarray(w),
                                            jnp.asarray(bcc)))
    return np.asarray(phys.prim_to_cons(jnp.asarray(w)))


def assert_gr_states_close(p, got, ref, tol, ng=2, field_tol=None):
    """u and the face field to ``tol`` (the field to ``field_tol`` if
    given) of their scale, and w through its conserved image (both with
    the reference's bcc) to u's scale."""
    assert_close(interior(got["u"], ng), interior(ref["u"], ng), tol, "u")
    if "bfc" in ref:
        bmax = max(float(np.abs(v).max()) for v in ref["bfc"].values())
        for c, v in ref["bfc"].items():
            assert_close(interior(got["bfc"][c], ng), interior(v, ng),
                         field_tol or tol, c, scale=bmax)
    bcc = ref.get("bcc")
    assert_close(interior(_image(p.jax_phys, got["w"], bcc), ng),
                 interior(_image(p.jax_phys, ref["w"], bcc), ng), tol,
                 "w (p2c)", scale=float(np.abs(interior(ref["u"], ng)).max()))


def _field_floor(name, p):
    """The face field's rounding floor of a deck: twice the gap (of the
    field's scale) between the port's run and the port's run from u
    changed by 4e-16 of itself (two units in the last place).  In the
    magnetised torus the weak loop (0.4 % of u's scale) takes the
    rounding of u into its fluxes and EMFs: after three cycles this gap
    is some 3e-9, and the gap to the JAX package sits at it (ROADMAP
    F12)."""
    from athenak_tpu_torch.athinput import ParameterInput
    text, over, ncyc = DECKS[name]
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(over + [f"time/nlim={ncyc}"])
    _, _, _, driver, st = torch_main.build(pin, device="cpu")
    st["u"] = st["u"] * (1.0 + 4.0e-16)
    st = driver.execute(driver.initialize(st))
    got = state_to_numpy(st)["bfc"]
    ref = p.state["bfc"]
    bmax = max(float(np.abs(v).max()) for v in ref.values())
    gap = max(float(np.abs(interior(got[c]) - interior(ref[c])).max())
              for c in ref) / bmax
    assert 0.0 < gap < 1e-7
    return 2.0 * gap


@pytest.mark.parametrize("name", sorted(DECKS))
def test_deck_matches_jax(name, rundir):
    p = pair(name, rundir)
    ng = 2
    assert p.mesh.ncycle == p.ncyc
    assert_states_close(p.port_init, p.jax_init, 1e-12, ng)
    assert_gr_states_close(p, p.port_ready, p.jax_ready, 1e-12, ng)
    field_tol = _field_floor(name, p) if name == "torus_mhd" else None
    assert_gr_states_close(p, p.state, p.jax_state, 1e-10, ng,
                           field_tol=field_tol)
    np.testing.assert_allclose(p.mesh.time, p.jax_time, rtol=1e-10)
    for k in ("u", "w"):
        assert np.isfinite(p.state[k]).all()
    assert p.phys.is_gr and p.phys.geom is not None
    assert p.mesh.multilevel == (name == "bondi_smr")
    # the flow moved, and no kernel launched
    assert np.abs(p.state["u"] - p.port_ready["u"]).max() > 0.0
    assert all(k.launches == 0 for k in kernels.ALL)
    if "bfc" in p.state:
        mbi = p.mesh.mb_indcs
        b = p.state["bfc"]
        act = (slice(None), slice(mbi.ks, mbi.ke + 1),
               slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
        ms = p.mesh.mesh_size
        div = ((b["x1f"][..., 1:] - b["x1f"][..., :-1])[act] / ms.dx1
               + (b["x2f"][..., 1:, :] - b["x2f"][..., :-1, :])[act]
               / ms.dx2
               + (b["x3f"][:, 1:] - b["x3f"][:, :-1])[act] / ms.dx3)
        bmax = max(np.abs(v).max() for v in b.values())
        assert np.abs(div).max() <= 1e-12 * bmax / ms.dx1


@pytest.mark.parametrize("name", ["bondi", "bondi_mhd"])
def test_bondi_error_file(name, rundir, tmp_path):
    """The port's ``-errs.dat`` row and the JAX package's from its own
    state: the same header, sizes and cycles, each error to its printed
    precision."""
    p = pair(name, rundir)
    p.jax_final(str(tmp_path))
    g = (rundir / name / "gr_bondi-errs.dat").read_text().splitlines()
    r = (tmp_path / "gr_bondi-errs.dat").read_text().splitlines()
    assert len(g) == len(r) == 2 and g[0] == r[0]
    gt, rt = g[1].split(), r[1].split()
    assert gt[:4] == rt[:4] == ["0016", "0016", "0016", "00003"]
    np.testing.assert_allclose([float(x) for x in gt[4:]],
                               [float(x) for x in rt[4:]], rtol=2e-6)


def test_monopole_diag_file(rundir, tmp_path):
    """The port's ``-diag.dat`` and the JAX package's ``final`` on the
    port's final state: the same text."""
    p = pair("monopole", rundir)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        st = jax.tree_util.tree_map(jnp.asarray, p.state)
        p.jax_pgen.final(p.jax_pin, p.jax_mesh, p.jax_phys, st)
    finally:
        os.chdir(cwd)
    got = (rundir / "monopole" / "monopole-diag.dat").read_text()
    ref = (tmp_path / "monopole-diag.dat").read_text()
    assert got == ref
    rows = np.loadtxt(str(rundir / "monopole" / "monopole-diag.dat"))
    assert len(rows) > 100 and np.isfinite(rows).all()


@pytest.mark.parametrize("name", ["torus", "torus_mhd"])
def test_torus_history(name, rundir):
    """A history row at t = 0 and one a cycle with the flux-sphere
    columns; the last row's columns are the JAX package's hook on the
    port's final state, to 1e-12 of each column's scale."""
    p = pair(name, rundir)
    lines = (rundir / name / "torus.hst").read_text().splitlines()
    rows = np.array([[float(x) for x in ln.split()] for ln in lines[2:]])
    assert rows.shape[0] == p.ncyc + 2       # t = 0, each cycle, the end
    head = lines[1]
    labels, vals = p.jax_phys.user_hist_func(
        p.jax_mesh, jax.tree_util.tree_map(jnp.asarray, p.state))
    assert labels[0].startswith("mdot_")
    for lab in labels:
        assert lab[:10] in head
    got = rows[-1, -len(vals):]
    np.testing.assert_allclose(got, vals, rtol=1e-12,
                               atol=1e-12 * np.abs(vals).max())
    assert np.isfinite(rows).all()
    assert len(vals) == (4 if p.phys.is_mhd else 3)   # the horizon, r = 2


# ------------------------------------------------------------ restarts
def _port_cli(rundir, args):
    cwd = os.getcwd()
    os.makedirs(rundir, exist_ok=True)
    os.chdir(rundir)
    try:
        return torch_main.cli(list(args))
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("name", ["bondi", "torus_mhd"])
def test_restart_is_bitwise(name, tmp_path, monkeypatch):
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    text, over, _ = DECKS[name]
    deck = tmp_path / "deck.athinput"
    deck.write_text(text)
    base = "gr_bondi" if name == "bondi" else "torus"
    common = ["-i", str(deck), *over, "output9/file_type=rst",
              "output9/dcycle=2"]
    if name == "torus_mhd":
        common += ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=8"]
    m1, p1, _, s1 = _port_cli(str(tmp_path / "straight"),
                              common + ["time/nlim=4"])
    _port_cli(str(tmp_path / "first"), common + ["time/nlim=2"])
    rst = sorted(glob.glob(str(tmp_path / "first" / f"{base}.*.rst")))
    t_rst = torch_outputs.load_restart(rst[1])[1]
    m2, p2, _, s2 = _port_cli(str(tmp_path / "first"),
                              ["-r", rst[1], "time/nlim=4"])
    assert m1.ncycle == m2.ncycle == 4 and m1.time == m2.time
    assert p2.bvals.user_bc_func is not None if name == "bondi" else True
    a, b = state_to_numpy(s1), state_to_numpy(s2)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            for c in a[k]:
                np.testing.assert_array_equal(b[k][c], a[k][c], err_msg=c)
        else:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    if name == "torus_mhd":
        rows = [[r for r in (tmp_path / run / "torus.hst").read_text()
                 .splitlines()[2:] if float(r.split()[0]) > t_rst]
                for run in ("straight", "first")]
        assert rows[0] and rows[1] == rows[0]
