"""The port's radiation transport held against the JAX package on the CPU
(float64): the tetrads, the geometry tables, the transport operators and
the radiation-only decks (the hohlraum, the snake, the beam in Kerr),
the ``rad_coord`` outputs, and the fill kernels' gates on the radiation
decks.  The coupled decks are in ``test_torch_rad_fluid.py``.

Tolerances: 1e-12 of each quantity's scale for the components, 1e-10
for three cycles of a deck.  The snake deck is cut to 16 x 32 cells in
two blocks (162 angles): its JAX stage compiles the [nmb, 162, 6, ...]
table of edge speeds as a constant.
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
from torch_deck_parity import (JAX_EXTRA, DeckPair, assert_close,
                               check_pair, deck_literal, deck_text,
                               interior, read_bin)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


BEAM = deck_literal("test_rad_gr.py", "BEAM_DECK")
SNAKE = "inputs/radiation/snake.athinput"
SNAKE_CUT = ["mesh/nx1=16", "mesh/nx2=32", "meshblock/nx1=16",
             "meshblock/nx2=16"]
HOHLRAUM = "inputs/radiation/hohlraum_1d.athinput"
ANGULAR = """
<job>
basename = angtest
<mesh>
nghost = 2
nx1 = 8
x1min = 2.0
x1max = 6.0
nx2 = 8
x2min = -2.0
x2max = 2.0
nx3 = 8
x3min = -2.0
x3max = 2.0
<coord>
general_rel = true
a = 0.5
excise = false
<radiation>
nlevel = 2
angular_fluxes = true
<time>
evolution = dynamic
tlim = 1.0
"""


def _close(got, ref, tol, label):
    assert_close(torch.as_tensor(got).numpy() if torch.is_tensor(got)
                 else got, np.asarray(ref), tol, label)


def _both(text, overrides=()):
    """Both packages' (mesh, physics, state) of a deck after its problem
    generator, the port on the CPU."""
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + list(overrides))
    jm, jp, _, _, js = jax_main.build(pj)
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(list(overrides))
    tm, tp, _, _, ts = torch_main.build(pt, device="cpu")
    return (jm, jp, js), (tm, tp, ts)


# ---------------------------------------------------------------------------
# tetrads
# ---------------------------------------------------------------------------
def _group(got, ref, tol, label):
    """Nested lists of components held together: each to ``tol`` of the
    largest entry of the group (a component that vanishes analytically
    is compared at the group's scale, not its own round-off)."""
    g = [torch.broadcast_to(torch.as_tensor(t), (200,)).numpy()
         for t in _flat(got)]
    r = [np.broadcast_to(np.asarray(a), (200,)) for a in _flat(ref)]
    scale = max(float(np.abs(a).max()) for a in r)
    for i, (a, b) in enumerate(zip(g, r)):
        assert_close(a, b, tol, f"{label} {i}", scale=scale)


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _flat(v)]
    return [x]


@pytest.mark.parametrize("spin,mink", [(0.9, False), (0.0, True)])
def test_tetrad_functions_match_jax(spin, mink):
    """tetrad, norm_to_tet, the tetrad derivatives and the Ricci rotation
    coefficients on random points (some inside r = 1, where the radius is
    clamped) to 1e-12 of each function's largest component."""
    from athenak_tpu.radiation import tetrad as jt
    from athenak_tpu_torch.radiation import tetrad as tt
    rng = np.random.default_rng(11)
    x, y, z = (rng.uniform(-6.0, 6.0, 200) for _ in range(3))
    xt, yt, zt = (torch.as_tensor(a) for a in (x, y, z))
    args = (spin, mink)
    for label, fn, jfn in (
            ("tetrad", tt.tetrad, jt.tetrad),
            ("norm_to_tet", tt.norm_to_tet, jt.norm_to_tet),
            ("tetrad_derivatives", tt.tetrad_derivatives,
             jt._tetrad_derivatives),
            ("ricci_rotation", tt.ricci_rotation, jt.ricci_rotation)):
        _group(fn(xt, yt, zt, *args), jfn(x, y, z, *args), 1e-12, label)


# ---------------------------------------------------------------------------
# geometry tables and operators
# ---------------------------------------------------------------------------
# the decks of the parity runs below, and the snake with its
# snake-aligned tetrad
DECKS = {"hohlraum_1d": (deck_text(HOHLRAUM), []),
         "snake": (deck_text(SNAKE), SNAKE_CUT),
         "beam_kerr": (BEAM, [])}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    out = {}
    for name, (text, over) in DECKS.items():
        out[name] = DeckPair(text, over, ncyc=3,
                             rundir=str(tmp_path_factory.mktemp(name)))
    return out


@pytest.fixture(scope="module", params=sorted(DECKS) + ["snake_tet"])
def built(request, pairs):
    """Both packages' (mesh, physics, generator state): a parity run's,
    or a build of the snake with ``snake_tet``."""
    if request.param == "snake_tet":
        return request.param, _both(deck_text(SNAKE), SNAKE_CUT
                                    + ["problem/snake_tet=true"])
    p = pairs[request.param]
    return request.param, ((p.jax_mesh, p.jax_phys, p.jax_init),
                           (p.mesh, p.phys, {k: torch.as_tensor(v) for k, v
                                             in p.port_init.items()}))


def test_geometry_tables_match_jax(built):
    """n^0, n_0, the face n^d, the edge speeds na, the excision mask, the
    beam table, the lazy n_mu, n^mu, covariant tetrad and
    normal-to-tetrad map, each to 1e-12 of its scale (the snake's from
    its per-cell metric through ``set_geometry``)."""
    name, ((jm, jp, js), (tm, tp, ts)) = built
    _close(tp.n0, np.broadcast_to(jp.n0, tuple(tp.n0.shape)), 1e-12, "n0")
    _close(tp.n_0, np.broadcast_to(jp.n_0, tuple(tp.n_0.shape)), 1e-12,
           "n_0")
    for d, ref in jp.nd_face.items():
        assert_close(tp.nd_face[d].numpy(), np.broadcast_to(ref, tuple(
            tp.nd_face[d].shape)), 1e-12, f"nd_face {d}", scale=1.0)
    assert tp.angular_fluxes == jp.angular_fluxes
    if jp.angular_fluxes:
        _close(tp.na, jp.na, 1e-12, "na")
        # a pentagon's padded edge has zero speed and zero arc length
        pad = np.arange(tp.na.shape[2])[None, :] >= \
            tp.grid.num_neighbors[:, None]
        assert pad.any()
        assert (tp.na.numpy()[:, pad] == 0.0).all()
        assert (tp.grid.arc_lengths[pad] == 0.0).all()
    assert (tp.excise_mask is None) == (jp.excise_mask is None)
    if jp.excise_mask is not None:
        assert np.array_equal(tp.excise_mask.numpy(), jp.excise_mask)
    if jp.beam_dii0 is not None:
        _close(tp.beam_dii0, jp.beam_dii0, 1e-12, "beam_dii0")
    n0, n_0, n_mu, n2t = tp.tet_quantities()
    _, _, jn_mu, jn2t = jp.tet_quantities()
    for label, got, ref in (("n_mu", n_mu, jn_mu),
                            ("n_up", tp._n_up, jp._n_up),
                            ("n2t", n2t, jn2t),
                            ("ecov", tp._ecov, jp._ecov)):
        got, ref = _flat(got), _flat(ref)
        scale = max(float(np.abs(np.asarray(r)).max()) for r in ref)
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_close(g.numpy(), np.broadcast_to(r, tuple(g.shape)),
                         1e-12, f"{label} {i}", scale=scale)
    assert_close(interior(ts["u"].numpy()), interior(np.asarray(js["u"])),
                 1e-12, "i0")


def _random_i0(rad, rng, lo=0.5, hi=2.0):
    nn = np.broadcast_to(rad.n0.numpy() * rad.n_0.numpy(), rad.shape)
    return nn * rng.uniform(lo, hi, rad.shape)


def test_operators_match_jax(built):
    """fluxes, divfa, rk_update, the gray source and the floor (with
    excision on the Kerr deck) on random intensities to 1e-12, and the
    moments."""
    name, ((jm, jp, js), (tm, tp, ts)) = built
    rng = np.random.default_rng(5)
    i0 = _random_i0(tp, rng)
    ti, ji = torch.as_tensor(i0), jnp.asarray(i0)
    flx, jflx = tp.fluxes(ti), jp.fluxes(ji)
    for d in jflx:
        _close(flx[d], jflx[d], 1e-12, f"flux {d}")
    if jp.angular_fluxes:
        _close(tp.divfa(ti), jp.divfa(ji), 1e-12, "divfa")
    i1 = _random_i0(tp, rng)
    _close(tp.rk_update(ti, torch.as_tensor(i1), flx, 0.5, 0.5, 0.01),
           jp.rk_update(ji, jnp.asarray(i1), jflx, 0.5, 0.5, 0.01), 1e-12,
           "rk_update")
    for rad in (tp, jp):
        rad.kappa_a, rad.kappa_s = 1.5, 7.0
    _close(tp.source(ti, 0.02), jp.source(ji, 0.02), 1e-12, "source")
    neg = _random_i0(tp, rng, -1.0, 2.0)
    _close(tp.floor(torch.as_tensor(neg)), jp._floor(jnp.asarray(neg)),
           1e-12, "floor")
    E, F = tp.moments(ti)
    jE, jF = jp.moments(ji)
    _close(E, jE, 1e-12, "E")
    for c in range(3):
        _close(F[c], jF[c], 1e-12, f"F{c}")
    _close(tp.coord_moments({"u": ti})[1], jp.coord_moments({"u": ji})[1],
           1e-12, "R^munu")


def test_angular_flux_deck():
    """tests/test_rad_gr.py's angular-flux deck (8^3 near a spin-0.5
    hole): the port's divfa equals the JAX package's to 1e-12, and
    summed over the angles with their solid angles it telescopes to
    zero."""
    from athenak_tpu.bvals import BoundaryValues as JaxBV
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu.radiation.radiation import Radiation as JaxRad
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    from athenak_tpu_torch.radiation.radiation import Radiation
    pj = JaxInput.from_string(ANGULAR)
    jm = JaxMesh(pj)
    jrad = JaxRad(pj, jm, JaxBV(jm))
    pt = ParameterInput.from_string(ANGULAR)
    tm = Mesh(pt)
    rad = Radiation(pt, tm, BoundaryValues(tm), "cpu", torch.float64)
    i0 = _random_i0(rad, np.random.default_rng(5))
    div = rad.divfa(torch.as_tensor(i0))
    _close(div, jrad.divfa(i0), 1e-12, "divfa")
    tot = (div * rad.sang).sum(dim=1)
    scale = float(div.abs().max())
    assert float(tot.abs().max()) < 1e-10 * max(scale, 1.0)


# ---------------------------------------------------------------------------
# decks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(DECKS))
def test_radiation_deck_three_cycles(pairs, name):
    """Three RK2 cycles of each radiation-only deck through
    ``main.run``: the intensities with their ghosts and the time to
    1e-10 (the Kerr beam's where JAX's are finite: F2 gives none
    there)."""
    pair = pairs[name]
    check_pair(pair)
    got, ref = pair.state["u"], pair.jax_state["u"]
    assert np.isfinite(ref).all()
    assert_close(got, ref, 1e-10, "i0 with ghosts")
    if name == "beam_kerr":
        assert float(np.abs(interior(got)).max()) > 0.0
        mask = pair.phys.excise_mask.numpy()
        assert (got[np.broadcast_to(mask[:, None], got.shape)] == 0).all()


def test_beam_raises_no_warning(recwarn):
    """The beam's null direction takes the square root of a negative
    number in some cells (ROADMAP F2): the port gives those cells no beam
    without a warning."""
    import warnings
    pt = ParameterInput.from_string(BEAM)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, phys, _, _, _ = torch_main.build(pt, device="cpu")
    assert float(phys.beam_dii0.abs().max()) > 0.0


def test_rad_coord_outputs_match_jax(pairs, tmp_path):
    """The snake's ``rad_coord`` on its final state: the port's ``bin``
    and the JAX package's, header and block records equal, the ten
    moments to 1e-12; the port's ``vtk`` holds the same moments (the JAX
    package's vtk writes the first five intensities under the fluid's
    labels, ROADMAP F24)."""
    from athenak_tpu import outputs as jax_outputs
    from athenak_tpu_torch import outputs as torch_outputs
    pair = pairs["snake"]
    for pin in (pair.port_pin, pair.jax_pin):
        pin.set_value("output7", "file_type", "bin")
        pin.set_value("output7", "variable", "rad_coord")
    tst = {k: torch.as_tensor(v) for k, v in pair.state.items()}
    jst = jax.tree_util.tree_map(jnp.asarray, pair.state)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        torch_outputs.BinaryOutput(pair.port_pin, pair.mesh, pair.phys,
                                   "output7").write(pair.mesh, tst)
        vt = torch_outputs.VtkOutput(pair.port_pin, pair.mesh, pair.phys,
                                     "output7")
        vt.write(pair.mesh, tst)
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
    assert b"r00  r01  r02  r03  r11" in th
    mbi = pair.mesh.mb_indcs
    nmb, ncell = pair.mesh.nmb_total, mbi.nx1 * mbi.nx2 * mbi.nx3
    rec = 6 * 4 + 4 * 4 + 6 * 8
    size = rec + 8 * 10 * ncell
    assert len(td) == len(jd) == nmb * size
    for g in range(nmb):
        blk, jblk = (d[g * size:(g + 1) * size] for d in (td, jd))
        assert blk[:rec] == jblk[:rec]
        assert_close(np.frombuffer(blk[rec:], dtype=np.float64),
                     np.frombuffer(jblk[rec:], dtype=np.float64), 1e-12,
                     f"rad_coord block {g}")
    # the vtk: big-endian float32 moments on the global grid
    vname = [f for f in os.listdir(tmp_path) if f.endswith(".vtk")][0]
    data = open(tmp_path / vname, "rb").read()
    assert b"variables=rad_coord" in data and b"SCALARS r00 float" in data
    head = b"SCALARS r00 float\nLOOKUP_TABLE default\n"
    i = data.index(head) + len(head)
    n = pair.mesh.mesh_indcs.nx1 * pair.mesh.mesh_indcs.nx2
    r00 = np.frombuffer(data[i:i + 4 * n], dtype=">f4")
    _, jR = pair.jax_phys.coord_moments({"u": jst["u"]})
    jR = np.asarray(jR)[:, 0, mbi.ks, mbi.js:mbi.je + 1, mbi.is_:mbi.ie + 1]
    glob = np.empty((pair.mesh.mesh_indcs.nx2, pair.mesh.mesh_indcs.nx1))
    for g in range(nmb):
        l1, l2, _ = pair.mesh.lloc_eachmb[g][:3]
        glob[l2 * mbi.nx2:(l2 + 1) * mbi.nx2,
             l1 * mbi.nx1:(l1 + 1) * mbi.nx1] = jR[g]
    assert_close(r00, glob.astype(np.float32).ravel(), 1e-6, "vtk r00")


# ---------------------------------------------------------------------------
# the CLI and the fill kernels' gates
# ---------------------------------------------------------------------------
def test_radiation_decks_through_the_cli(tmp_path, monkeypatch):
    """The shipped radiation-only decks run through ``main.cli`` (the
    snake at its cut size writes its ``vtk`` of ``rad_coord``); with an
    ``<adm>`` block beside it a radiation-only deck still builds the
    radiation physics, as the JAX package's ``make_physics`` does."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    cwd = os.getcwd()
    try:
        for deck, extra in ((HOHLRAUM, []), (SNAKE, SNAKE_CUT)):
            mesh, phys, _, state = torch_main.cli(
                ["-i", os.path.join(ROOT, deck), "-d",
                 str(tmp_path / os.path.basename(deck)), *extra,
                 "time/nlim=2"])
            os.chdir(cwd)
            assert mesh.ncycle == 2 and torch.isfinite(state["u"]).all()
        assert any(f.endswith(".rad_coord.00000.vtk")
                   for f in os.listdir(tmp_path / "snake.athinput"))
        from athenak_tpu.bvals import BoundaryValues as JaxBV
        from athenak_tpu.mesh import Mesh as JaxMesh
        pin = ParameterInput.from_string(deck_text(HOHLRAUM)
                                         + "\n<adm>\nfoo = 1\n")
        _, phys, _, _, _ = torch_main.build(pin, device="cpu")
        pj = JaxInput.from_string(deck_text(HOHLRAUM)
                                  + "\n<adm>\nfoo = 1\n")
        jm = JaxMesh(pj)
        jphys = jax_main.make_physics(pj, jm, JaxBV(jm))
        assert type(phys).__name__ == type(jphys).__name__ == "Radiation"
    finally:
        os.chdir(cwd)


GATE_DECKS = {
    "hohlraum_1d": (HOHLRAUM, []),
    "snake": (SNAKE, SNAKE_CUT),
    "relax": ("inputs/radiation/relax.athinput", []),
    "shadow": ("inputs/radiation/shadow.athinput", []),
    "rad_linwave": ("inputs/tests/rad_linwave.athinput", []),
    "rad_wide": ("inputs/tests/rad_linwave.athinput",
                 ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8"]),
    "rad_pool": ("inputs/tests/rad_linwave.athinput",
                 ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8",
                  "meshblock/nx1=4", "meshblock/nx2=4", "meshblock/nx3=4"]),
}


@pytest.mark.parametrize("name", sorted(GATE_DECKS))
def test_radiation_fill_gates_match_jax(name):
    """Kernel B's and G's gates on the radiation decks equal the JAX
    package's (without its TPU condition): a user side, a 1-D or 2-D
    mesh closes both; the 3-D periodic linear wave opens B on one block
    and G on a pool."""
    from athenak_tpu.bvals import BoundaryValues as JaxBV
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu.ops.pallas_pool_fill import supports_pool_fill
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    path, extra = GATE_DECKS[name]
    pj = JaxInput.from_string(deck_text(path))
    pj.modify_from_cmdline(extra)
    jm = JaxMesh(pj)
    jbv = JaxBV(jm)
    single = (jm.nmb_total == 1 and not jbv.multilevel
              and len(jbv.active_axes) == 3 and jbv.ng == 2
              and not any(jbv.any_phys.values())
              and all(f == "periodic" for f in jbv.flag.values()))
    pt = ParameterInput.from_string(deck_text(path))
    pt.modify_from_cmdline(extra)
    tm = Mesh(pt)
    tbv = BoundaryValues(tm)
    assert tbv.use_fill_kernel == single
    assert tbv.use_pool_fill == supports_pool_fill(jm)
    assert (single, supports_pool_fill(jm)) == {
        "rad_wide": (True, False), "rad_pool": (False, True)}.get(
            name, (False, False))
