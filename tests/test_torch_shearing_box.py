"""The shearing box of the port (``athenak_tpu_torch/shearing_box.py``:
orbital advection, the shear-periodic remap, the source terms; the MRI
and shearing-wave generators) against the JAX package, float64 on the
CPU.

  * Three cycles of every deck of ``inputs/shearing_box/`` through both
    packages' whole cycles (``torch_cycle_parity.CyclePair``):
    ``hydro_compress_shwave`` and ``epicycle`` (with the epicyclic vx
    kick of ``tests/test_shearing_box.py``) at 16 x 16 x 4,
    ``hydro_orb_adv`` with a sheared passive-scalar stripe, ``mri2d`` at
    32^2, ``mri3d`` at 32 x 64 x 8 in eight blocks (the rings cross
    four y blocks), ``mri3d_unstratified`` at 16 x 32 x 8 on the general
    path and on kernel J's route (its plain version; the JAX package's
    general path is the reference, ROADMAP F5), ``mri3d_stratified`` at
    16 x 16 x 32, and ``tests/test_mri3d_smr.py``'s z-slab refined deck
    cut to nine blocks on two levels: the initial and initialised states
    to 1e-12, the cycles to 1e-10, the user histories likewise; a
    refined region that is no z-slab raises in both packages.
  * The components on random fields to 1e-12, on the eight-block box:
    ``orbital_advect`` and ``orbital_advect_fc``
    (div B of a field from a vector potential stays below 1e-12),
    ``remap_ghosts`` and ``remap_ghosts_fc`` with shifts of a fraction
    of a cell, of many cells, and negative; an integer shift beyond
    ``maxjshift`` raises.
  * A ``-r`` restart of ``mri3d_unstratified`` bitwise against a
    straight run.
  * The gates (``test_sbox_and_particles_close_kernels_as_jax``): for
    the seven shipped decks and the MHD blast with particles, every
    ``use_*`` flag of the port's MHD equals the JAX package's built with
    its TPU gate on (in its route order), J's equals its ``use_pallas``
    under the shearing box,
    and the fills B and G are closed under ``shear_periodic`` (open once
    x1 is periodic where the rest of their gates admits the deck).
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu.shearing_box import ShearingBox as JaxSBox  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.mesh import Mesh  # noqa: E402
from athenak_tpu_torch.shearing_box import ShearingBox  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_cycle_parity import CyclePair  # noqa: E402
from torch_deck_parity import assert_close, deck_text, jit_o0  # noqa: E402

SBOX = "inputs/shearing_box/"
MRI3D_CUT = ["mesh/nx1=32", "mesh/nx2=64", "mesh/nx3=8", "meshblock/nx1=16",
             "meshblock/nx2=16", "meshblock/nx3=8"]
UNSTRAT_CUT = ["mesh/nx1=16", "mesh/nx2=32", "mesh/nx3=8"]
SMR_CUT = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=8", "meshblock/nx1=16",
           "meshblock/nx2=16", "meshblock/nx3=4", "refined_region1/x3min=0.0",
           "refined_region1/x3max=0.5"]


def _smr_deck():
    from test_mri3d_smr import DECK
    return DECK.format(tlim=1.0)


def _kick(u):
    """The epicyclic kick of ``tests/test_shearing_box.py``: vx = 1e-3."""
    u[:, 1] += 1.0e-3 * u[:, 0]
    return u


def _stripe(u):
    """A passive-scalar stripe 0.5 (1 + sin(2 pi y)) on the 16^2 cut of
    ``hydro_orb_adv`` (x2 in [-2, 2], two ghost cells)."""
    y = -2.0 + (np.arange(u.shape[3]) - 2 + 0.5) * 0.25
    u[:, 5] = 0.5 * (1.0 + np.sin(2.0 * np.pi * y))[None, None, :, None] \
        * u[:, 0]
    return u


def _full_arrays_close(pair, tol=1e-10):
    """u and the face field with their ghosts: the sheared remap writes
    the x1 ghosts, which the interior check does not see."""
    assert_close(pair.state["u"], pair.jax_state["u"], tol, "u+ghosts")
    if "bfc" in pair.jax_state:
        bmax = max(float(np.abs(v).max())
                   for v in pair.jax_state["bfc"].values())
        for c, v in pair.jax_state["bfc"].items():
            assert_close(pair.state["bfc"][c], v, tol, c + "+ghosts",
                         scale=bmax)


def _hist_close(pair, tol=1e-10):
    """The generators' user histories on the final states."""
    jst = jax.tree_util.tree_map(jnp.asarray, pair.jax_state)
    tst = {k: (torch.as_tensor(v) if not isinstance(v, dict) else
               {c: torch.as_tensor(a) for c, a in v.items()})
           for k, v in pair.state.items()}
    jl, jv = pair.jax_phys.user_hist_func(pair.jax_mesh, jst)
    tl, tv = pair.phys.user_hist_func(pair.mesh, tst)
    assert list(jl) == list(tl)
    jv, tv = np.asarray(jv, dtype=float), np.asarray(tv, dtype=float)
    np.testing.assert_allclose(tv, jv, rtol=0,
                               atol=tol * max(np.abs(jv).max(), 1e-300))


# name: (deck, cut, perturbation, nghost, the JAX cycle compiled in two
# parts (``CyclePair``'s ``split``, to keep the file's time; the hydro
# decks and the r-z box take the JAX driver's own cycle function))
DECKS = {
    "hydro_compress_shwave": (SBOX + "hydro_compress_shwave.athinput",
                              ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=4"],
                              None, 2, False),
    "epicycle": (SBOX + "epicycle.athinput",
                 ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=4"], _kick, 2,
                 False),
    "hydro_orb_adv": (SBOX + "hydro_orb_adv.athinput",
                      ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=4"],
                      _stripe, 2, False),
    "mri2d": (SBOX + "mri2d.athinput", ["mesh/nx1=32", "mesh/nx2=32"],
              None, 3, False),
    "mri3d": (SBOX + "mri3d.athinput", MRI3D_CUT, None, 3, True),
    "mri3d_unstratified": (SBOX + "mri3d_unstratified.athinput",
                           UNSTRAT_CUT, None, 2, True),
    "mri3d_stratified": (SBOX + "mri3d_stratified.athinput",
                         ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=32"],
                         None, 2, True),
}


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Each deck through both packages once, shared by the tests."""
    cache = {}

    def get(name):
        if name not in cache:
            path, cut, perturb, _ng, split = DECKS[name]
            cache[name] = CyclePair(deck_text(path), cut, perturb=perturb,
                                    split=split,
                                    rundir=str(tmp_path_factory.mktemp(
                                        name)))
        return cache[name]

    return get


@pytest.mark.parametrize("name", sorted(DECKS))
def test_shearing_box_deck_three_cycles(pairs, name):
    pair = pairs(name)
    pair.check(ng=DECKS[name][3], extra=("t",))
    _full_arrays_close(pair)
    assert float(pair.state["t"]) == pytest.approx(pair.mesh.time, rel=1e-12)
    if hasattr(pair.jax_phys, "user_hist_func"):
        _hist_close(pair)


def test_shearing_box_sheared_the_scalar(pairs):
    """hydro_orb_adv's stripe has moved: the orbital advection and the
    remap did something the parity check can see."""
    pair = pairs("hydro_orb_adv")
    s0 = pair.port_ready["w"][:, 5]
    s1 = pair.state["w"][:, 5]
    assert np.abs(s1 - s0)[..., 2:-2, 2:-2].max() > 1e-3


def test_mri3d_unstratified_on_kernel_j_route(pairs, tmp_path, monkeypatch):
    """The port's J route (J's plain version, ``fused_flux_dir`` on CPU
    tensors) under the shearing box against the JAX package's general
    path: J's face floors do not fire on this deck."""
    from athenak_tpu_torch.ops import flux
    from athenak_tpu_torch.physics import mhd as pm
    from torch_deck_parity import assert_states_close, port_run
    calls = []
    orig = flux.fused_flux_dir

    def counted(*a, **k):
        calls.append(a[3])
        return orig(*a, **k)

    monkeypatch.setattr(pm, "kernel_dtype_ok", lambda t: True)
    monkeypatch.setattr(flux, "fused_flux_dir", counted)
    ref = pairs("mri3d_unstratified")
    mesh, phys, _, st = port_run(deck_text(DECKS["mri3d_unstratified"][0]),
                                 UNSTRAT_CUT, ncyc=3, rundir=str(tmp_path))
    assert phys.use_flux_dir and not phys.use_fused_ct
    assert len(calls) == 3 * 2 * 3
    assert_states_close(st, ref.jax_state, 1e-10)


@pytest.fixture(scope="module")
def smr_pair(tmp_path_factory):
    return CyclePair(_smr_deck(), SMR_CUT, split=True,
                     rundir=str(tmp_path_factory.mktemp("smr")))


def test_mri3d_zslab_smr_three_cycles(smr_pair):
    pair = smr_pair
    assert pair.mesh.multilevel and pair.mesh.nmb_total == 9
    sbox = pair.phys.psbox
    assert [g[0] for g in sbox.ring["m"]] == [0, 1]
    for side in ("m", "p"):
        for (lv, ring, lmask, _), (jlv, jring, jmask) in zip(
                sbox.ring[side], pair.jax_phys.psbox.ring[side]):
            assert lv == jlv
            np.testing.assert_array_equal(ring, jring)
            np.testing.assert_array_equal(lmask, jmask)
    for k in ("x1m", "x1p"):
        np.testing.assert_array_equal(pair.mesh.phys_bc_mask[k],
                                      pair.jax_mesh.phys_bc_mask[k])
    pair.check(extra=("t",))
    _full_arrays_close(pair)
    _hist_close(pair)


def test_zslab_rejects_mixed_level_rows():
    """A refined region not spanning the whole x1 extent raises in both
    packages (the rings would pair columns of two levels)."""
    from athenak_tpu import main as jax_main
    bad = _smr_deck().replace(
        "x1min = -0.5\nx1max = 0.5\nx2min = -1.0",
        "x1min = 0.0\nx1max = 0.5\nx2min = -1.0")
    with pytest.raises(NotImplementedError, match="z-slab"):
        jax_main.build(JaxInput.from_string(bad))
    with pytest.raises(NotImplementedError, match="z-slab"):
        torch_main.build(ParameterInput.from_string(bad), device="cpu")


# ---------------------------------------------------------------------------
# the components on random fields
# ---------------------------------------------------------------------------
# the refined box's per-level rings are held through the z-slab deck
COMPONENT_MESHES = {
    "eight_blocks": (SBOX + "mri3d.athinput", MRI3D_CUT),
}


@pytest.fixture(scope="module", params=sorted(COMPONENT_MESHES))
def boxes(request):
    """(JAX ShearingBox, port ShearingBox, port mesh) on one mesh."""
    path, cut = COMPONENT_MESHES[request.param]
    text = deck_text(path) if path else _smr_deck()
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(cut)
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(cut)
    jmesh, tmesh = JaxMesh(pj), Mesh(pt)
    return (JaxSBox(pj, jmesh, 5),
            ShearingBox(pt, tmesh, "cpu", torch.float64), tmesh)


def _dt_for(sb, cells):
    """The dt that shifts the outermost active column of the finest
    level by ``cells`` cells (negative: the other way)."""
    xmax = float(np.abs(sb.xc[..., sb.mesh.mb_indcs.is_:
                              sb.mesh.mb_indcs.ie + 1]).max())
    dy = float(sb.dyb.min())
    return -cells * dy / (sb.qshear * sb.omega0 * xmax)


def _random_bfc(mesh, rng):
    """A face field from a random vector potential (a few Fourier modes,
    periodic in y and z) on the edges: div B = 0 to round-off in every
    cell, ghosts included."""
    mbi = mesh.mb_indcs
    ms = mesh.mesh_size
    modes = [(rng.integers(-2, 3), rng.integers(1, 3), rng.integers(0, 3),
              rng.normal(size=3), rng.uniform(0, 2 * np.pi))
             for _ in range(3)]
    lx, ly, lz = (ms.x1max - ms.x1min, ms.x2max - ms.x2min,
                  ms.x3max - ms.x3min)
    n1, n2, n3 = mbi.ncells1, mbi.ncells2, mbi.ncells3
    nmb = mesh.nmb_total
    out = {"x1f": np.zeros((nmb, n3, n2, n1 + 1)),
           "x2f": np.zeros((nmb, n3, n2 + 1, n1)),
           "x3f": np.zeros((nmb, n3 + 1, n2, n1))}
    for g in range(nmb):
        xc, yc, zc = mesh.cell_centers(g)
        xf, yf, zf = mesh.face_edges(g)
        dx, dy, dz = (mesh.mb_size[k][g] for k in ("dx1", "dx2", "dx3"))

        def pot(xa, ya, za, comp):
            Z, Y, X = np.meshgrid(za, ya, xa, indexing="ij")
            a = np.zeros_like(X)
            for mx, my, mz, amp, ph in modes:
                a += amp[comp] * np.sin(2 * np.pi * (mx * X / lx + my * Y / ly
                                                     + mz * Z / lz) + ph)
            return a

        a1 = pot(xc, yf, zf, 0)
        a2 = pot(xf, yc, zf, 1)
        a3 = pot(xf, yf, zc, 2)
        out["x1f"][g] = (a3[:, 1:, :] - a3[:, :-1, :]) / dy \
            - (a2[1:] - a2[:-1]) / dz
        out["x2f"][g] = (a1[1:] - a1[:-1]) / dz \
            - (a3[:, :, 1:] - a3[:, :, :-1]) / dx
        out["x3f"][g] = (a2[:, :, 1:] - a2[:, :, :-1]) / dx \
            - (a1[:, 1:, :] - a1[:, :-1, :]) / dy
    return out


def _div_b(bfc, mesh):
    mbi = mesh.mb_indcs
    dx = [np.asarray(mesh.mb_size[k]).reshape(-1, 1, 1, 1)
          for k in ("dx1", "dx2", "dx3")]
    b1, b2, b3 = (np.asarray(bfc[c]) for c in ("x1f", "x2f", "x3f"))
    div = ((b1[..., 1:] - b1[..., :-1]) / dx[0]
           + (b2[..., 1:, :] - b2[..., :-1, :]) / dx[1]
           + (b3[:, 1:] - b3[:, :-1]) / dx[2])
    return div[:, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1, mbi.is_:mbi.ie + 1]


@pytest.mark.parametrize("cells", [0.37, -1.0, 1.0])
def test_orbital_advect_random(boxes, cells):
    """``orbital_advect`` on random cell data, the outermost column of the
    finest level moved by ``cells`` cells (half that on the coarse
    level of the refined box); the columns at -x1 move the other way."""
    jsb, tsb, mesh = boxes
    mbi = mesh.mb_indcs
    rng = np.random.default_rng(7)
    u = rng.normal(size=(mesh.nmb_total, 5, mbi.ncells3, mbi.ncells2,
                         mbi.ncells1))
    dt = _dt_for(tsb, cells)
    ref = np.asarray(jit_o0(jsb.orbital_advect)(jnp.asarray(u), dt))
    got = tsb.orbital_advect(torch.as_tensor(u), dt).numpy()
    act = (Ellipsis, slice(mbi.is_, mbi.ie + 1))
    assert_close(got[act], ref[act], 1e-12, "u")
    assert np.array_equal(got[..., :mbi.is_], u[..., :mbi.is_])
    assert np.abs(got[act] - u[act]).max() > 0.1


@pytest.mark.parametrize("cells", [0.37, -1.0, 1.0])
def test_orbital_advect_fc_random(boxes, cells):
    """``orbital_advect_fc`` on a random divergence-free field: the faces
    of the active columns to 1e-12, div B below 1e-12 after it."""
    jsb, tsb, mesh = boxes
    mbi = mesh.mb_indcs
    bfc = _random_bfc(mesh, np.random.default_rng(8))
    assert np.abs(_div_b(bfc, mesh)).max() < 1e-12
    dt = _dt_for(tsb, cells)
    ref = jit_o0(jsb.orbital_advect_fc)(
        {k: jnp.asarray(v) for k, v in bfc.items()}, dt)
    got = tsb.orbital_advect_fc({k: torch.as_tensor(v)
                                 for k, v in bfc.items()}, dt)
    bmax = max(float(np.abs(v).max()) for v in bfc.values())
    for c, hi in (("x1f", mbi.ie + 2), ("x2f", mbi.ie + 1),
                  ("x3f", mbi.ie + 1)):
        assert_close(got[c].numpy()[..., mbi.is_:hi],
                     np.asarray(ref[c])[..., mbi.is_:hi], 1e-12, c,
                     scale=bmax)
    assert np.abs(got["x1f"].numpy() - bfc["x1f"]).max() > 1e-3 * bmax
    assert np.abs(_div_b({k: v.numpy() for k, v in got.items()},
                         mesh)).max() < 1e-12 * bmax / min(
        mesh.mesh_size.dx1, mesh.mesh_size.dx2)


@pytest.mark.parametrize("t", [0.013, 1.0, 3.7])
def test_remap_ghosts_random(boxes, t):
    """``remap_ghosts`` and ``remap_ghosts_fc`` on random data at times
    whose shear is a fraction of a cell (0.013) and tens of cells (1.0,
    3.7): the x1m side shifts by +yshear, the x1p side by -yshear."""
    jsb, tsb, mesh = boxes
    if not tsb.ring:
        pytest.skip("no shear-periodic x1 side")
    mbi = mesh.mb_indcs
    rng = np.random.default_rng(9)
    u = rng.normal(size=(mesh.nmb_total, 5, mbi.ncells3, mbi.ncells2,
                         mbi.ncells1))
    assert tsb.qshear * tsb.omega0 * tsb.lx * 1.0 / tsb.dy > 10.0
    ref = np.asarray(jit_o0(jsb.remap_ghosts)(jnp.asarray(u),
                                              jnp.asarray(t)))
    got = tsb.remap_ghosts(torch.as_tensor(u.copy()),
                           torch.tensor(t, dtype=torch.float64)).numpy()
    assert_close(got, ref, 1e-12, "u")
    assert np.abs(got - u).max() > 0.1
    bfc = {k: rng.normal(size=s) for k, s in (
        ("x1f", u.shape[:1] + u.shape[2:4] + (u.shape[4] + 1,)),
        ("x2f", u.shape[:1] + (u.shape[2], u.shape[3] + 1, u.shape[4])),
        ("x3f", u.shape[:1] + (u.shape[2] + 1,) + u.shape[3:]))}
    ref = jit_o0(jsb.remap_ghosts_fc)(
        {k: jnp.asarray(v) for k, v in bfc.items()}, jnp.asarray(t))
    got = tsb.remap_ghosts_fc({k: torch.as_tensor(v.copy())
                               for k, v in bfc.items()},
                              torch.tensor(t, dtype=torch.float64))
    for c in bfc:
        assert_close(got[c].numpy(), np.asarray(ref[c]), 1e-12, c)


def test_orbital_advect_refuses_a_shift_beyond_the_bound(boxes):
    """An integer shift past ``maxjshift`` raises before any gather (the
    JAX package clamps such an index; a CUDA gather would fault)."""
    _, tsb, mesh = boxes
    mbi = mesh.mb_indcs
    u = torch.zeros((mesh.nmb_total, 5, mbi.ncells3, mbi.ncells2,
                     mbi.ncells1), dtype=torch.float64)
    with pytest.raises(ValueError, match="maxjshift"):
        tsb.orbital_advect(u, _dt_for(tsb, 4.0 + tsb.maxjshift))


# ---------------------------------------------------------------------------
# restart
# ---------------------------------------------------------------------------
def test_sbox_restart_is_bitwise(tmp_path, monkeypatch):
    """mri3d_unstratified at 16 x 32 x 8: four cycles straight against
    two, a ``.rst`` (with ``t``), then ``-r`` and two more; u, the face
    field and t bitwise equal."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    deck = tmp_path / "mri3d.athinput"
    deck.write_text(deck_text(SBOX + "mri3d_unstratified.athinput")
                    + "\n<output9>\nfile_type = rst\ndcycle = 2\n")
    common = UNSTRAT_CUT
    cwd = os.getcwd()
    try:
        _, _, _, s1 = torch_main.cli(["-i", str(deck), "-d",
                                      str(tmp_path / "straight"), *common,
                                      "time/nlim=4"])
        os.chdir(cwd)
        torch_main.cli(["-i", str(deck), "-d", str(tmp_path / "first"),
                        *common, "time/nlim=2"])
        os.chdir(cwd)
        rst = str(tmp_path / "first" / "mri3d_unstratified.00001.rst")
        from athenak_tpu_torch.outputs import load_restart
        stored = load_restart(rst)[4]
        assert float(stored["t"]) > 0.0
        m2, _, _, s2 = torch_main.cli(["-r", rst, "-d",
                                       str(tmp_path / "first"),
                                       "time/nlim=4"])
    finally:
        os.chdir(cwd)
    assert m2.ncycle == 4
    assert torch.equal(s1["u"], s2["u"]) and torch.equal(s1["t"], s2["t"])
    for c in s1["bfc"]:
        assert torch.equal(s1["bfc"][c], s2["bfc"][c]), c


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
PARTICLES = """
<particles>
particle_type = cosmic_ray
ppc = 0.1
pusher = drift
"""

GATE_DECKS = {name: (SBOX + name + ".athinput", []) for name in (
    "epicycle", "hydro_compress_shwave", "hydro_orb_adv", "mri2d",
    "mri3d", "mri3d_stratified", "mri3d_unstratified")}
GATE_DECKS["part_blast"] = ("inputs/mhd/blast.athinput", [])
MHD_FLAGS = ("use_fused_stage", "use_fused_ct", "use_mega_stage",
             "use_mega_v2")


def _gate_text(name):
    path, _ = GATE_DECKS[name]
    text = deck_text(path)
    return text + PARTICLES if name == "part_blast" else text


def _jax_phys(text, extra):
    """The JAX package's physics with its TPU gate evaluated (the route
    forced on, x64 off while the object is built)."""
    from athenak_tpu import main as jax_main
    from athenak_tpu.bvals import BoundaryValues as JaxBV
    pin = JaxInput.from_string(text)
    extra = list(extra) + (["mhd/use_pallas=true"]
                           if pin.does_block_exist("mhd") else [])
    pin.modify_from_cmdline(extra)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        mesh = JaxMesh(pin)
        return jax_main.make_physics(pin, mesh, JaxBV(mesh)), mesh
    finally:
        jax.config.update("jax_enable_x64", x64)


def _port_phys(text, extra):
    from athenak_tpu_torch.bvals import BoundaryValues
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(list(extra) + ["job/precision=single"])
    mesh = Mesh(pin)
    return torch_main.make_physics(pin, mesh, BoundaryValues(mesh), "cpu",
                                   torch.float32), mesh


def _jax_routes(jp):
    """The JAX package's stage flags in its route order (A, then E, then
    C: ``mhd.py:1577-1640``), which the port's flags encode: a flag the
    JAX package sets under a route taken before it is off in the port."""
    a = jp.use_mega_v2
    e = jp.use_mega_stage and not a
    c = jp.use_fused_stage and not (a or e)
    return {"use_mega_v2": a, "use_mega_stage": e, "use_fused_stage": c,
            "use_fused_ct": jp.use_fused_ct,
            # J forms the general path's fluxes (``use_pallas`` there)
            "use_flux_dir": jp.use_pallas and not (a or e or c)}


def _jax_fill_gates(jmesh, jbv):
    """The JAX package's B and G gates without their TPU condition
    (``bvals.py:88-100``, ``pallas_pool_fill.py:82-88``)."""
    from athenak_tpu.ops.pallas_pool_fill import supports_pool_fill
    single = (jmesh.nmb_total == 1 and not jbv.multilevel
              and len(jbv.active_axes) == 3 and jbv.ng == 2
              and not any(jbv.any_phys.values())
              and all(f == "periodic" for f in jbv.flag.values()))
    return single, supports_pool_fill(jmesh)


@pytest.mark.parametrize("name", sorted(GATE_DECKS))
def test_sbox_and_particles_close_kernels_as_jax(name):
    text, extra = _gate_text(name), GATE_DECKS[name][1]
    jp, jmesh = _jax_phys(text, extra)
    tp, tmesh = _port_phys(text, extra)
    assert (tp.psbox is None) == (jp.psbox is None)
    assert (tp.ppart is None) == (jp.ppart is None)
    if getattr(jp, "is_mhd", False):
        for flag, want in _jax_routes(jp).items():
            assert getattr(tp, flag) == want, flag
        if jp.psbox is not None:
            assert tp.use_flux_dir == jp.use_pallas
        assert not tp.use_mega_v2                  # A closed by both
        if name == "part_blast":
            # particles close A alone: the v1 route E + F
            assert tp.use_mega_stage and jp.use_mega_stage
            assert tp.use_fused_ct and jp.use_fused_ct
        else:
            for flag in MHD_FLAGS:
                assert not getattr(tp, flag), flag
    single, pool = _jax_fill_gates(jmesh, jp.bvals)
    assert tp.bvals.use_fill_kernel == single
    assert tp.bvals.use_pool_fill == pool
    if tp.psbox is not None:
        # shear_periodic closes B and G; a periodic x1 opens them where
        # the rest of their gates admits the deck
        assert not tp.bvals.use_fill_kernel and not tp.bvals.use_pool_fill
        per = ["mesh/ix1_bc=periodic", "mesh/ox1_bc=periodic"]
        jp2, jmesh2 = _jax_phys(text, list(extra) + per)
        tp2, _ = _port_phys(text, list(extra) + per)
        single, pool = _jax_fill_gates(jmesh2, jp2.bvals)
        assert tp2.bvals.use_fill_kernel == single
        assert tp2.bvals.use_pool_fill == pool
        if name in ("epicycle", "hydro_orb_adv", "mri3d_unstratified"):
            assert single


def test_sbox_closes_each_stage_gate():
    """The shearing box in the gate functions themselves: on the
    unstratified MRI deck (kernel A's physics, one block, two ghost
    cells) the stage gates of A, C, D and E are closed by it alone, and
    J's is not."""
    from athenak_tpu_torch.ops import flux, stage, stage_split
    text = deck_text(SBOX + "mri3d_unstratified.athinput")
    tp, tmesh = _port_phys(text, [])
    assert flux.supports_flux_dir(tp)
    for gate in (stage.supports_mega_stage, stage.supports_mega_v2,
                 stage_split.supports_fused_stage,
                 stage_split.supports_fused_ct):
        assert not gate(tp, tmesh), gate.__name__
    sbox, tp.psbox = tp.psbox, None
    try:
        for gate in (stage.supports_mega_stage, stage.supports_mega_v2,
                     stage_split.supports_fused_stage,
                     stage_split.supports_fused_ct):
            assert gate(tp, tmesh), gate.__name__
    finally:
        tp.psbox = sbox
