"""Parity of the v1 stage route's plain versions with the JAX package:
``fused_mega_stage3d_plain`` (kernel E, ``ops/stage_v1.py``) and
``fused_aux3d_plain`` (kernel F, ``ops/aux.py``).

  * Against the Pallas kernels ``pallas_stage.fused_mega_stage3d`` and
    ``pallas_stage.fused_aux3d`` in Pallas interpret mode, float32.  The
    stage within the two-tier bound of ``test_pallas_parity._compare``
    (more than 95% of interior values within 3e-5 of the field scale, all
    within 5e-3: HLLD branch selects flip on float32 ulps in a few
    cells), for gam1 = 0 (the register is not read) and gam1 != 0.  The
    aux pass for wrap=True and wrap=False: u and w on the interior, w and
    bcc on the whole array, the three floor counts equal, dtmin within
    rtol 1e-5.
  * Both composed into a stage, against the port's general path
    (``MHD.stage_update`` on the CPU) in float64 within 1e-10 of the field
    scale, on one periodic block (aux with its wrap) and on a 2x2x2 pool
    (the pool fill of u, then aux without the wrap).
Inputs are random physical states from numpy's default_rng.  The JAX
side runs under ``jax.jit`` at XLA's backend optimisation level 0, which
halves the compile time of the interpret-mode kernels on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.ops import eos as jeos  # noqa: E402
from athenak_tpu.ops import pallas_stage  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.main import build  # noqa: E402
from athenak_tpu_torch.ops import aux, eos as teos, fill, stage_v1  # noqa
from athenak_tpu_torch.physics.mhd import compute_bcc  # noqa: E402

NX = 12
N = NX + 4
DX = 1.0 / NX
DXS = {"x1": DX, "x2": DX, "x3": DX}
INT = (Ellipsis, slice(2, -2), slice(2, -2), slice(2, -2))
STAGES = [(0.0, 1.0, 1.0), (0.5, 0.5, 0.5)]   # rk2 (gam0, gam1, beta)


def _prims(rng, nmb=1):
    """Random primitives (positive density and pressure) and face field,
    float64 numpy."""
    shp = (nmb, N, N, N)
    w = np.stack([rng.uniform(0.5, 1.5, shp), rng.uniform(-0.5, 0.5, shp),
                  rng.uniform(-0.5, 0.5, shp), rng.uniform(-0.5, 0.5, shp),
                  rng.uniform(0.5, 1.5, shp)], axis=1)
    bfc = {"x1f": rng.uniform(-0.5, 0.5, (nmb, N, N, N + 1)),
           "x2f": rng.uniform(-0.5, 0.5, (nmb, N, N + 1, N)),
           "x3f": rng.uniform(-0.5, 0.5, (nmb, N + 1, N, N))}
    return w, bfc


def _periodic(bfc):
    """A face field of one periodic block: the two copies of each shared
    boundary face made equal, then every ghost filled."""
    out = {}
    for c, v in bfc.items():
        t = torch.from_numpy(v.copy())
        ax = {"x1f": 3, "x2f": 2, "x3f": 1}[c]
        t.narrow(ax, 2 + NX, 1).copy_(t.narrow(ax, 2, 1))
        out[c] = fill.fill_plain(t, fill.shifts(t.shape, c)).numpy()
    return out


def _cons(w, bfc):
    bcc = compute_bcc({k: torch.from_numpy(v) for k, v in bfc.items()})
    return teos.prim_to_cons_mhd(torch.from_numpy(w), bcc,
                                 teos.EOSData()).numpy(), bcc.numpy()


def _tiers(got, ref, scale, label):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    err = err / scale
    frac = float((err < 3e-5).mean())
    assert frac > 0.95, f"{label}: only {frac:.4f} of values within 3e-5"
    assert err.max() < 5e-3, f"{label}: max scale-relative err {err.max():g}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _jit_o0(fn):
    """``jax.jit`` at backend optimisation level 0: the same operations,
    compiled in less than half the time."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture
def f32_interpret():
    """float32 + Pallas interpret mode, restored afterwards."""
    jax.config.update("jax_enable_x64", False)
    pallas_stage.INTERPRET = True
    yield
    pallas_stage.INTERPRET = False
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("rk_stage", [0, 1])
def test_plain_mega_stage_matches_pallas_interpret(f32_interpret, rk_stage,
                                                   monkeypatch):
    # windows of 2 planes: interpret mode traces them 3x faster than the
    # default 6, and the 12 planes cross five window seams
    monkeypatch.setenv("ATHENAK_MEGA_K_MAX", "2")
    rng = np.random.default_rng(31 + rk_stage)
    w, bfc = _prims(rng)
    u0, bcc = _cons(w, bfc)
    w1, bfc1 = _prims(rng)
    u1, _ = _cons(w1, bfc1)
    f32 = [{k: v.astype(np.float32) for k, v in d.items()} for d in
           (bfc, bfc1)]
    w, bcc, u0, u1 = (a.astype(np.float32) for a in (w, bcc, u0, u1))
    gam0, gam1, beta = STAGES[rk_stage]
    bdt = float(np.float32(beta) * np.float32(0.05 * DX))
    ju, jb = _jit_o0(lambda *a: pallas_stage.fused_mega_stage3d(
        *a, jeos.EOSData(), gam0, gam1, bdt, DXS))(
        jnp.asarray(w), jnp.asarray(bcc),
        {k: jnp.asarray(v) for k, v in f32[0].items()}, jnp.asarray(u0),
        jnp.asarray(u1), {k: jnp.asarray(v) for k, v in f32[1].items()})
    tu, tb = stage_v1.fused_mega_stage3d(
        _t(w), _t(bcc), {k: _t(v) for k, v in f32[0].items()}, _t(u0),
        _t(u1), {k: _t(v) for k, v in f32[1].items()}, teos.EOSData(),
        gam0, gam1, bdt, DXS)
    ref = np.asarray(ju)
    scale = np.abs(ref[INT]).max(axis=(-3, -2, -1), keepdims=True)
    _tiers(tu.numpy()[INT], ref[INT], scale, "u")
    bscale = max(float(np.abs(np.asarray(jb[c])[INT]).max()) for c in jb)
    for c in jb:
        _tiers(tb[c].numpy()[INT], np.asarray(jb[c])[INT], bscale, c)
    assert kernels.MEGA_STAGE_V1.launches == 0


@pytest.mark.parametrize("wrap,floors", [
    (True, {}), (True, {"dfloor": 0.9, "pfloor": 0.5, "tfloor": 0.7}),
    (False, {"dfloor": 0.9, "pfloor": 0.5, "tfloor": 0.7})])
def test_plain_aux_matches_pallas_interpret(f32_interpret, wrap, floors):
    """With wrap the face field is that of a periodic block, as after the
    face fill; raised floors make every floor counter fire."""
    rng = np.random.default_rng(41)
    w, bfc = _prims(rng)
    if wrap:
        bfc = _periodic(bfc)
    u, _ = _cons(w, bfc)
    u = u.astype(np.float32)
    bfc = {k: v.astype(np.float32) for k, v in bfc.items()}
    ju, jw, jbcc, jc = _jit_o0(lambda u, b: pallas_stage.fused_aux3d(
        u, b, jeos.EOSData(**floors), dxs=DXS, wrap=wrap))(
        jnp.asarray(u), {k: jnp.asarray(v) for k, v in bfc.items()})
    tu, tw, tbcc, tc = aux.fused_aux3d(
        _t(u), {k: _t(v) for k, v in bfc.items()}, teos.EOSData(**floors),
        dxs=DXS, wrap=wrap)
    for name, got, ref, sl in (("u", tu, ju, INT), ("w", tw, jw, INT),
                               ("w", tw, jw, Ellipsis),
                               ("bcc", tbcc, jbcc, Ellipsis)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy()[sl], ref[sl], rtol=0,
                                   atol=2e-6 * np.abs(ref).max(),
                                   err_msg=name)
    for k in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
        assert int(tc[k]) == int(jc[k]), k
        assert int(tc[k]) > 0 or not floors, k
    np.testing.assert_allclose(float(tc["dtmin"]), float(jc["dtmin"]),
                               rtol=1e-5)
    assert kernels.FUSED_AUX3D.launches == 0


DECK = f"""
<job>
basename = v1
precision = double
<mesh>
nghost = 2
nx1 = {NX}
x1min = -0.5
x1max = 0.5
nx2 = {NX}
x2min = -0.5
x2max = 0.5
nx3 = {NX}
x3min = -0.5
x3max = 0.5
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0
<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
"""


@pytest.mark.parametrize("pool", [False, True])
def test_plain_v1_route_matches_general_stage_f64(pool):
    """E, the face fill and F (plain) against ``MHD.stage_update``'s
    general path over both RK2 stages: u on the interior, w, bcc and the
    face field on the whole array, dtmin against the general new-dt."""
    pin = ParameterInput.from_string(DECK)
    if pool:
        pin.modify_from_cmdline([f"meshblock/nx{a}={NX // 2}"
                                 for a in (1, 2, 3)])
    mesh, phys, _, _, _ = build(pin, device="cpu")
    assert mesh.nmb_total == (8 if pool else 1)
    assert phys.use_mega_v2 and not phys.use_mega_stage   # no driving
    bv = phys.bvals
    n = NX // 2 + 4 if pool else N
    rng = np.random.default_rng(5)
    shp = (mesh.nmb_total, n, n, n)
    w = np.stack([rng.uniform(0.5, 1.5, shp), rng.uniform(-0.5, 0.5, shp),
                  rng.uniform(-0.5, 0.5, shp), rng.uniform(-0.5, 0.5, shp),
                  rng.uniform(0.5, 1.5, shp)], axis=1)
    bfc = {c: rng.uniform(-0.5, 0.5, s) for c, s in phys.fc_shapes.items()}
    # one periodic block: its two copies of each boundary face are one
    # face, as in a run; F's wrap reads the face field through them
    bfc = {c: torch.from_numpy(v) for c, v in
           (bfc if pool else _periodic(bfc)).items()}
    bcc = compute_bcc(bfc)
    state = phys.init_ghosts(phys.make_state(
        phys.prim_to_cons(torch.from_numpy(w), bcc), None, bfc))
    saved = phys.save_state(state)
    gen = v1 = state
    dt = 0.3 * DX / 4.0
    for gam0, gam1, beta in STAGES:
        gen, _ = phys.stage_update(gen, saved, gam0, gam1, beta * dt)
        u, b = stage_v1.fused_mega_stage3d_plain(
            v1["w"], v1["bcc"], v1["bfc"], v1["u"], saved["u1"],
            saved["bfc1"], phys.eos, gam0, gam1, beta * dt, phys.dxs)
        b = phys.fill_ghosts_fc(b)
        if pool:
            u, w_, bcc_, cnt = aux.fused_aux3d_plain(
                bv.fill_ghosts(u), b, phys.eos, dxs=phys.dxs, wrap=False)
        else:
            u, w_, bcc_, cnt = aux.fused_aux3d_plain(u, b, phys.eos,
                                                     dxs=phys.dxs)
        v1 = dict(v1, u=u, w=w_, bfc=b, bcc=bcc_)
        for key, sl in (("u", INT), ("w", Ellipsis), ("bcc", Ellipsis)):
            ref = gen[key]
            err = float((v1[key][sl] - ref[sl]).abs().max())
            assert err <= 1e-10 * float(ref.abs().max()), f"{key}: {err:g}"
        bmax = max(float(v.abs().max()) for v in gen["bfc"].values())
        for c, ref in gen["bfc"].items():
            err = float((v1["bfc"][c] - ref).abs().max())
            assert err <= 1e-10 * bmax, f"{c}: {err:g}"
    np.testing.assert_allclose(float(cnt["dtmin"]),
                               float(phys.dt_from_state(gen)), rtol=1e-10)
