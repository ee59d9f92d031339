"""Parity of the stage kernel's plain version (``mega_stage_v2_plain``)
with the JAX package.

  * Against the Pallas kernel ``pallas_stage.fused_mega_stage3d_v2``
    (wrap=False) in Pallas interpret mode, float32, with the two-tier
    bound of ``test_pallas_parity._compare``: more than 95% of interior
    cells within 3e-5 of the field scale and all within 5e-3 (HLLD branch
    selects flip on float32 ulps in a few cells); dtmin within rtol 1e-4;
    floor counts equal.
  * Against the JAX general ``MHD.stage_update`` in float64 for both RK2
    stages: interior error within 1e-10 of the field maximum.
Inputs are the blast after initialisation and random physical states
from numpy's default_rng.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.athinput import ParameterInput  # noqa: E402
from athenak_tpu.main import build as jax_build  # noqa: E402
from athenak_tpu.ops import eos as jeos  # noqa: E402
from athenak_tpu.ops import pallas_stage  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.main import build as torch_build  # noqa: E402
from athenak_tpu_torch.ops import eos as teos  # noqa: E402
from athenak_tpu_torch.ops import fill, stage  # noqa: E402
from athenak_tpu_torch.state import state_from_numpy  # noqa: E402

NX = 12
N = NX + 4
DX = 1.0 / NX
DXS = {"x1": DX, "x2": DX, "x3": DX}
INT = (slice(None), slice(None), slice(2, -2), slice(2, -2), slice(2, -2))
INTF = INT[1:]
STAGES = [(0.0, 1.0, 1.0), (0.5, 0.5, 0.5)]   # rk2 (gam0, gam1, beta)


def _state(rng, dtype=np.float64):
    """Random (u, bfc) with positive density and pressure."""
    shp = (1, N, N, N)
    w = np.stack([rng.uniform(0.5, 1.5, shp), rng.uniform(-0.5, 0.5, shp),
                  rng.uniform(-0.5, 0.5, shp), rng.uniform(-0.5, 0.5, shp),
                  rng.uniform(0.5, 1.5, shp)], axis=1)
    bfc = {"x1f": rng.uniform(-0.5, 0.5, (1, N, N, N + 1)),
           "x2f": rng.uniform(-0.5, 0.5, (1, N, N + 1, N)),
           "x3f": rng.uniform(-0.5, 0.5, (1, N + 1, N, N))}
    bcc = np.stack([0.5 * (bfc["x1f"][..., :-1] + bfc["x1f"][..., 1:]),
                    0.5 * (bfc["x2f"][..., :-1, :] + bfc["x2f"][..., 1:, :]),
                    0.5 * (bfc["x3f"][:, :-1] + bfc["x3f"][:, 1:])], axis=1)
    u = np.asarray(jeos.prim_to_cons_mhd(jnp.asarray(w), jnp.asarray(bcc),
                                         jeos.EOSData()))
    return u.astype(dtype), {k: v.astype(dtype) for k, v in bfc.items()}


def _tiers(got, ref, scale, label):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    err = err / scale
    frac = float((err < 3e-5).mean())
    assert frac > 0.95, f"{label}: only {frac:.4f} of cells within 3e-5"
    assert err.max() < 5e-3, f"{label}: max scale-relative err {err.max():g}"


@pytest.fixture
def f32_interpret():
    """float32 + Pallas interpret mode, restored afterwards."""
    jax.config.update("jax_enable_x64", False)
    pallas_stage.INTERPRET = True
    yield
    pallas_stage.INTERPRET = False
    jax.config.update("jax_enable_x64", True)


def _blast_state():
    """The 12^3 blast after initialisation, float32, and its dt."""
    pin = ParameterInput.from_string(DECK.replace("precision = double",
                                                  "precision = single"))
    mesh, _, _, driver, st = torch_build(pin, device="cpu")
    st = driver.initialize(st)
    return (st["u"].numpy(), {k: v.numpy() for k, v in st["bfc"].items()},
            mesh.dt)


def _dt_of(u, bfc, eos):
    """min dx / (|v| + c_f) over the interior of a state (port formula)."""
    from athenak_tpu_torch.physics.mhd import compute_bcc, signal_speeds
    bcc = compute_bcc(bfc)
    w, _, _ = teos.cons_to_prim_mhd(u, bcc, eos)
    m = stage.interior_mask(u.shape, "cpu")
    return min(DX / float(d[:, m].max())
               for d in signal_speeds(eos, w, bcc))


@pytest.mark.parametrize("case,rk_stage", [
    ("blast", 0), ("blast", 1), ("random", 1), ("random_dfloor", 0)])
def test_plain_stage_matches_pallas_interpret(f32_interpret, case,
                                              rk_stage):
    """The state within the two-tier bound, the floor counts equal.

    dtmin: on the blast, within rtol 1e-4 of the Pallas kernel's.  On
    random fields it is held to the dt of the Pallas kernel's own output
    state instead, because that kernel averages the wrong face pair for
    its output-side bcc (faces i-1 and i in x1 and x2,
    ``pallas_stage.py:1030-1031``); its new-dt maxima, and its energy and
    temperature floor decisions, then see a field shifted by one face.
    A uniform x1 field, as in the blast, hides the shift.  The density
    floor does not depend on bcc, so the raised-floor case counts it."""
    floors = {"dfloor": 0.9} if case == "random_dfloor" else {}
    if case == "blast":
        u, bfc, dt = _blast_state()
        u1, bfc1 = u, bfc
    else:
        rng = np.random.default_rng(21 + rk_stage)
        u, bfc = _state(rng, np.float32)
        u1, bfc1 = _state(rng, np.float32)
        dt = 0.05 * DX
    gam0, gam1, beta = STAGES[rk_stage]
    bdt = float(np.float32(beta) * np.float32(dt))
    jeos_ = jeos.EOSData(**floors)
    teos_ = teos.EOSData(**floors)
    ju, jb, jc = pallas_stage.fused_mega_stage3d_v2(
        jnp.asarray(u), {k: jnp.asarray(v) for k, v in bfc.items()},
        jnp.asarray(u1), {k: jnp.asarray(v) for k, v in bfc1.items()},
        jeos_, gam0, gam1, bdt, DXS, wrap=False, want_dt=True)

    def t(a):
        return torch.from_numpy(np.array(a))

    tu, tb, tc = stage.mega_stage_v2(
        t(u), {k: t(v) for k, v in bfc.items()}, t(u1),
        {k: t(v) for k, v in bfc1.items()}, teos_, gam0, gam1, bdt, DXS)
    ref = np.asarray(ju)
    scale = np.abs(ref[INT]).max(axis=(-3, -2, -1), keepdims=True)
    _tiers(tu.numpy()[INT], ref[INT], scale, "u")
    bscale = max(float(np.abs(np.asarray(jb[c])[INTF]).max()) for c in jb)
    for c in jb:
        _tiers(tb[c].numpy()[INTF], np.asarray(jb[c])[INTF], bscale, c)
    for k in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
        assert int(tc[k]) == int(jc[k]), k
    if floors:
        assert int(tc["neos_dfloor"]) > 0
    if case == "blast":
        dt_ref = float(jc["dtmin"])
    else:
        dt_ref = _dt_of(t(ju), {k: t(v) for k, v in jb.items()}, teos_)
    np.testing.assert_allclose(float(tc["dtmin"]), dt_ref, rtol=1e-4)
    assert all(k.launches == 0 for k in kernels.ALL)


DECK = f"""
<job>
basename = stage
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
coalesce = false
pencil_pack = false
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


def test_plain_stage_matches_jax_general_stage_f64():
    _, pj, _, _, _ = jax_build(ParameterInput.from_string(DECK))
    _, pt, _, _, _ = torch_build(ParameterInput.from_string(DECK),
                                 device="cpu")
    u, bfc = _state(np.random.default_rng(4))
    sj = pj.init_ghosts(pj.make_state(
        jnp.asarray(u), jnp.zeros_like(u),
        {k: jnp.asarray(v) for k, v in bfc.items()}))
    st = state_from_numpy({"u": np.asarray(sj["u"]),
                           "bfc": {k: np.asarray(v)
                                   for k, v in sj["bfc"].items()}},
                          "cpu", torch.float64)
    assert not pt.kernel_path(st["u"])
    saved_j = pj.save_state(sj)
    u0, b0 = st["u"], st["bfc"]
    tu, tb = u0, b0
    dt = 0.3 * DX / 4.0
    for gam0, gam1, beta in STAGES:
        with jax.disable_jit():
            sj, _ = pj.stage_update(sj, saved_j, gam0, gam1, beta * dt)
        tu, tb, tc = stage.mega_stage_v2(tu, tb, u0, b0, pt.eos, gam0, gam1,
                                         beta * dt, pt.dxs)
        tu = fill.periodic_fill_cc(tu)
        tb = fill.periodic_fill_fc(tb)
        ref = np.asarray(sj["u"])
        err = np.abs(tu.numpy()[INT] - ref[INT]).max() / np.abs(ref).max()
        assert err <= 1e-10, f"u: {err:g}"
        bmax = max(float(np.abs(np.asarray(v)).max())
                   for v in sj["bfc"].values())
        for c, v in sj["bfc"].items():
            berr = np.abs(tb[c].numpy()[INTF]
                          - np.asarray(v)[INTF]).max() / bmax
            assert berr <= 1e-10, f"{c}: {berr:g}"
    np.testing.assert_allclose(float(tc["dtmin"]),
                               float(pj.dt_from_state(sj)), rtol=1e-10)
