"""Parity of the split stage's plain versions (``fused_stage3d_plain``,
``fused_ct3d_plain``) with the JAX package's Pallas kernels
``pallas_stage.fused_stage3d`` and ``fused_ct3d``, run in Pallas
interpret mode in float32.

The block is 12^3 with ghosts (16^3); the solvers are SR HLLE, SR LLF
and HLLD.  Tolerance: the two-tier bound of
``test_pallas_parity._compare``, more than 95% of the compared values
within 3e-5 of the field scale and all within 5e-3.  Compared are the
interior cells of ``acc``, the faces [2, n-2] on every axis of the mass
fluxes and face EMFs (the x3 Pallas kernel writes only those planes,
``pallas_stage.py:326-337``) and the interior faces of the new face
fields.  Inputs are random states made with ``numpy.random.default_rng``
and the SR blast after initialisation.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.ops import pallas_stage  # noqa: E402
from athenak_tpu.ops import rsolvers_mhd as jrm  # noqa: E402
from athenak_tpu.ops import rsolvers_srmhd as jrs  # noqa: E402
from athenak_tpu.ops.eos import EOSData as JEOS  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.main import build as torch_build  # noqa: E402
from athenak_tpu_torch.ops import stage_split  # noqa: E402
from athenak_tpu_torch.ops.eos import EOSData as TEOS  # noqa: E402

NX = 12
N = NX + 4
DXS = {"x1": 2.0 / NX, "x2": 2.0 / NX, "x3": 2.0 / NX}
INT = (slice(None), slice(None), slice(2, -2), slice(2, -2), slice(2, -2))
FACES = (slice(None), slice(2, -1), slice(2, -1), slice(2, -1))
INTF = INT[1:]
JSOLVER = {"sr_hlle": jrs.hlle_srmhd, "sr_llf": jrs.llf_srmhd,
           "hlld": jrm.hlld}
SR_DECK = f"""
<job>
basename = srstage
precision = single
<mesh>
nghost = 2
nx1 = {NX}
x1min = -1.0
x1max = 1.0
nx2 = {NX}
x2min = -1.0
x2max = 1.0
nx3 = {NX}
x3min = -1.0
x3max = 1.0
<coord>
special_rel = true
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 10.0
<mhd>
eos = ideal
gamma = 1.3333333333333333
reconstruct = plm
rsolver = hlle
<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 5.0
b_amb = 0.1
"""


@pytest.fixture
def f32_interpret():
    """float32 + Pallas interpret mode, restored afterwards."""
    jax.config.update("jax_enable_x64", False)
    pallas_stage.INTERPRET = True
    yield
    pallas_stage.INTERPRET = False
    jax.config.update("jax_enable_x64", True)


def _tiers(got, ref, scale, label):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    err = err / scale
    frac = float((err < 3e-5).mean())
    assert frac > 0.95, f"{label}: only {frac:.4f} within 3e-5"
    assert err.max() < 5e-3, f"{label}: max scale-relative err {err.max():g}"


def _random_inputs(rng, sr):
    """w, bcc, bfc, u0, u1 as float32 numpy arrays."""
    shp = (1, N, N, N)
    v = 1.0 if sr else 0.5
    w = np.stack([rng.uniform(0.5, 1.5, shp), rng.uniform(-v, v, shp),
                  rng.uniform(-v, v, shp), rng.uniform(-v, v, shp),
                  rng.uniform(0.5, 1.5, shp)], axis=1)
    bfc = {"x1f": rng.uniform(-0.5, 0.5, (1, N, N, N + 1)),
           "x2f": rng.uniform(-0.5, 0.5, (1, N, N + 1, N)),
           "x3f": rng.uniform(-0.5, 0.5, (1, N + 1, N, N))}
    bcc = np.stack([0.5 * (bfc["x1f"][..., :-1] + bfc["x1f"][..., 1:]),
                    0.5 * (bfc["x2f"][..., :-1, :] + bfc["x2f"][..., 1:, :]),
                    0.5 * (bfc["x3f"][:, :-1] + bfc["x3f"][:, 1:])], axis=1)
    u0 = rng.uniform(0.5, 1.5, (1, 5, N, N, N))
    u1 = rng.uniform(0.5, 1.5, (1, 5, N, N, N))
    f32 = np.float32
    return (w.astype(f32), bcc.astype(f32),
            {k: a.astype(f32) for k, a in bfc.items()}, u0.astype(f32),
            u1.astype(f32))


def _blast_inputs():
    """The 12^3 SR blast after initialisation, float32."""
    _, phys, _, driver, st = torch_build(ParameterInput.from_string(SR_DECK),
                                         device="cpu")
    st = driver.initialize(st)
    u = st["u"].numpy()
    return (st["w"].numpy(), st["bcc"].numpy(),
            {k: v.numpy() for k, v in st["bfc"].items()}, u, u)


def _j(a):
    return {k: jnp.asarray(v) for k, v in a.items()} \
        if isinstance(a, dict) else jnp.asarray(a)


def _t(a):
    return {k: torch.from_numpy(np.array(v)) for k, v in a.items()} \
        if isinstance(a, dict) else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("solver,case,gam", [
    ("sr_hlle", "random", (0.0, 1.0)), ("sr_hlle", "blast", (0.5, 0.5)),
    ("sr_llf", "random", (0.5, 0.5)), ("hlld", "random", (0.0, 1.0))])
def test_plain_stage_and_ct_match_pallas_interpret(f32_interpret, solver,
                                                   case, gam):
    """fused_stage3d, then fused_ct3d on its outputs, against the Pallas
    kernels on the same inputs."""
    sr = solver != "hlld"
    if case == "blast":
        w, bcc, bfc, u0, u1 = _blast_inputs()
    else:
        w, bcc, bfc, u0, u1 = _random_inputs(
            np.random.default_rng(len(solver) + int(gam[0] * 10)), sr)
    gamma = 4.0 / 3.0 if sr else 5.0 / 3.0
    gam0, gam1 = gam
    bdt = 0.25 * DXS["x1"] * (1.0 if gam0 == 0.0 else 0.5)
    ja, jf, je = pallas_stage.fused_stage3d(
        _j(w), _j(bcc), _j(bfc), _j(u0), _j(u1), JEOS(gamma=gamma), gam0,
        gam1, bdt, DXS, solver=JSOLVER[solver])
    ta, tf, te = stage_split.fused_stage3d(
        _t(w), _t(bcc), _t(bfc), _t(u0), _t(u1), TEOS(gamma=gamma), gam0,
        gam1, bdt, DXS, solver)
    ref = np.asarray(ja)
    scale = np.abs(ref[INT]).max(axis=(-3, -2, -1), keepdims=True)
    _tiers(ta.numpy()[INT], ref[INT], scale, "acc")
    assert set(tf) == set(jf) and set(te) == set(je)
    for name, got, exp in [(f"fden[{d}]", tf[d], jf[d]) for d in jf] + \
            [(f"emf[{e}]", te[e], je[e]) for e in je]:
        exp = np.asarray(exp)[FACES]
        _tiers(got.numpy()[FACES], exp, max(np.abs(exp).max(), 1e-30), name)

    # the CT kernels on the same (Pallas-made) fluxes and EMFs; planes
    # outside [2, n-2] of the x3 outputs are unwritten there, so both
    # sides get the torch values in place of them
    jfd = {d: np.array(v) for d, v in jf.items()}
    jem = {e: np.array(v) for e, v in je.items()}
    for got, exp in [(tf[d], jfd[d]) for d in jfd] + \
            [(te[e], jem[e]) for e in jem]:
        exp[:, :2], exp[:, -1:] = got[:, :2].numpy(), got[:, -1:].numpy()
    bfc_old = {k: v[:, ::-1].copy() * 0.5 for k, v in bfc.items()}
    jb = pallas_stage.fused_ct3d(_j(w), _j(bcc), _j(jfd), _j(jem), _j(bfc),
                                 _j(bfc_old), gam0, gam1, bdt, DXS, is_sr=sr)
    tb = stage_split.fused_ct3d(_t(w), _t(bcc), _t(jfd), _t(jem), _t(bfc),
                                _t(bfc_old), gam0, gam1, bdt, DXS, is_sr=sr)
    bscale = max(float(np.abs(np.asarray(jb[c])[INTF]).max()) for c in jb)
    for c in jb:
        _tiers(tb[c].numpy()[INTF], np.asarray(jb[c])[INTF], bscale, c)
    assert all(k.launches == 0 for k in kernels.ALL)


def test_sr_transport_velocity_in_ct(f32_interpret):
    """Under SR the corner EMFs take u^i / gamma: with is_sr the result
    differs from the Newtonian one, and each matches its Pallas twin."""
    w, bcc, bfc, u0, _ = _random_inputs(np.random.default_rng(7), True)
    rng = np.random.default_rng(8)
    cell = (1, N, N, N)
    fden = {d: rng.uniform(-1, 1, cell).astype(np.float32)
            for d in ("x1", "x2", "x3")}
    emf = {e: rng.uniform(-1, 1, cell).astype(np.float32)
           for e in ("e3x1", "e2x1", "e1x2", "e3x2", "e2x3", "e1x3")}
    out = {}
    for sr in (False, True):
        jb = pallas_stage.fused_ct3d(_j(w), _j(bcc), _j(fden), _j(emf),
                                     _j(bfc), _j(bfc), 0.5, 0.5, 0.01, DXS,
                                     is_sr=sr)
        tb = stage_split.fused_ct3d_plain(_t(w), _t(bcc), _t(fden), _t(emf),
                                          _t(bfc), _t(bfc), 0.5, 0.5, 0.01,
                                          DXS, is_sr=sr)
        bscale = max(float(np.abs(np.asarray(jb[c])[INTF]).max())
                     for c in jb)
        for c in jb:
            _tiers(tb[c].numpy()[INTF], np.asarray(jb[c])[INTF], bscale, c)
        out[sr] = tb
    assert max(float((out[True][c] - out[False][c])[INTF].abs().max())
               for c in out[True]) > 1e-4
