"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the
CPU suite).  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips the JAX set-up of ``tests/conftest.py``, which
these tests do not need).

``chip_smoke.py`` runs the same checks at the full 124^3 deck size.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from athenak_tpu.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.main import build  # noqa: E402
from athenak_tpu_torch.ops import fill, stage, stage_split  # noqa: E402

pytestmark = pytest.mark.cuda
DECK = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "inputs", "mhd", "blast.athinput")
INT = (Ellipsis, slice(2, -2), slice(2, -2), slice(2, -2))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fill_kernel_bitwise(card, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    n = 20
    a = torch.rand((2, 5, n, n, n), generator=gen, dtype=dt).to(card)
    b = a.clone()
    fill.periodic_fill_cc(a)
    fill.fill_plain(b, fill.shifts(b.shape))
    assert torch.equal(a, b)
    for comp, shape in (("x1f", (2, n, n, n + 1)), ("x2f", (2, n, n + 1, n)),
                        ("x3f", (2, n + 1, n, n))):
        a = torch.rand(shape, generator=gen, dtype=dt).to(card)
        b = a.clone()
        fill.periodic_fill_fc({comp: a})
        fill.fill_plain(b, fill.shifts(shape, comp))
        assert torch.equal(a, b), comp


def test_stage_kernel_f64(card):
    pin = ParameterInput.from_file(DECK)
    pin.modify_from_cmdline(["job/precision=double", "mesh/nx1=20",
                             "mesh/nx2=20", "mesh/nx3=20"])
    mesh, phys, _, driver, st = build(pin, device=card)
    st = driver.initialize(st)
    args = (st["u"], st["bfc"], st["u"], st["bfc"], phys.eos, 0.0, 1.0,
            mesh.dt, phys.dxs)
    n0 = kernels.MEGA_STAGE_V2.launches
    uk, bk, ck = stage.mega_stage_v2(*args)
    assert kernels.MEGA_STAGE_V2.launches == n0 + 1
    up, bp, cp = stage.mega_stage_v2_plain(*args)
    scale = float(up[INT].abs().max())
    assert float((uk[INT] - up[INT]).abs().max()) <= 1e-10 * scale
    for c in bp:
        assert float((bk[c][INT] - bp[c][INT]).abs().max()) <= 1e-10
    assert abs(float(ck["dtmin"]) - float(cp["dtmin"])) \
        <= 1e-10 * float(cp["dtmin"])
    for k in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
        assert int(ck[k]) == int(cp[k])


def test_stage_kernel_rejects_bad_input(card):
    u = torch.zeros((1, 5, 12, 12, 12), device=card, dtype=torch.float16)
    with pytest.raises(ValueError):
        stage.mega_stage_v2(u[:, :4], {}, u, {}, None, 0, 1, 0, {})
    with pytest.raises(TypeError):
        fill.periodic_fill_cc(u)


@pytest.mark.parametrize("solver", ["sr_hlle", "sr_llf", "hlld"])
def test_split_stage_kernels_f64(card, solver):
    """Kernels C and D against their plain versions in float64 on the
    20^3 blast after initialisation (SR for the SR solvers), both RK2
    stages: within 1e-10 of the field scale."""
    sr = solver != "hlld"
    extra = ["coord/special_rel=true", f"mhd/rsolver={solver[3:]}",
             "mhd/gamma=1.3333333333333333", "problem/prat=5.0"] if sr \
        else []
    pin = ParameterInput.from_file(DECK)
    pin.modify_from_cmdline(["job/precision=double", "mesh/nx1=20",
                             "mesh/nx2=20", "mesh/nx3=20"] + extra)
    mesh, phys, _, driver, st = build(pin, device=card)
    st = driver.initialize(st)
    assert phys.is_sr == sr
    w, bcc, bfc, u = st["w"], st["bcc"], st["bfc"], st["u"]
    for gam0, gam1 in ((0.0, 1.0), (0.5, 0.5)):
        args = (w, bcc, bfc, u, u, phys.eos, gam0, gam1, mesh.dt, phys.dxs,
                solver)
        n0 = kernels.FUSED_STAGE3D.launches
        ka, kf, ke = stage_split.fused_stage3d(*args)
        assert kernels.FUSED_STAGE3D.launches == n0 + 1
        pa, pf, pe = stage_split.fused_stage3d_plain(*args)
        scale = float(pa[INT].abs().max())
        assert float((ka[INT] - pa[INT]).abs().max()) <= 1e-10 * scale
        for d in pf:
            assert float((kf[d][INT] - pf[d][INT]).abs().max()) <= 1e-10
        for e in pe:
            assert float((ke[e][INT] - pe[e][INT]).abs().max()) <= 1e-10
        cargs = (w, bcc, pf, pe, bfc, bfc, gam0, gam1, mesh.dt, phys.dxs)
        n0 = kernels.FUSED_CT3D.launches
        kb = stage_split.fused_ct3d(
            w, bcc, {d: v.contiguous() for d, v in pf.items()}, *cargs[3:],
            is_sr=sr)
        assert kernels.FUSED_CT3D.launches == n0 + 1
        pb = stage_split.fused_ct3d_plain(*cargs, is_sr=sr)
        bscale = max(float(v[INT].abs().max()) for v in pb.values())
        for c in pb:
            assert float((kb[c][INT] - pb[c][INT]).abs().max()) \
                <= 1e-10 * bscale


def test_split_stage_kernels_reject_bad_input(card):
    w = torch.zeros((1, 5, 12, 12, 12), device=card)
    bcc = torch.zeros((1, 3, 12, 12, 12), device=card)
    bfc = {"x1f": torch.zeros((1, 12, 12, 13), device=card),
           "x2f": torch.zeros((1, 12, 13, 12), device=card),
           "x3f": torch.zeros((1, 13, 12, 12), device=card)}
    from athenak_tpu_torch.ops.eos import EOSData
    dxs = {"x1": 0.1, "x2": 0.1, "x3": 0.1}
    with pytest.raises(ValueError):        # unknown solver
        stage_split.fused_stage3d(w, bcc, bfc, w, w, EOSData(), 0.0, 1.0,
                                  0.1, dxs, "roe")
    with pytest.raises(TypeError):         # float64 u1 with float32 w
        stage_split.fused_stage3d(w, bcc, bfc, w, w.double(), EOSData(),
                                  0.0, 1.0, 0.1, dxs, "hlld")
    with pytest.raises(ValueError):        # a CPU tensor among CUDA ones
        stage_split.fused_stage3d(w, bcc.cpu(), bfc, w, w, EOSData(), 0.0,
                                  1.0, 0.1, dxs, "hlld")
    cell = torch.zeros((1, 12, 12, 12), device=card)
    fden = {d: cell for d in ("x1", "x2", "x3")}
    emf = {e: cell for e in ("e3x1", "e2x1", "e1x2", "e3x2", "e2x3",
                             "e1x3")}
    strided = dict(fden,
                   x1=torch.zeros((1, 12, 12, 24), device=card)[..., ::2])
    with pytest.raises(ValueError):        # not contiguous
        stage_split.fused_ct3d(w, bcc, strided, emf, bfc, bfc, 0.0, 1.0,
                               0.1, dxs)
