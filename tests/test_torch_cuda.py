"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the
CPU suite).  On a machine with a card:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(``--noconftest`` skips the JAX set-up of ``tests/conftest.py``, which
these tests do not need).

``chip_smoke.py`` runs the same checks at the full 124^3 deck size.
"""

import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

from athenak_tpu.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.main import build  # noqa: E402
from athenak_tpu_torch.ops import aux, fill, pool_fill, stage  # noqa: E402
from athenak_tpu_torch.ops import stage_split, stage_v1  # noqa: E402

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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(2, 5, 16, 20, 24), (1, 3, 9, 14, 23),
                                   (3, 2, 13, 17, 11)])
def test_fill_kernel_one_launch_ragged(card, dtype, shape):
    """Kernel B on ragged shapes and several blocks: one launch for the
    cell array, for the three face arrays together and for each one
    alone, every result bitwise the plain sweeps'."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(4)
    nmb, _, n3, n2, n1 = shape
    a = torch.rand(shape, generator=gen, dtype=dt).to(card)
    b = a.clone()
    n0 = kernels.PERIODIC_FILL_CC.launches
    fill.periodic_fill_cc(a)
    assert kernels.PERIODIC_FILL_CC.launches == n0 + 1
    assert torch.equal(a, fill.fill_plain(b, fill.shifts(b.shape)))
    fc = {"x1f": (nmb, n3, n2, n1 + 1), "x2f": (nmb, n3, n2 + 1, n1),
          "x3f": (nmb, n3 + 1, n2, n1)}
    fc = {c: torch.rand(s, generator=gen, dtype=dt).to(card)
          for c, s in fc.items()}
    ref = {c: fill.fill_plain(v.clone(), fill.shifts(v.shape, c))
           for c, v in fc.items()}
    whole = {c: v.clone() for c, v in fc.items()}
    n0 = kernels.PERIODIC_FILL_FC.launches
    fill.periodic_fill_fc(whole)
    assert kernels.PERIODIC_FILL_FC.launches == n0 + 1
    for c, v in fc.items():
        one = {c: v.clone()}
        n0 = kernels.PERIODIC_FILL_FC.launches
        fill.periodic_fill_fc(one)
        assert kernels.PERIODIC_FILL_FC.launches == n0 + 1
        assert torch.equal(whole[c], ref[c]), c
        assert torch.equal(one[c], ref[c]), c


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


def _random_stage(gen, nmb, shape, dtype, card):
    """A random conserved state and face field of nmb blocks of ``shape``
    cells (ghosts included) on the card: density and pressure in [0.2,
    0.4] or [0.6, 1.5], so floors at 0.5 bind on a share of the cells and
    no value lies within rounding of them."""
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    from athenak_tpu_torch.physics.mhd import compute_bcc
    n3, n2, n1 = shape

    def r(lo, hi, *sh):
        return lo + (hi - lo) * torch.rand(sh, generator=gen,
                                           dtype=torch.float64)

    def pos(*sh):
        low = torch.rand(sh, generator=gen, dtype=torch.float64) < 0.3
        return torch.where(low, r(0.2, 0.4, *sh), r(0.6, 1.5, *sh))

    cell = (nmb, n3, n2, n1)
    w = torch.stack([pos(*cell), r(-0.5, 0.5, *cell), r(-0.5, 0.5, *cell),
                     r(-0.5, 0.5, *cell), pos(*cell)], dim=1).to(card, dtype)
    bfc = {"x1f": r(-0.5, 0.5, nmb, n3, n2, n1 + 1),
           "x2f": r(-0.5, 0.5, nmb, n3, n2 + 1, n1),
           "x3f": r(-0.5, 0.5, nmb, n3 + 1, n2, n1)}
    bfc = {k: v.to(card, dtype) for k, v in bfc.items()}
    return prim_to_cons_mhd(w, compute_bcc(bfc), EOSData()), bfc


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("gam0,gam1", [(0.0, 1.0), (0.5, 0.5)])
@pytest.mark.parametrize("nmb,shape", [(1, (24, 24, 24)), (4, (15, 21, 17))])
def test_stage_kernel_ragged_tiles(card, dtype, gam0, gam1, nmb, shape):
    """Kernel A against its plain version where the interior is no
    multiple of the kernel's tiles (one block of 20^3 interior cells, and
    four blocks of 13 x 17 x 11), on random states whose density and
    energy floors bind: float64 within 1e-10 of the field scale, float32
    within the two-tier bound; the floor counts equal; dtmin within
    1e-10 (float64) or 1e-4 (float32)."""
    from athenak_tpu_torch.ops.eos import EOSData
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(11)
    u, bfc = _random_stage(gen, nmb, shape, dt, card)
    u1, bfc1 = _random_stage(gen, nmb, shape, dt, card)
    eos = EOSData(dfloor=0.5, pfloor=0.5 * (5.0 / 3.0 - 1.0))
    dxs = {"x1": 1 / 13, "x2": 1 / 17, "x3": 1 / 11}
    args = (u, bfc, u1, bfc1, eos, gam0, gam1, 0.01, dxs)
    n0 = kernels.MEGA_STAGE_V2.launches
    uk, bk, ck = stage.mega_stage_v2(*args)
    assert kernels.MEGA_STAGE_V2.launches == n0 + 1
    up, bp, cp = stage.mega_stage_v2_plain(*args)
    scale = float(up[INT].abs().max())
    bscale = max(float(v[INT].abs().max()) for v in bp.values())
    for got, ref, sc in [(uk, up, scale)] + [(bk[c], bp[c], bscale)
                                             for c in bp]:
        err = (got[INT] - ref[INT]).abs().double() / sc
        if dtype == "float64":
            assert float(err.max()) <= 1e-10
        else:
            assert float((err < 3e-5).double().mean()) > 0.95
            assert float(err.max()) < 5e-3
    for k in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
        assert int(ck[k]) == int(cp[k]), k
    assert int(cp["neos_dfloor"]) > 0 and int(cp["neos_efloor"]) > 0
    tol = 1e-10 if dtype == "float64" else 1e-4
    assert abs(float(ck["dtmin"]) - float(cp["dtmin"])) \
        <= tol * float(cp["dtmin"])


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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("gam0,gam1", [(0.0, 1.0), (0.5, 0.5)])
@pytest.mark.parametrize("solver", ["sr_hlle", "sr_llf", "hlld"])
def test_split_stage_kernel_ragged_tiles(card, dtype, gam0, gam1, solver):
    """Kernel C against its plain version on two blocks of 14 x 21 x 37
    cells (full and ragged tiles, wrapped stencils on every side), random
    states, with u0 not read (gam0 = 0) and read: one launch a call, every
    entry of acc, the mass fluxes and the face EMFs, ghosts included;
    float64 within 1e-10 of the field scale, float32 within the two-tier
    bound (> 95% within 3e-5, all within 5e-3)."""
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(13)
    w, bfc, bcc = _random_prims(gen, 2, (14, 21, 37), dt, card)
    w1, _, bcc1 = _random_prims(gen, 2, (14, 21, 37), dt, card)
    eos = EOSData()
    u0 = prim_to_cons_mhd(w, bcc, eos)
    u1 = prim_to_cons_mhd(w1, bcc1, eos)
    dxs = {"x1": 1 / 33, "x2": 1 / 17, "x3": 1 / 10}
    args = (w, bcc, bfc, u0, u1, eos, gam0, gam1, 0.01, dxs, solver)
    n0 = kernels.FUSED_STAGE3D.launches
    ka, kf, ke = stage_split.fused_stage3d(*args)
    assert kernels.FUSED_STAGE3D.launches == n0 + 1
    pa, pf, pe = stage_split.fused_stage3d_plain(*args)
    fscale = max(float(v.abs().max()) for v in pf.values())
    escale = max(float(v.abs().max()) for v in pe.values())
    pairs = ([(ka, pa, pa.abs().amax(dim=(-3, -2, -1), keepdim=True))]
             + [(kf[d], pf[d], fscale) for d in pf]
             + [(ke[e], pe[e], escale) for e in pe])
    for got, ref, sc in pairs:
        err = (got - ref).abs().double() / sc
        if dtype == "float64":
            assert float(err.max()) <= 1e-10
        else:
            assert float((err < 3e-5).double().mean()) > 0.95
            assert float(err.max()) < 5e-3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("sr", [True, False])
@pytest.mark.parametrize("shape", [(2, 14, 21, 37), (3, 9, 13, 37),
                                   (1, 6, 6, 6), (2, 10, 13, 44)])
def test_fused_ct_kernel_ragged_pool(card, dtype, sr, shape):
    """Kernel D against its plain version on random inputs, on pools of
    one to three blocks whose sides differ and are not multiples of the
    tiles, SR and Newtonian, with b_old read: one launch a call, every
    face of the three arrays (ghosts and the extra face of each normal
    axis included); float64 within 1e-10 of the field scale, float32
    within the two-tier bound (> 95% within 3e-5, all within 5e-3)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(23)

    def rand(*s):
        return torch.randn(s, generator=gen, dtype=torch.float64).to(
            card, dt)

    nmb, n3, n2, n1 = shape
    w, bcc = rand(nmb, 5, n3, n2, n1), rand(nmb, 3, n3, n2, n1)
    fden = {d: rand(*shape) for d in ("x1", "x2", "x3")}
    emf = {e: rand(*shape) for e in ("e3x1", "e2x1", "e1x2", "e3x2", "e2x3",
                                     "e1x3")}
    fcs = {"x1f": (nmb, n3, n2, n1 + 1), "x2f": (nmb, n3, n2 + 1, n1),
           "x3f": (nmb, n3 + 1, n2, n1)}
    bfc = {c: rand(*s) for c, s in fcs.items()}
    old = {c: rand(*s) for c, s in fcs.items()}
    dxs = {"x1": 1 / 33, "x2": 1 / 17, "x3": 1 / 10}
    args = (w, bcc, fden, emf, bfc, old, 0.5, 0.5, 0.01, dxs, sr)
    n0 = kernels.FUSED_CT3D.launches
    kb = stage_split.fused_ct3d(*args)
    assert kernels.FUSED_CT3D.launches == n0 + 1
    pb = stage_split.fused_ct3d_plain(*args)
    scale = max(float(v.abs().max()) for v in pb.values())
    for c in pb:
        assert kb[c].shape == pb[c].shape
        err = (kb[c] - pb[c]).abs().double() / scale
        if dtype == "float64":
            assert float(err.max()) <= 1e-10, c
        else:
            assert float((err < 3e-5).double().mean()) > 0.95, c
            assert float(err.max()) < 5e-3, c


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


def _random_prims(gen, nmb, n, dtype, card):
    """Random primitives with positive density and pressure, a random face
    field and its bcc, on the card; ``n`` is the cells of a block along
    each axis, or a tuple (n3, n2, n1)."""
    from athenak_tpu_torch.physics.mhd import compute_bcc

    def r(lo, hi, *shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen,
                                            dtype=torch.float64)).to(
            card, dtype)

    n3, n2, n1 = n if isinstance(n, tuple) else (n, n, n)
    cell = (nmb, n3, n2, n1)
    w = torch.stack([r(0.5, 1.5, *cell), r(-0.5, 0.5, *cell),
                     r(-0.5, 0.5, *cell), r(-0.5, 0.5, *cell),
                     r(0.5, 1.5, *cell)], dim=1)
    bfc = {"x1f": r(-0.5, 0.5, nmb, n3, n2, n1 + 1),
           "x2f": r(-0.5, 0.5, nmb, n3, n2 + 1, n1),
           "x3f": r(-0.5, 0.5, nmb, n3 + 1, n2, n1)}
    return w, bfc, compute_bcc(bfc)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("gam0,gam1", [(0.0, 1.0), (0.5, 0.5)])
def test_mega_stage_v1_kernel(card, dtype, gam0, gam1):
    """Kernel E against its plain version on random states (two blocks):
    float64 within 1e-10 of the field scale, float32 within the two-tier
    bound (> 95% within 3e-5, all within 5e-3)."""
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    w, bfc, bcc = _random_prims(gen, 2, 16, dt, card)
    _, bfc1, bcc1 = _random_prims(gen, 2, 16, dt, card)
    eos = EOSData()
    u0 = prim_to_cons_mhd(w, bcc, eos)
    u1 = prim_to_cons_mhd(w.flip(-1).contiguous(), bcc1, eos)
    dxs = {"x1": 1 / 12, "x2": 1 / 12, "x3": 1 / 12}
    args = (w, bcc, bfc, u0, u1, bfc1, eos, gam0, gam1, 0.01, dxs)
    n0 = kernels.MEGA_STAGE_V1.launches
    uk, bk = stage_v1.fused_mega_stage3d(*args)
    assert kernels.MEGA_STAGE_V1.launches == n0 + 1
    up, bp = stage_v1.fused_mega_stage3d_plain(*args)
    scale = float(up[INT].abs().max())
    bscale = max(float(v[INT].abs().max()) for v in bp.values())
    pairs = [(uk, up, scale)] + [(bk[c], bp[c], bscale) for c in bp]
    for got, ref, sc in pairs:
        err = (got[INT] - ref[INT]).abs().double() / sc
        if dtype == "float64":
            assert float(err.max()) <= 1e-10
        else:
            # HLLD branch selects may flip on float32 ulps in a few cells
            assert float((err < 3e-5).double().mean()) > 0.95
            assert float(err.max()) < 5e-3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("gam0,gam1", [(0.0, 1.0), (0.5, 0.5), (1.0, 0.0)])
@pytest.mark.parametrize("nmb,shape", [(3, (15, 21, 17)), (2, (13, 22, 19))])
def test_mega_stage_v1_kernel_ragged_tiles(card, dtype, gam0, gam1, nmb,
                                           shape):
    """Kernel E against its plain version where the interior is no
    multiple of the kernel's tiles (three blocks of 11 x 17 x 13, two of
    9 x 18 x 15), both RK2 coefficient sets and gam1 = 0 (the register is
    not read: none is passed): one launch a call, float64 within 1e-10 of
    the field scale, float32 within the two-tier bound."""
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(7)
    w, bfc, bcc = _random_prims(gen, nmb, shape, dt, card)
    w1, bfc1, bcc1 = _random_prims(gen, nmb, shape, dt, card)
    eos = EOSData()
    u0 = prim_to_cons_mhd(w, bcc, eos)
    u1 = prim_to_cons_mhd(w1, bcc1, eos)
    dxs = {"x1": 1 / 13, "x2": 1 / 17, "x3": 1 / 11}
    if gam1 == 0.0:
        u1 = bfc1 = None
    args = (w, bcc, bfc, u0, u1, bfc1, eos, gam0, gam1, 0.01, dxs)
    n0 = kernels.MEGA_STAGE_V1.launches
    uk, bk = stage_v1.fused_mega_stage3d(*args)
    assert kernels.MEGA_STAGE_V1.launches == n0 + 1
    up, bp = stage_v1.fused_mega_stage3d_plain(*args)
    scale = float(up[INT].abs().max())
    bscale = max(float(v[INT].abs().max()) for v in bp.values())
    pairs = [(uk, up, scale)] + [(bk[c], bp[c], bscale) for c in bp]
    for got, ref, sc in pairs:
        err = (got[INT] - ref[INT]).abs().double() / sc
        if dtype == "float64":
            assert float(err.max()) <= 1e-10
        else:
            assert float((err < 3e-5).double().mean()) > 0.95
            assert float(err.max()) < 5e-3


def _aux_bitwise(got, ref, label):
    """Kernel F's outputs equal the plain version's, bitwise: u, w, bcc,
    the floor counts and dtmin (the kernel repeats the plain version's
    operations in order, and its last block the torch ops of
    ``_dtmin``)."""
    for name, a, b in zip(("u", "w", "bcc"), got[:3], ref[:3]):
        assert torch.equal(a, b), f"{label} {name}"
    assert set(got[3]) == set(ref[3]), label
    for k in ref[3]:
        assert got[3][k].shape == () and got[3][k].is_cuda, f"{label} {k}"
        assert torch.equal(got[3][k], ref[3][k]), f"{label} {k}"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("wrap", [True, False])
def test_fused_aux_kernel(card, dtype, wrap):
    """Kernel F against its plain version, bitwise: u, w and bcc on the
    whole array (wrap) or pointwise, the floor counts and dtmin; one
    launch a call.  A raised pressure floor makes the energy floor
    fire."""
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(6)
    nmb = 1 if wrap else 2
    w, bfc, bcc = _random_prims(gen, nmb, 16, dt, card)
    eos = EOSData(pfloor=0.5)
    u = prim_to_cons_mhd(w, bcc, EOSData())
    dxs = {"x1": 0.1, "x2": 0.1, "x3": 0.1}
    n0 = kernels.FUSED_AUX3D.launches
    got = aux.fused_aux3d(u, bfc, eos, dxs=dxs, wrap=wrap)
    assert kernels.FUSED_AUX3D.launches == n0 + 1
    ref = aux.fused_aux3d_plain(u, bfc, eos, dxs=dxs, wrap=wrap)
    _aux_bitwise(got, ref, f"wrap={wrap}")
    assert int(ref[3]["neos_efloor"]) > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fused_aux_kernel_calls_in_a_row(card, dtype):
    """The kernel's accumulators are zeroed by each call's last block:
    calls in a row (floors firing on most cells, then on few, without
    dxs, then again) each give their own counts and dtmin, bitwise
    the plain version's, one launch each."""
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    calls = []
    for pfloor, dfloor, dxs in ((5.0, 2.0, {"x1": 0.1, "x2": 0.2, "x3": 0.3}),
                                (0.5, 0.0, {"x1": 0.3, "x2": 0.1, "x3": 0.2}),
                                (0.7, 0.9, None)):
        w, bfc, bcc = _random_prims(gen, 2, 18, dt, card)
        u = prim_to_cons_mhd(w, bcc, EOSData())
        calls.append((u, bfc, EOSData(pfloor=pfloor, dfloor=dfloor), dxs,
                      False))
    for args in calls + calls[:2]:
        n0 = kernels.FUSED_AUX3D.launches
        got = aux.fused_aux3d(*args)
        assert kernels.FUSED_AUX3D.launches == n0 + 1
        _aux_bitwise(got, aux.fused_aux3d_plain(*args),
                     f"pfloor {args[2].pfloor}")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("wrap", [True, False])
def test_fused_aux_kernel_ragged(card, dtype, wrap):
    """Kernel F where no row is a multiple of 32 cells and the extents
    differ (three blocks of 17 x 23 x 29 with ghosts), with and without
    the wrap: bitwise the plain version, one launch."""
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(10)
    w, bfc, bcc = _random_prims(gen, 3, (17, 23, 29), dt, card)
    u = prim_to_cons_mhd(w, bcc, EOSData())
    args = (u, bfc, EOSData(pfloor=0.9, dfloor=0.6),
            {"x1": 1 / 25, "x2": 1 / 19, "x3": 1 / 13}, wrap)
    n0 = kernels.FUSED_AUX3D.launches
    got = aux.fused_aux3d(*args)
    assert kernels.FUSED_AUX3D.launches == n0 + 1
    ref = aux.fused_aux3d_plain(*args)
    _aux_bitwise(got, ref, f"wrap={wrap}")
    assert int(ref[3]["neos_dfloor"]) > 0 and int(ref[3]["neos_efloor"]) > 0


def _pool_mesh(layout, nx=8):
    from athenak_tpu_torch.athinput import ParameterInput as Pin
    from athenak_tpu_torch.mesh import Mesh
    pin = Pin.from_file(DECK)
    pin.modify_from_cmdline(
        [f"mesh/nx{a}={nx * m}" for a, m in zip((1, 2, 3), layout)]
        + [f"meshblock/nx{a}={nx}" for a in (1, 2, 3)])
    return Mesh(pin)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("layout", [(2, 2, 2), (4, 2, 1), (1, 1, 2)])
def test_pool_fill_kernel_bitwise(card, dtype, layout):
    """Kernel G against the ordered sweeps of its plain version, cell and
    face arrays, bitwise."""
    dt = getattr(torch, dtype)
    mesh = _pool_mesh(layout)
    nbr = torch.as_tensor(pool_fill.neighbor27(mesh), device=card)
    nmb, n = mesh.nmb_total, 12
    gen = torch.Generator().manual_seed(7)
    shapes = {"cc": (nmb, 5, n, n, n), "x1f": (nmb, n, n, n + 1),
              "x2f": (nmb, n, n + 1, n), "x3f": (nmb, n + 1, n, n)}
    arrs = {k: torch.rand(s, generator=gen, dtype=dt).to(card)
            for k, s in shapes.items()}
    got = {k: v.clone() for k, v in arrs.items()}
    n0 = kernels.POOL_FILL.launches
    pool_fill.pool_fill_cc(got["cc"], nbr, mesh)
    pool_fill.pool_fill_fc({k: got[k] for k in ("x1f", "x2f", "x3f")}, nbr,
                           mesh)
    assert kernels.POOL_FILL.launches == n0 + 2
    ref = {k: v.clone() for k, v in arrs.items()}
    pool_fill.pool_fill_plain(list(ref.values()), list(ref), nbr, mesh)
    for k in arrs:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pool_fill_kernel_bitwise_odd_interior(card, dtype):
    """Kernel G on blocks of 7^3 interior cells (11^3 with ghosts): odd
    rows, so every array takes the single-element path; bitwise."""
    dt = getattr(torch, dtype)
    mesh = _pool_mesh((2, 1, 2), nx=7)
    nbr = torch.as_tensor(pool_fill.neighbor27(mesh), device=card)
    nmb, n = mesh.nmb_total, 11
    gen = torch.Generator().manual_seed(8)
    shapes = {"cc": (nmb, 5, n, n, n), "x1f": (nmb, n, n, n + 1),
              "x2f": (nmb, n, n + 1, n), "x3f": (nmb, n + 1, n, n)}
    arrs = {k: torch.rand(s, generator=gen, dtype=dt).to(card)
            for k, s in shapes.items()}
    got = {k: v.clone() for k, v in arrs.items()}
    pool_fill.pool_fill_cc(got["cc"], nbr, mesh)
    pool_fill.pool_fill_fc({k: got[k] for k in ("x1f", "x2f", "x3f")}, nbr,
                           mesh)
    ref = {k: v.clone() for k, v in arrs.items()}
    pool_fill.pool_fill_plain(list(ref.values()), list(ref), nbr, mesh)
    for k in arrs:
        assert torch.equal(got[k], ref[k]), k


def test_v1_kernels_reject_bad_input(card):
    from athenak_tpu_torch.ops.eos import EOSData
    w = torch.zeros((1, 5, 12, 12, 12), device=card)
    bcc = torch.zeros((1, 3, 12, 12, 12), device=card)
    bfc = {"x1f": torch.zeros((1, 12, 12, 13), device=card),
           "x2f": torch.zeros((1, 12, 13, 12), device=card),
           "x3f": torch.zeros((1, 13, 12, 12), device=card)}
    dxs = {"x1": 0.1, "x2": 0.1, "x3": 0.1}
    with pytest.raises(TypeError):         # float64 u1 with float32 w
        stage_v1.fused_mega_stage3d(w, bcc, bfc, w, w.double(), bfc,
                                    EOSData(), 0.5, 0.5, 0.1, dxs)
    with pytest.raises(ValueError):        # a CPU face array
        aux.fused_aux3d(w, dict(bfc, x3f=bfc["x3f"].cpu()), EOSData())
    mesh = _pool_mesh((2, 1, 1))
    nbr = pool_fill.neighbor27(mesh)
    with pytest.raises(ValueError):        # a block count of another mesh
        pool_fill.pool_fill_cc(w, torch.as_tensor(nbr, device=card), mesh)
    with pytest.raises(ValueError):        # a host table
        pool_fill.pool_fill_cc(torch.zeros((2, 5, 12, 12, 12), device=card),
                               nbr, mesh)


def _z4c(extra, dtype_name, deck="one_puncture"):
    """A Z4c deck of ``inputs/z4c`` (the single puncture at 16^3 unless
    ``extra`` says otherwise) on the card, initialised, with every
    channel perturbed (the shift too) and a register u1."""
    from athenak_tpu_torch.athinput import ParameterInput as Pin
    pin = Pin.from_file(os.path.join(os.path.dirname(DECK), "..", "z4c",
                                     f"{deck}.athinput"))
    if deck == "one_puncture":
        extra = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"] + list(extra)
    pin.modify_from_cmdline([f"job/precision={dtype_name}"] + list(extra))
    mesh, phys, _, driver, st = build(pin, device="cuda")
    st = driver.initialize(st)
    gen = torch.Generator().manual_seed(5)
    u = st["u"].double().cpu()
    u = u + 1e-2 * torch.randn(u.shape, generator=gen, dtype=torch.float64)
    u1 = u * (1.0 + 1e-3 * torch.randn(u.shape, generator=gen,
                                       dtype=torch.float64))
    dt = st["u"].dtype
    return phys, u.to("cuda", dt).contiguous(), u1.to("cuda", dt)


@pytest.mark.parametrize("dtype", ["single", "double"])
@pytest.mark.parametrize("ng", [2, 4, 5])
def test_z4c_stage_kernel(card, dtype, ng):
    """Kernel H against its plain version on interior cells, for the four
    RK4 coefficient sets: float32 to 2e-5 and float64 to 1e-10 of
    max(|value|, 1)."""
    from athenak_tpu_torch.driver import make_integrator
    from athenak_tpu_torch.ops import z4c_stage
    phys, u, u1 = _z4c([f"mesh/nghost={ng}"], dtype)
    rk4 = make_integrator("rk4")
    core = (slice(None), slice(None), slice(ng, -ng), slice(ng, -ng),
            slice(ng, -ng))
    tol = 2e-5 if dtype == "single" else 1e-10
    for s in range(4):
        args = (u, u1, phys, rk4.gam0[s], rk4.gam1[s], rk4.beta[s] * 0.1)
        n0 = kernels.Z4C_STAGE.launches
        got = z4c_stage.fused_z4c_stage(*args)
        assert kernels.Z4C_STAGE.launches == n0 + 1
        want = z4c_stage.fused_z4c_stage_plain(*args)
        assert kernels.Z4C_STAGE.launches == n0 + 1
        err = ((got[core] - want[core]).abs()
               / want[core].abs().clamp(min=1.0)).max()
        assert float(err) <= tol, (s, float(err))


# two blocks of 12^3 (a pool) and one block of 18 x 10 x 14 (ragged boxes
# along every axis)
Z4C_LAYOUTS = {
    "pool": ["mesh/nx1=24", "mesh/nx2=12", "mesh/nx3=12",
             "meshblock/nx1=12", "meshblock/nx2=12", "meshblock/nx3=12"],
    "ragged": ["mesh/nx1=18", "mesh/nx2=10", "mesh/nx3=14"]}


@pytest.mark.parametrize("dtype", ["single", "double"])
@pytest.mark.parametrize("layout", ["pool", "ragged"])
@pytest.mark.parametrize("ng", [2, 3, 4, 5])
def test_z4c_stage_kernel_pool_and_ragged(card, dtype, layout, ng):
    """Kernel H against its plain version on interior cells, for the four
    RK4 coefficient sets, on a pool of two blocks and on a ragged
    interior: one launch a call, float32 to 2e-5 and float64 to 1e-10 of
    max(|value|, 1)."""
    from athenak_tpu_torch.driver import make_integrator
    from athenak_tpu_torch.ops import z4c_stage
    phys, u, u1 = _z4c([f"mesh/nghost={ng}"] + Z4C_LAYOUTS[layout], dtype)
    assert u.shape[0] == (2 if layout == "pool" else 1)
    rk4 = make_integrator("rk4")
    core = (slice(None), slice(None), slice(ng, -ng), slice(ng, -ng),
            slice(ng, -ng))
    tol = 2e-5 if dtype == "single" else 1e-10
    for s in range(4):
        args = (u, u1, phys, rk4.gam0[s], rk4.gam1[s], rk4.beta[s] * 0.1)
        n0 = kernels.Z4C_STAGE.launches
        got = z4c_stage.fused_z4c_stage(*args)
        assert kernels.Z4C_STAGE.launches == n0 + 1
        want = z4c_stage.fused_z4c_stage_plain(*args)
        err = ((got[core] - want[core]).abs()
               / want[core].abs().clamp(min=1.0)).max()
        assert float(err) <= tol, (s, float(err))


@pytest.mark.parametrize("dtype", ["single", "double"])
@pytest.mark.parametrize("layout", ["pool", "ragged"])
@pytest.mark.parametrize("ng", [2, 4])
def test_z4c_stage_matter_kernel(card, dtype, layout, ng):
    """Kernel H's matter instances against the plain stage with the same
    seeded physical stress-energy (``physical_tmunu``), for the four RK4
    coefficient sets, on a pool of two blocks and on a ragged interior:
    one launch of the matter instance a call (none of the vacuum one),
    float32 to 2e-5 and float64 to 1e-10 of max(|value|, 1)."""
    from athenak_tpu_torch.driver import make_integrator
    from athenak_tpu_torch.ops import z4c_stage
    from test_torch_z4c_host import physical_tmunu, tmunu_dict
    phys, u, u1 = _z4c([f"mesh/nghost={ng}"] + Z4C_LAYOUTS[layout], dtype)
    mat = tmunu_dict(torch.from_numpy(physical_tmunu(u.shape, 7)).to(
        "cuda", u.dtype))
    rk4 = make_integrator("rk4")
    core = (slice(None), slice(None), slice(ng, -ng), slice(ng, -ng),
            slice(ng, -ng))
    tol = 2e-5 if dtype == "single" else 1e-10
    for s in range(4):
        args = (u, u1, phys, rk4.gam0[s], rk4.gam1[s], rk4.beta[s] * 0.1)
        n0 = kernels.Z4C_STAGE_MATTER.launches
        v0 = kernels.Z4C_STAGE.launches
        got = z4c_stage.fused_z4c_stage(*args, tmunu=mat)
        assert kernels.Z4C_STAGE_MATTER.launches == n0 + 1
        assert kernels.Z4C_STAGE.launches == v0
        want = z4c_stage.fused_z4c_stage_plain(*args, tmunu=mat)
        err = ((got[core] - want[core]).abs()
               / want[core].abs().clamp(min=1.0)).max()
        assert float(err) <= tol, (s, float(err))
        vac = z4c_stage.fused_z4c_stage(*args)
        assert float((vac[core] - got[core]).abs().max()) > 0.0


# the shapes of the binary-black-hole slice: the AwA gauge wave as
# shipped ([1, 22, 12, 12, 72], nghost 4 on a 4-cell x2/x3 interior,
# periodic) and the flat binary's one block of 128^3 with nghost 4
# ([1, 22, 136^3], outflow with Sommerfeld rows)
Z4C_BBH_SHAPES = {
    "gauge_wave": ("awa/gauge_wave", []),
    "binary_136": ("one_puncture", ["mesh/nghost=4"] + [
        f"{b}/nx{d}=128" for b in ("mesh", "meshblock") for d in (1, 2, 3)])}


@pytest.mark.parametrize("dtype", ["single", "double"])
@pytest.mark.parametrize("shape", sorted(Z4C_BBH_SHAPES))
def test_z4c_stage_kernel_bbh_shapes(card, dtype, shape):
    """Kernel H against its plain version at the gauge wave's and the
    flat binary's shapes, on interior cells: one launch a call, float32
    to 2e-5 and float64 to 1e-10 of max(|value|, 1); the four RK4 sets
    on the gauge wave, the first on the 136^3 block (its plain version
    takes a second a stage)."""
    from athenak_tpu_torch.driver import make_integrator
    from athenak_tpu_torch.ops import z4c_stage
    deck, extra = Z4C_BBH_SHAPES[shape]
    phys, u, u1 = _z4c(extra, dtype, deck=deck)
    assert tuple(u.shape) == ((1, 22, 12, 12, 72) if shape == "gauge_wave"
                              else (1, 22, 136, 136, 136))
    assert phys.use_stage_kernel and phys.ng == 4
    rk4 = make_integrator("rk4")
    core = (slice(None), slice(None), slice(4, -4), slice(4, -4),
            slice(4, -4))
    tol = 2e-5 if dtype == "single" else 1e-10
    for s in range(4 if shape == "gauge_wave" else 1):
        args = (u, u1, phys, rk4.gam0[s], rk4.gam1[s], rk4.beta[s] * 0.01)
        n0 = kernels.Z4C_STAGE.launches
        got = z4c_stage.fused_z4c_stage(*args)
        assert kernels.Z4C_STAGE.launches == n0 + 1
        want = z4c_stage.fused_z4c_stage_plain(*args)
        err = ((got[core] - want[core]).abs()
               / want[core].abs().clamp(min=1.0)).max()
        assert float(err) <= tol, (s, float(err))
        del got, want


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(1, 22, 12, 12, 72), (1, 22, 54, 54, 54)])
def test_fill_kernel_bitwise_z4c_channels(card, dtype, shape):
    """Kernel B on the 22 Z4c channels at the gauge wave's block shape
    and at robust stability's (50^3 with nghost 2): bitwise equal to the
    plain sweeps, one launch."""
    gen = torch.Generator().manual_seed(22)
    a = torch.rand(shape, generator=gen, dtype=getattr(torch, dtype)).to(
        card)
    b = a.clone()
    n0 = kernels.PERIODIC_FILL_CC.launches
    fill.periodic_fill_cc(a)
    assert kernels.PERIODIC_FILL_CC.launches == n0 + 1
    fill.fill_plain(b, fill.shifts(b.shape))
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ng", [2, 3, 4])
def test_z4c_outflow_fill_kernel_bitwise(card, dtype, ng):
    """Kernel I against its plain version, the outflow sweeps."""
    from athenak_tpu_torch.ops import z4c_stage
    phys, u, _ = _z4c([f"mesh/nghost={ng}"],
                      "single" if dtype == "float32" else "double")
    gen = torch.Generator().manual_seed(ng)
    a = torch.rand(u.shape, generator=gen,
                   dtype=getattr(torch, dtype)).to(card)
    b = a.clone()
    n0 = kernels.Z4C_OUTFLOW_FILL.launches
    z4c_stage.outflow_fill(a, phys.bvals)
    assert kernels.Z4C_OUTFLOW_FILL.launches == n0 + 1
    phys.bvals.fill_ghosts(b)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ng", [2, 3, 4, 5])
@pytest.mark.parametrize("aligned", [True, False])
def test_z4c_outflow_fill_kernel_ragged(card, dtype, ng, aligned):
    """Kernel I against the outflow sweeps on the ragged 18 x 10 x 14 block
    at nghost 2-5 (rows of 22-28 cells: items of 4, 2 and 1 elements),
    and on an array one element off a 16-byte boundary (items of one
    element): one launch a call, bitwise."""
    from athenak_tpu_torch.ops import z4c_stage
    phys, u, _ = _z4c([f"mesh/nghost={ng}"] + Z4C_LAYOUTS["ragged"],
                      "single" if dtype == "float32" else "double")
    gen = torch.Generator().manual_seed(ng)
    buf = torch.rand(u.numel() + 1, generator=gen,
                     dtype=getattr(torch, dtype)).to(card)
    a = (buf[:-1] if aligned else buf[1:]).view(u.shape)
    b = a.clone()
    n0 = kernels.Z4C_OUTFLOW_FILL.launches
    z4c_stage.outflow_fill(a, phys.bvals)
    assert kernels.Z4C_OUTFLOW_FILL.launches == n0 + 1
    phys.bvals.fill_ghosts(b)
    assert torch.equal(a, b)


def test_z4c_kernels_reject_bad_input(card):
    from athenak_tpu_torch.ops import z4c_stage
    phys, u, u1 = _z4c(["mesh/nghost=2"], "single")
    with pytest.raises(ValueError):        # u1 of another dtype
        z4c_stage.fused_z4c_stage(u, u1.double(), phys, 0.5, 0.5, 0.1)
    with pytest.raises(ValueError):        # u1 on the host
        z4c_stage.fused_z4c_stage(u, u1.cpu(), phys, 0.5, 0.5, 0.1)
    with pytest.raises(ValueError):        # not the mesh's shape
        z4c_stage.fused_z4c_stage(u[..., 1:], u1[..., 1:], phys, 0.5, 0.5,
                                  0.1)
    with pytest.raises(ValueError):        # not contiguous
        z4c_stage.fused_z4c_stage(u.transpose(3, 4), u1, phys, 0.5, 0.5,
                                  0.1)
    with pytest.raises(TypeError):         # half precision
        z4c_stage.fused_z4c_stage(u.half(), u1.half(), phys, 0.5, 0.5, 0.1)
    with pytest.raises(ValueError):        # not contiguous
        z4c_stage.outflow_fill(u.transpose(3, 4), phys.bvals)
    pool, _, _ = _z4c(["mesh/nx1=32", "meshblock/nx1=16", "meshblock/nx2=16",
                       "meshblock/nx3=16"], "single")
    with pytest.raises(ValueError):        # a mesh of two blocks
        z4c_stage.outflow_fill(torch.zeros(pool.shape, device=card),
                               pool.bvals)


def test_z4c_main_path_launches(card):
    """Two RK4 cycles of the 16^3 bench deck on the card in float32: the
    stage kernel and the outflow fill launch four times a cycle each; the
    float64 run takes the plain path and launches neither."""
    import chip_smoke
    from athenak_tpu_torch.athinput import ParameterInput as Pin
    from athenak_tpu_torch.main import run
    for prec, per_cycle in (("single", 4), ("double", 0)):
        pin = Pin.from_string(chip_smoke.Z4C_DECK)
        pin.modify_from_cmdline(["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
                                 f"job/precision={prec}", "time/nlim=2"])
        kernels.reset_counts()
        _, _, _, st = run(pin, device="cuda")
        assert kernels.Z4C_STAGE.launches == 2 * per_cycle
        assert kernels.Z4C_OUTFLOW_FILL.launches == 2 * per_cycle
        assert bool(torch.isfinite(st["u"]).all())


def _flux_inputs(gen, kind, dtype, card):
    """Random primitives, cell-centred and face fields on 2 blocks, or on
    the blocks of ``kind`` if it is a shape (nmb, n3, n2, n1)."""
    shp = kind if isinstance(kind, tuple) else \
        (2, 12, 10, 14) if kind == "3d" else (2, 1, 12, 16)
    nmb = shp[0]

    def uni(lo, hi, shape):
        return (lo + (hi - lo) * torch.rand(shape, generator=gen,
                                            dtype=torch.float64)).to(
            card, dtype)

    w = torch.stack([uni(0.5, 1.5, shp), uni(-0.5, 0.5, shp),
                     uni(-0.5, 0.5, shp), uni(-0.5, 0.5, shp),
                     uni(0.5, 1.5, shp)], dim=1)
    bcc = uni(-0.5, 0.5, (nmb, 3) + shp[1:])
    n3, n2, n1 = shp[1:]
    faces = {"x1": (nmb, n3, n2, n1 + 1), "x2": (nmb, n3, n2 + 1, n1),
             "x3": (nmb, n3 + 1, n2, n1)}
    return w, bcc, {k: uni(-0.5, 0.5, s) for k, s in faces.items()}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind,name", [("3d", "x1"), ("3d", "x2"),
                                       ("3d", "x3"), ("2d", "x1"),
                                       ("2d", "x2")])
def test_flux_dir_kernel(card, dtype, kind, name):
    """Kernel J against its plain version on random states with the
    face floors binding: every face within 1e-10 (float64) or 1e-5
    (float32) of the channel's scale."""
    from athenak_tpu_torch.ops import flux
    from athenak_tpu_torch.ops.eos import EOSData
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(5)
    w, bcc, bfc = _flux_inputs(gen, kind, dt, card)
    eos = EOSData(dfloor=0.6, pfloor=0.5)
    ivx = {"x1": 1, "x2": 2, "x3": 3}[name]
    n0 = kernels.FLUX_DIR.launches
    got = flux.fused_flux_dir(w, bcc, bfc[name], eos, name, ivx)
    assert kernels.FLUX_DIR.launches == n0 + 1
    ref = flux.flux_dir_plain(w, bcc, bfc[name], eos, name, ivx)
    tol = 1e-10 if dtype == "float64" else 1e-5
    for c in range(5):
        scale = float(ref[0][:, c].abs().max())
        assert float((got[0][:, c] - ref[0][:, c]).abs().max()) \
            <= tol * scale, c
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= tol * float(r.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(3, 9, 7, 5), (2, 40, 14, 38),
                                   (2, 1, 30, 27)])
def test_flux_dir_kernel_ragged_tiles(card, dtype, shape):
    """Kernel J against its plain version where the blocks are no
    multiple of its tiles (several blocks; a 2-D block), every direction
    the shape has: one launch a call, every face within 1e-10 (float64)
    or 1e-5 (float32) of the channel's scale, wrapped faces included."""
    from athenak_tpu_torch.ops import flux
    from athenak_tpu_torch.ops.eos import EOSData
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(8)
    w, bcc, bfc = _flux_inputs(gen, shape, dt, card)
    eos = EOSData(dfloor=0.6, pfloor=0.5)
    tol = 1e-10 if dtype == "float64" else 1e-5
    names = ("x1", "x2", "x3") if shape[1] > 1 else ("x1", "x2")
    for ivx, name in enumerate(names, start=1):
        n0 = kernels.FLUX_DIR.launches
        got = flux.fused_flux_dir(w, bcc, bfc[name], eos, name, ivx)
        assert kernels.FLUX_DIR.launches == n0 + 1
        ref = flux.flux_dir_plain(w, bcc, bfc[name], eos, name, ivx)
        for c in range(5):
            scale = float(ref[0][:, c].abs().max())
            assert float((got[0][:, c] - ref[0][:, c]).abs().max()) \
                <= tol * scale, (name, c)
        for g, r in zip(got[1:], ref[1:]):
            assert float((g - r).abs().max()) <= tol * float(r.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(1, 1, 1, 260), (2, 1, 1, 37)])
def test_flux_dir_kernel_1d(card, dtype, shape):
    """Kernel J on 1-D rows (n3 = n2 = 1; the bw deck's 260 cells with
    ghosts, and a ragged pair of rows) along x1: one launch a call,
    every face within 1e-10 (float64) or 1e-5 (float32) of the channel's
    scale, wrapped faces included."""
    from athenak_tpu_torch.ops import flux
    from athenak_tpu_torch.ops.eos import EOSData
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(9)
    w, bcc, bfc = _flux_inputs(gen, shape, dt, card)
    eos = EOSData(dfloor=0.6, pfloor=0.5)
    tol = 1e-10 if dtype == "float64" else 1e-5
    n0 = kernels.FLUX_DIR.launches
    got = flux.fused_flux_dir(w, bcc, bfc["x1"], eos, "x1", 1)
    assert kernels.FLUX_DIR.launches == n0 + 1
    ref = flux.flux_dir_plain(w, bcc, bfc["x1"], eos, "x1", 1)
    for c in range(5):
        scale = float(ref[0][:, c].abs().max())
        assert float((got[0][:, c] - ref[0][:, c]).abs().max()) \
            <= tol * scale, c
    for g, r in zip(got[1:], ref[1:]):
        assert float((g - r).abs().max()) <= tol * float(r.abs().max())


@pytest.mark.parametrize("extra,expect", [
    ([], {"mega_stage_v2": 4, "periodic_fill_cc": 7,
          "periodic_fill_fc": 7}),
    (["mhd/eos=isothermal"], {"periodic_fill_cc": 5, "periodic_fill_fc": 5}),
    (["mhd/nscalars=1"], {"periodic_fill_cc": 5, "periodic_fill_fc": 5}),
    (["mhd/rsolver=llf"], {"periodic_fill_cc": 5, "periodic_fill_fc": 5}),
    (["mhd/reconstruct=dc"], {"periodic_fill_cc": 5,
                              "periodic_fill_fc": 5}),
    (["mesh/nx3=1"], {"fused_flux_dir": 8})])
def test_mhd_tail_routes(card, extra, expect):
    """Two float32 cycles of the 3-D MHD linear wave at 16 x 8 x 8 (one
    periodic block) on the card: kernel A and B on the ideal PLM + HLLD
    deck; isothermal, scalar, LLF and DC decks take the general path
    with no A, C, D, E or J launch (kernel D's gate is the JAX
    package's ``use_pallas``), B filling u and the faces; the 2-D deck
    takes J twice a stage.  Exact launch counts."""
    from athenak_tpu_torch.athinput import ParameterInput as Pin
    from athenak_tpu_torch.main import run
    path = os.path.join(os.path.dirname(DECK), "..", "tests",
                        "linear_wave_mhd.athinput")
    pin = Pin.from_file(path)
    pin.modify_from_cmdline(["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8",
                             "job/precision=single", "time/nlim=2", *extra])
    kernels.reset_counts()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            _, _, _, st = run(pin, device="cuda")
        finally:
            os.chdir(cwd)
    got = {k.name: k.launches for k in kernels.ALL if k.launches}
    assert got == expect
    assert bool(torch.isfinite(st["u"]).all())


@pytest.mark.parametrize("extra,expect", [
    ([], {"periodic_fill_cc": 5}),
    (["meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8"],
     {"pool_fill": 5}),
    (["hydro/use_kernels=false"], {}),
    (["hydro/reconstruct=ppm4", "mesh/nghost=3"], {})])
def test_hydro_routes(card, extra, expect):
    """Two float32 cycles of the driven hydro deck at 16^3 on the card:
    the only kernels are the fills, B on a single block and G on a
    pool, once at initialisation and once a stage; none with
    ``hydro/use_kernels=false`` or three ghost cells."""
    from athenak_tpu_torch.athinput import ParameterInput as Pin
    from athenak_tpu_torch.main import run
    path = os.path.join(os.path.dirname(DECK), "..", "hydro",
                        "turb.athinput")
    pin = Pin.from_file(path)
    pin.modify_from_cmdline(["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
                             "job/precision=single", "time/nlim=2", *extra])
    kernels.reset_counts()
    _, _, _, st = run(pin, device="cuda")
    got = {k.name: k.launches for k in kernels.ALL if k.launches}
    assert got == expect
    assert bool(torch.isfinite(st["u"]).all())


def test_flux_dir_kernel_rejects_bad_input(card):
    from athenak_tpu_torch.ops import flux
    from athenak_tpu_torch.ops.eos import EOSData
    gen = torch.Generator().manual_seed(6)
    w, bcc, bfc = _flux_inputs(gen, "3d", torch.float32, card)
    eos = EOSData()
    with pytest.raises(TypeError):
        flux.fused_flux_dir(w.half(), bcc, bfc["x1"], eos, "x1", 1)
    with pytest.raises(ValueError):
        flux.fused_flux_dir(w, bcc.cpu(), bfc["x1"], eos, "x1", 1)
    with pytest.raises(ValueError):
        flux.fused_flux_dir(w, bcc, bfc["x2"], eos, "x1", 1)
    with pytest.raises(ValueError):
        flux.fused_flux_dir(w, bcc, bfc["x1"], eos, "x1", 2)


def test_smr_main_path_kernel_vs_plain(card):
    """Two cycles of the 2-D SMR deck (28 blocks, two levels) on the card
    in float32: kernel J launches twice a stage, and the state agrees
    with the plain path's (``mhd/use_kernels = false``, no face floors)
    under the two-tier bound; div(B) stays at round-off."""
    import chip_smoke
    from athenak_tpu_torch.main import read_deck, run
    out = {}
    for use in ("true", "false"):
        pin = read_deck(chip_smoke.OT_DECK, chip_smoke.OT_SMR + [
            "job/precision=single", "time/nlim=2",
            f"mhd/use_kernels={use}"])
        kernels.reset_counts()
        mesh, phys, _, st = run(pin, device="cuda")
        assert kernels.FLUX_DIR.launches == (8 if use == "true" else 0)
        assert bool(torch.isfinite(st["u"]).all())
        out[use] = st
    a, b = out["true"]["u"][INT[:1] + INT[2:]], out["false"]["u"]
    b = b[INT[:1] + INT[2:]]
    err = ((a - b).abs() / b.abs().amax(dim=(0, 2, 3, 4), keepdim=True)
           .clamp(min=1e-30)).double()
    assert float((err < 3e-5).double().mean()) > 0.95
    assert float(err.max()) < 5e-3


@pytest.mark.parametrize("extra,expect", [
    (["mhd/fofc=true"], {"fused_flux_dir": 12, "fused_ct3d": 4,
                         "periodic_fill_cc": 5, "periodic_fill_fc": 5}),
    (["mhd_srcterms/const_accel=true", "mhd_srcterms/const_accel_val=-0.1",
      "mhd_srcterms/const_accel_dir=2"],
     {"fused_flux_dir": 12, "fused_ct3d": 4, "periodic_fill_cc": 5,
      "periodic_fill_fc": 5}),
    (["mhd/fofc=true", "mesh/nx3=1"], {"fused_flux_dir": 8})])
def test_fofc_and_srcterms_routes(card, extra, expect):
    """Two float32 cycles of the MHD linear wave at 16 x 8 x 8 on the
    card with FOFC or a constant acceleration: the stage kernels A, C and
    E are closed (as in the JAX gates), the general path takes kernel J
    once a direction a stage and kernel D once a stage, B fills u and
    the faces; the 2-D deck takes J alone.  Exact launch counts; with
    a poked cell FOFC fires and D still runs."""
    from athenak_tpu_torch.athinput import ParameterInput as Pin
    from athenak_tpu_torch.main import build
    path = os.path.join(os.path.dirname(DECK), "..", "tests",
                        "linear_wave_mhd.athinput")
    pin = Pin.from_file(path)
    pin.modify_from_cmdline(["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8",
                             "job/precision=single", "time/nlim=2", *extra])
    kernels.reset_counts()
    mesh, phys, _, driver, st = build(pin, device="cuda")
    st = driver.initialize(st)
    if phys.use_fofc:
        # one cell's total energy scaled by 1e-12, the primitives left as
        # initialised: the trial update of that cell falls below its
        # magnetic energy, and the energy floor fires
        u = st["u"].clone()
        u[0, 4, mesh.mb_indcs.ks, 6, 8] *= 1e-12
        st = dict(st, u=u)
    st = driver.execute(st)
    got = {k.name: k.launches for k in kernels.ALL if k.launches}
    assert got == expect
    if phys.use_fofc:
        assert driver.ecounters["nfofc"] > 0
    assert bool(torch.isfinite(st["u"]).all())


def test_turb_deck_launches(card):
    """``inputs/turb/turb.athinput`` (hydro, FOFC, driven, float32) at
    16^3 for two cycles: kernel B on u at initialisation and once a
    stage, nothing else; the history file written."""
    from athenak_tpu_torch.main import read_deck, run
    path = os.path.join(os.path.dirname(DECK), "..", "turb",
                        "turb.athinput")
    pin = read_deck(path, ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
                           "time/nlim=2"])
    kernels.reset_counts()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            _, phys, driver, st = run(pin, device="cuda")
            rows = open("Turb.hst").read().splitlines()
        finally:
            os.chdir(cwd)
    got = {k.name: k.launches for k in kernels.ALL if k.launches}
    assert got == {"periodic_fill_cc": 5}
    assert phys.use_fofc and "nfofc" in driver.ecounters and len(rows) == 4
    assert bool(torch.isfinite(st["u"]).all())


@pytest.mark.parametrize("label,deck,block,extra", [
    ("blast_amr", "mhd/blast_amr.athinput", "mhd", []),
    ("blast_amr_nopool", "mhd/blast_amr.athinput", "mhd",
     ["mesh_refinement/block_pool=false"]),
    ("z4c_amr", "z4c/one_puncture_amr.athinput", "z4c",
     ["job/precision=single", "mesh/nx1=16", "mesh/nx2=16",
      "mesh/nx3=16"])])
def test_amr_routes_and_launches(card, label, deck, block, extra):
    """The adaptive decks in float32 (``chip_smoke``'s phase-17 rules;
    the blast refines at cycle 12, the puncture at cycle 1): the
    block-pool route launches J three times a stage
    and nothing else; without the pool A runs twice a cycle on the flat
    tree, G as ``chip_smoke.pool_fill_expect`` counts its fills there,
    and J three times a stage once it refines; the Z4c pool runs H
    four times a cycle while flat and never on the refined tree, and I
    never.  The tree refines, and both paths take the same trees."""
    import chip_smoke
    path = os.path.join(os.path.dirname(DECK), "..", deck)
    n = 3 if block == "z4c" else 14
    trees = {}
    for use in ("true", "false"):
        launches, mesh, phys, _, st, rec = chip_smoke.amr_cli(
            torch, kernels, path, n, extra + [f"{block}/use_kernels={use}"])
        chip_smoke.amr_expect(label, launches, rec, n, use)
        assert rec["trees"] and 0 < rec["flat_cycles"] < n
        assert bool(torch.isfinite(st["u"]).all())
        trees[use] = rec["trees"]
        if block == "z4c":
            assert not phys.use_stage_kernel and phys.multilevel
    assert trees["true"] == trees["false"]


# ------------------------------------------------------------------ GR
def _gr_state(dev, mhd):
    """Random primitives around a spinning hole whose c2p hits every fix
    (floors, the ceiling, excision, non-finite momenta), the metric and
    the excision mask, float64 on ``dev``."""
    import numpy as np
    from athenak_tpu_torch.gr import cks
    from athenak_tpu_torch.ops import eos as teos
    from athenak_tpu_torch.ops import eos_gr
    rng = np.random.default_rng(5)
    shape = (2, 10, 11, 12)
    x, y, z = (rng.uniform(-5.0, 5.0, shape) for _ in range(3))
    a = 0.9375
    rad2 = x * x + y * y + z * z
    rk = np.sqrt(0.5 * (rad2 - a * a + np.sqrt((rad2 - a * a) ** 2
                                               + 4 * a * a * z * z)))
    w = np.concatenate([rng.uniform(0.01, 2.0, (2, 1) + shape[1:]),
                        rng.uniform(-3.0, 3.0, (2, 3) + shape[1:]),
                        rng.uniform(0.01, 2.0, (2, 1) + shape[1:])], axis=1)
    bcc = rng.uniform(-1.0, 1.0, (2, 3) + shape[1:])
    eos = teos.EOSData(gamma=4.0 / 3.0, is_ideal=True, dfloor=0.05,
                       pfloor=0.02, gamma_max=3.0)
    t = {k: torch.tensor(v, device=dev) for k, v in (
        ("x", x), ("y", y), ("z", z), ("w", w), ("bcc", bcc))}
    gl, gu = cks.metric(t["x"], t["y"], t["z"], a)
    if mhd:
        u = eos_gr.prim_to_cons_gr_mhd(t["w"], t["bcc"], eos, gl, gu)
    else:
        u = eos_gr.prim_to_cons_gr_hydro(t["w"], eos, gl, gu)
    m = torch.tensor(rng.random(shape), device=dev)
    u[:, 0] = torch.where(m < 0.1, u[:, 0] * 0.01, u[:, 0])
    u[:, 4] = torch.where((m > 0.1) & (m < 0.2), u[:, 4] * 0.001, u[:, 4])
    u[:, 4] = torch.where((m > 0.2) & (m < 0.25), -u[:, 4], u[:, 4])
    u[:, 1] = torch.where((m > 0.25) & (m < 0.3), u[:, 1] * 1e3, u[:, 1])
    u[:, 3] = torch.where((m > 0.35) & (m < 0.38),
                          torch.full_like(u[:, 3], float("nan")), u[:, 3])
    return u, t["bcc"], eos, gl, gu, torch.tensor(rk <= 1.0, device=dev)


@pytest.mark.parametrize("mhd", [False, True], ids=["hydro", "mhd"])
def test_gr_c2p_card_matches_cpu(card, mhd):
    """The GR c2p and p2c on the card against the CPU, float64, 1e-12 of
    each output's scale, the counters equal."""
    from athenak_tpu_torch.ops import eos_gr
    out = {}
    for dev in ("cpu", card):
        u, bcc, eos, gl, gu, exc = _gr_state(dev, mhd)
        kw = dict(excise_mask=exc, dexcise=1e-3, pexcise=1e-4)
        if mhd:
            w, uf, cnt = eos_gr.cons_to_prim_gr_mhd(u, bcc, eos, gl, gu, **kw)
            back = eos_gr.prim_to_cons_gr_mhd(w, bcc, eos, gl, gu)
        else:
            w, uf, cnt = eos_gr.cons_to_prim_gr_hydro(u, eos, gl, gu, **kw)
            back = eos_gr.prim_to_cons_gr_hydro(w, eos, gl, gu)
        out[str(dev)] = (w.cpu(), uf.cpu(), back.cpu(),
                         {k: int(v) for k, v in cnt.items()})
    ref, got = out["cpu"], out[str(card)]
    for a, b in zip(got[:3], ref[:3]):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    assert got[3] == ref[3] and all(v > 0 for v in ref[3].values())


def test_gr_torus_no_kernel_launches(card):
    """The 32 x 32 x 16 magnetised torus (``tests/test_gr_torus.py``'s
    deck) in float32, 3 cycles: GR closes every kernel, so none
    launches; the state stays finite."""
    text = """
<job>
basename = torus
precision = single
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
a = 0.9375
excise = true
dexcise = 1.0e-8
pexcise = 0.333e-10
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 5.0
<mhd>
eos = ideal
reconstruct = plm
rsolver = hlle
gamma = 1.4444444444444444
fofc = true
<problem>
pgen_name = gr_torus
r_edge = 6.0
r_peak = 12.0
b_norm = 0.1
pert_amp = 0.02
"""
    from athenak_tpu_torch.athinput import ParameterInput as TorchInput
    mesh, phys, _, driver, state = build(TorchInput.from_string(text),
                                         device="cuda")
    kernels.reset_counts()
    state = driver.initialize(state)
    driver.nlim = 3
    state = driver.execute(state)
    assert mesh.ncycle == 3 and phys.is_gr
    assert all(k.launches == 0 for k in kernels.ALL)
    for key in ("u", "w", "bcc"):
        assert bool(torch.isfinite(state[key]).all()), key
    assert state["u"].dtype == torch.float32 and state["u"].is_cuda


def _deck_run(rel, overrides, ncyc):
    """A deck of ``inputs/`` with overrides on the card for ncyc cycles,
    the launch counts set to 0 before the initial fill: (launches of the
    kernels that launched, mesh, phys, driver, state)."""
    from athenak_tpu_torch.athinput import ParameterInput as TorchInput
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pin = TorchInput.from_file(os.path.join(root, "inputs", rel))
    pin.modify_from_cmdline(list(overrides) + ["time/tlim=1e6"])
    mesh, phys, _, driver, state = build(pin, device="cuda")
    kernels.reset_counts()
    state = driver.initialize(state)
    driver.nlim = ncyc
    state = driver.execute(state)
    assert driver.mesh.ncycle == ncyc
    assert bool(torch.isfinite(state["u"]).all())
    return ({k.name: k.launches for k in kernels.ALL if k.launches},
            driver.mesh, driver.phys, driver, state)


@pytest.mark.parametrize("eta", [True, False])
def test_diffusive_blast_launches(card, eta):
    """The 16^3 blast in float32 with viscosity and conduction, with and
    without Ohmic resistivity: J three times a stage, B at every fill, A
    never, D once a stage only without resistivity."""
    extra = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
             "mhd/nu_iso=1e-3", "mhd/alpha_iso=1e-3"] \
        + (["mhd/eta_ohm=1e-3"] if eta else [])
    got, *_ = _deck_run("mhd/blast.athinput", extra, 3)
    want = {"fused_flux_dir": 18, "periodic_fill_cc": 7,
            "periodic_fill_fc": 7}
    if not eta:
        want["fused_ct3d"] = 6
    assert got == want


def test_jeans_fft_fill_launches(card):
    """The Jeans deck in float32 on one block: B fills u at the start and
    u and phi at every stage."""
    got, *_ = _deck_run("tests/jeans_wave.athinput", [
        "job/precision=single", "mesh/nx1=32", "mesh/nx2=16",
        "mesh/nx3=16"], 3)
    assert got == {"periodic_fill_cc": 13}


def test_be_collapse_pool_fill_launches(card):
    """The Bonnor-Ebert collapse in float32 on a 32^3 root of 8^3 blocks
    with two ghost cells: G fills u and phi while the tree is flat (five
    cycles; the centre refines at cycle 5), nothing after."""
    got, mesh, *_ = _deck_run("tests/be_collapse.athinput", [
        "job/precision=single", "mesh/nghost=2", "mesh/nx1=32",
        "mesh/nx2=32", "mesh/nx3=32", "meshblock/nx1=8", "meshblock/nx2=8",
        "meshblock/nx3=8", "problem/njeans=8"], 7)
    assert mesh.multilevel and mesh.nmb_total == 120
    assert got == {"pool_fill": 1 + 4 * 5}


def test_be_collapse_mhd_flux_launches(card):
    """be_collapse_mhd in float32 on a 32^3 root of 8^3 blocks (four ghost
    cells: D's gate is closed): J three times a stage, nothing else."""
    got, *_ = _deck_run("tests/be_collapse_mhd.athinput", [
        "job/precision=single", "mesh/nx1=32", "mesh/nx2=32",
        "mesh/nx3=32", "meshblock/nx1=8", "meshblock/nx2=8",
        "meshblock/nx3=8", "output1/dt=100", "output2/dt=100",
        "output3/dt=100", "output4/dt=100"], 3)
    assert got == {"fused_flux_dir": 18}
