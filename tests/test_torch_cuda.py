"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (the
CPU suite).  On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

``chip_smoke.py`` runs the same checks at the full 124^3 deck size.
"""

import os

import pytest

torch = pytest.importorskip("torch")

from athenak_tpu.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.main import build  # noqa: E402
from athenak_tpu_torch.ops import fill, stage  # noqa: E402

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
