"""Parity of the port's ghost fills with the JAX package.

The plain version of the periodic fill kernel (cell array and the three
face arrays) must equal, bit for bit:
  * the Pallas kernels ``pallas_fill.periodic_fill_cc/fc`` run in Pallas
    interpret mode in float32;
  * the JAX general path (``BoundaryValues.fill_ghosts``,
    ``MHD.fill_ghosts_fc``) in float64.
The port's general sweep fill is held to the JAX general path on a
periodic and an outflow deck as well.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.athinput import ParameterInput  # noqa: E402
from athenak_tpu.main import build as jax_build  # noqa: E402
from athenak_tpu.ops import pallas_fill  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.main import build as torch_build  # noqa: E402
from athenak_tpu_torch.ops import fill  # noqa: E402

NX = 12


def _deck(bc: str) -> str:
    mesh = "\n".join(f"{s}x{a}_bc = {bc}" for a in (1, 2, 3)
                     for s in ("i", "o"))
    return f"""
<job>
basename = fill
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
{mesh}
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


def _random(rng, dtype=np.float64):
    n = NX + 4
    cc = rng.normal(size=(1, 5, n, n, n)).astype(dtype)
    fc = {"x1f": rng.normal(size=(1, n, n, n + 1)).astype(dtype),
          "x2f": rng.normal(size=(1, n, n + 1, n)).astype(dtype),
          "x3f": rng.normal(size=(1, n + 1, n, n)).astype(dtype)}
    return cc, fc


@pytest.fixture
def f32_interpret():
    """float32 + Pallas interpret mode, restored afterwards."""
    jax.config.update("jax_enable_x64", False)
    pallas_fill.INTERPRET = True
    yield
    pallas_fill.INTERPRET = False
    jax.config.update("jax_enable_x64", True)


def test_plain_fill_matches_pallas_interpret(f32_interpret):
    cc, fc = _random(np.random.default_rng(5), np.float32)
    ref_cc = np.asarray(pallas_fill.periodic_fill_cc(jnp.asarray(cc)))
    ref_fc = pallas_fill.periodic_fill_fc(
        {k: jnp.asarray(v) for k, v in fc.items()})
    got_cc = fill.periodic_fill_cc(torch.from_numpy(cc.copy()))
    got_fc = fill.periodic_fill_fc(
        {k: torch.from_numpy(v.copy()) for k, v in fc.items()})
    np.testing.assert_array_equal(got_cc.numpy(), ref_cc)
    for k in fc:
        np.testing.assert_array_equal(got_fc[k].numpy(),
                                      np.asarray(ref_fc[k]), err_msg=k)
    # on the CPU the wrappers run the plain version and launch nothing
    assert all(k.launches == 0 for k in kernels.ALL)


def _jax_and_torch(bc):
    pin_j = ParameterInput.from_string(_deck(bc))
    pin_t = ParameterInput.from_string(_deck(bc))
    _, pj, _, _, _ = jax_build(pin_j)
    _, pt, _, _, _ = torch_build(pin_t, device="cpu")
    return pj, pt


@pytest.mark.parametrize("bc", ["periodic", "outflow"])
def test_fills_match_jax_general_path(bc):
    pj, pt = _jax_and_torch(bc)
    assert pt.bvals.use_fill_kernel == (bc == "periodic")
    cc, fc = _random(np.random.default_rng(9))
    ref_cc = np.asarray(pj.bvals.fill_ghosts(jnp.asarray(cc)))
    ref_fc = pj.fill_ghosts_fc({k: jnp.asarray(v) for k, v in fc.items()})
    # the port's general sweeps (the path a CPU tensor takes)
    got_cc = pt.bvals.fill_ghosts(torch.from_numpy(cc.copy()))
    got_fc = pt.fill_ghosts_fc(
        {k: torch.from_numpy(v.copy()) for k, v in fc.items()})
    np.testing.assert_array_equal(got_cc.numpy(), ref_cc)
    for k in fc:
        np.testing.assert_array_equal(got_fc[k].numpy(),
                                      np.asarray(ref_fc[k]), err_msg=k)
    if bc == "periodic":
        # the fill kernel's plain version
        got_cc = fill.periodic_fill_cc(torch.from_numpy(cc.copy()))
        got_fc = fill.periodic_fill_fc(
            {k: torch.from_numpy(v.copy()) for k, v in fc.items()})
        np.testing.assert_array_equal(got_cc.numpy(), ref_cc)
        for k in fc:
            np.testing.assert_array_equal(got_fc[k].numpy(),
                                          np.asarray(ref_fc[k]), err_msg=k)
