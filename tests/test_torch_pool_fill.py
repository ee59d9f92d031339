"""Parity of the port's pool fill (``athenak_tpu_torch/ops/pool_fill.py``)
with the JAX package.

  * ``neighbor27``: the same donor table as the JAX package's.
  * The plain version (the ordered x3 -> x2 -> x1 slab copies) against the
    JAX ``pool_fill`` in Pallas interpret mode, float32, bitwise, cell and
    face arrays, over three block layouts.
  * The same against the port's and the JAX package's general sweep
    fills (``fill_ghosts``, ``fill_ghosts_fc``) in float64, bitwise:
    every ghost is a copy of one interior element, whatever the order.
Inputs are random arrays from numpy's default_rng, ghosts included.  The
JAX side runs under ``jax.jit`` at XLA's backend optimisation level 0,
which compiles faster on the CPU; a copy is a copy at any level.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.athinput import ParameterInput  # noqa: E402
from athenak_tpu.main import build as jax_build  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu.ops import pallas_pool_fill  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput as TorchInput  # noqa
from athenak_tpu_torch.main import build as torch_build  # noqa: E402
from athenak_tpu_torch.mesh import Mesh as TorchMesh  # noqa: E402
from athenak_tpu_torch.ops import pool_fill  # noqa: E402

NB = 8          # cells of a block along each axis
LAYOUTS = [(2, 2, 2), (4, 2, 1), (1, 1, 2)]   # blocks along x1, x2, x3

DECK = """
<job>
basename = pool
<mesh>
nghost = 2
nx1 = {n1}
x1min = -0.5
x1max = 0.5
nx2 = {n2}
x2min = -0.5
x2max = 0.5
nx3 = {n3}
x3min = -0.5
x3max = 0.5
coalesce = false
pencil_pack = false
<meshblock>
nx1 = {nb}
nx2 = {nb}
nx3 = {nb}
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


def _deck(layout):
    return DECK.format(n1=NB * layout[0], n2=NB * layout[1],
                       n3=NB * layout[2], nb=NB)


def _arrays(nmb, dtype, seed=3):
    """Random cell and face arrays of nmb blocks, keyed by pool-fill kind."""
    rng = np.random.default_rng(seed)
    n = NB + 4
    shapes = {"cc": (nmb, 5, n, n, n), "x1f": (nmb, n, n, n + 1),
              "x2f": (nmb, n, n + 1, n), "x3f": (nmb, n + 1, n, n)}
    return {k: rng.normal(size=s).astype(dtype) for k, s in shapes.items()}


def _jit_o0(fn):
    """``jax.jit`` at backend optimisation level 0."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture
def f32_interpret():
    """float32 + Pallas interpret mode, restored afterwards."""
    jax.config.update("jax_enable_x64", False)
    pallas_pool_fill.INTERPRET = True
    yield
    pallas_pool_fill.INTERPRET = False
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_neighbor27_matches_jax(layout):
    mt = TorchMesh(TorchInput.from_string(_deck(layout)))
    mj = JaxMesh(ParameterInput.from_string(_deck(layout)))
    assert mt.nmb_total == mj.nmb_total == int(np.prod(layout))
    assert pool_fill.supports_pool_fill(mt)
    np.testing.assert_array_equal(pool_fill.neighbor27(mt),
                                  pallas_pool_fill.neighbor27(mj))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_pool_fill_matches_pallas_interpret(f32_interpret, layout):
    mt = TorchMesh(TorchInput.from_string(_deck(layout)))
    mj = JaxMesh(ParameterInput.from_string(_deck(layout)))
    arrs = _arrays(mt.nmb_total, np.float32)
    nbr = pool_fill.neighbor27(mt)
    ref_u, ref_b = _jit_o0(lambda u, b: (
        pallas_pool_fill.pool_fill_cc(u, nbr, mj),
        pallas_pool_fill.pool_fill_fc(b, nbr, mj)))(
        jnp.asarray(arrs["cc"]),
        {k: jnp.asarray(arrs[k]) for k in ("x1f", "x2f", "x3f")})
    got = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    out_u = pool_fill.pool_fill_cc(got["cc"], nbr, mt)
    out_b = pool_fill.pool_fill_fc(
        {k: got[k] for k in ("x1f", "x2f", "x3f")}, nbr, mt)
    assert out_u is got["cc"]           # filled in place
    np.testing.assert_array_equal(got["cc"].numpy(), np.asarray(ref_u))
    for k in ("x1f", "x2f", "x3f"):
        assert out_b[k] is got[k]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref_b[k]),
                                      err_msg=k)
    # the ghosts changed, the interiors did not
    assert not np.array_equal(got["cc"].numpy(), arrs["cc"])
    np.testing.assert_array_equal(got["cc"].numpy()[..., 2:-2, 2:-2, 2:-2],
                                  arrs["cc"][..., 2:-2, 2:-2, 2:-2])
    assert kernels.POOL_FILL.launches == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_pool_fill_matches_sweep_fills_f64(layout):
    """Bitwise equal to the port's general sweeps (x1 -> x2 -> x3, the
    pool gate switched off) and to the JAX package's, in float64."""
    mj, pj, _, _, _ = jax_build(ParameterInput.from_string(_deck(layout)))
    mt, pt, _, _, _ = torch_build(TorchInput.from_string(_deck(layout)),
                                  device="cpu")
    assert pt.bvals.use_pool_fill and not pt.bvals.pool_fill_active(
        torch.zeros(1, dtype=torch.float64))
    arrs = _arrays(mt.nmb_total, np.float64, seed=4)
    nbr = pt.bvals.nbr27()
    fcs = ("x1f", "x2f", "x3f")
    got = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    pool_fill.pool_fill_cc(got["cc"], nbr, mt)
    pool_fill.pool_fill_fc({k: got[k] for k in fcs}, nbr, mt)
    sweep_u = pt.bvals.fill_ghosts(torch.from_numpy(arrs["cc"].copy()))
    sweep_b = pt.fill_ghosts_fc({k: torch.from_numpy(arrs[k].copy())
                                 for k in fcs})
    jax_u, jax_b = _jit_o0(lambda u, b: (pj.bvals.fill_ghosts(u),
                                         pj.fill_ghosts_fc(b)))(
        jnp.asarray(arrs["cc"]), {k: jnp.asarray(arrs[k]) for k in fcs})
    jax_u = np.asarray(jax_u)
    np.testing.assert_array_equal(got["cc"].numpy(), sweep_u.numpy())
    np.testing.assert_array_equal(got["cc"].numpy(), jax_u)
    for k in fcs:
        np.testing.assert_array_equal(got[k].numpy(), sweep_b[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jax_b[k]),
                                      err_msg=k)
