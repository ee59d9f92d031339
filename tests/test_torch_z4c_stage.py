"""The Z4c stage of the port against the JAX package's jnp stage, on the
CPU.

The JAX Pallas kernel is held to the jnp stage (rhs -> RK combine ->
alg_constr) by ``tests/test_pallas_z4c.py``; here the port's plain
stage, which ``ops/z4c_stage.py`` runs for CPU tensors and which the
CUDA kernel is held to on the card, is held to the same jnp stage with
the four RK4 coefficient sets: float64 to 1e-10 on a two-block outflow
pool (mesh 32x16x16, blocks of 16^3) and float32 (JAX with 64-bit types
off) to 2e-5 on one block, of max(|value|, 1) on interior cells.  On the
pool one stage also runs the kernel path's way (stage, then the sweep
fill) against the JAX stage_update.  The outflow fill's plain version
(the port's sweep fill) is held bitwise to the JAX package's.  The JAX
side runs outside ``jax.jit`` (see ``tests/test_torch_z4c_ops.py``).
"""

import os
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.driver import make_integrator  # noqa: E402
from athenak_tpu_torch.ops import z4c_stage  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PUNCTURE = os.path.join(ROOT, "inputs", "z4c", "one_puncture.athinput")
SMALL = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
         "mesh/x1min=-4.0", "mesh/x1max=4.0", "mesh/x2min=-4.0",
         "mesh/x2max=4.0", "mesh/x3min=-4.0", "mesh/x3max=4.0",
         "mesh/nghost=2"]
POOL = ["mesh/nx1=32", "mesh/x1max=12.0", "meshblock/nx1=16",
        "meshblock/nx2=16", "meshblock/nx3=16"]
RK4 = make_integrator("rk4")
DT = 0.125


def _pin(extra=(), cls=ParameterInput):
    pin = cls.from_file(PUNCTURE)
    pin.modify_from_cmdline(SMALL + list(extra))
    return pin


def builds(extra=()):
    return (jax_main.build(_pin(extra, JaxInput)),
            torch_main.build(_pin(extra), device="cpu"))


def inputs(sj, pt):
    """A filled, projected state with every channel perturbed (the shift
    too) and a register u1 = u (1 + 1e-3 N), numpy float64."""
    rng = np.random.default_rng(3)
    u = np.asarray(sj["u"]) + 1e-2 * rng.normal(size=sj["u"].shape)
    u = pt.alg_constr(pt.bvals.fill_ghosts(torch.from_numpy(u))).numpy()
    return u, u * (1.0 + 1e-3 * rng.normal(size=u.shape))


def scaled_err(got, want, ng):
    core = (slice(None), slice(None), slice(ng, -ng), slice(ng, -ng),
            slice(ng, -ng))
    got, want = np.asarray(got)[core], np.asarray(want)[core]
    return float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())


@pytest.fixture
def jax_f32():
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def _stage_sets(dtype):
    """(gam0, gam1, beta * dt) of the four RK4 stages, beta * dt rounded
    to ``dtype`` as the driver rounds it."""
    return [(RK4.gam0[s], RK4.gam1[s],
             float(torch.tensor(RK4.beta[s], dtype=dtype)
                   * torch.tensor(DT, dtype=dtype))) for s in range(4)]


def test_plain_stage_matches_jax_f64():
    """On the two-block outflow pool (Sommerfeld rows on the outer faces
    of each block, none on the faces the blocks share)."""
    (_, pj, _, _, sj), (_, pt, _, _, _) = builds(POOL)
    assert pt.mesh.nmb_total == 2 and pt.sbc_mask is not None
    u, u1 = inputs(sj, pt)
    rhs = pj.rhs(jnp.asarray(u))
    for g0, g1, bdt in _stage_sets(torch.float64):
        want = pj.alg_constr(g0 * u + g1 * u1 + bdt * rhs)
        got = z4c_stage.fused_z4c_stage(
            torch.from_numpy(u), torch.from_numpy(u1), pt, g0, g1, bdt)
        assert got.dtype == torch.float64
        assert scaled_err(got.numpy(), want, 2) <= 1e-10
    assert kernels.Z4C_STAGE.launches == 0


def test_plain_stage_matches_jax_f32(jax_f32):
    """JAX with 64-bit types off, as the Pallas kernel's own test runs;
    its Sommerfeld radius is then taken in float32 from float32
    coordinates, the port's in float64 and cast once (an ulp apart)."""
    (_, pj, _, _, sj), (_, pt, _, _, _) = builds(["job/precision=single"])
    u, u1 = inputs({"u": np.asarray(sj["u"], np.float64)},
                   torch_main.build(_pin(), device="cpu")[1])
    u, u1 = u.astype(np.float32), u1.astype(np.float32)
    rhs = pj.rhs(jnp.asarray(u))
    assert rhs.dtype == jnp.float32
    for g0, g1, bdt in _stage_sets(torch.float32):
        want = pj.alg_constr(g0 * jnp.asarray(u) + g1 * jnp.asarray(u1)
                             + bdt * rhs)
        got = z4c_stage.fused_z4c_stage(
            torch.from_numpy(u), torch.from_numpy(u1), pt, g0, g1, bdt)
        assert got.dtype == torch.float32
        assert scaled_err(got.numpy(), want, 2) <= 2e-5


@pytest.mark.parametrize("ng", [2, 4])
def test_outflow_fill_bitwise(ng):
    """The outflow fill's plain version (the port's sweep fill) and the
    JAX package's fill_ghosts on a random block: bitwise equal, and every
    ghost the clamped interior cell, which kernel I gathers."""
    (_, pj, _, _, _), (_, pt, _, _, _) = builds([f"mesh/nghost={ng}"])
    assert z4c_stage.fold_bc_supported(pt.bvals)
    rng = np.random.default_rng(ng)
    n = 16 + 2 * ng
    u = rng.normal(size=(1, 22, n, n, n))
    got = z4c_stage.outflow_fill(torch.from_numpy(u.copy()),
                                 pt.bvals).numpy()
    want = np.asarray(pj.bvals.fill_ghosts(jnp.asarray(u)))
    np.testing.assert_array_equal(got, want)
    c = np.clip(np.arange(n), ng, n - ng - 1)
    np.testing.assert_array_equal(got, u[:, :, c][:, :, :, c][..., c])


def test_pool_stage_matches_jax():
    """Two 16^3 blocks with outflow faces: the kernel path's order
    (stage, then the sweep fill) and the plain path's (fill, then the
    projection) against the JAX jnp stage_update, whole arrays."""
    (_, pj, _, _, sj), (_, pt, _, _, _) = builds(POOL)
    assert pt.use_stage_kernel and not pt.fold_bc
    u, u1 = inputs(sj, pt)
    g0, g1, bdt = _stage_sets(torch.float64)[1]
    want, _ = pj.stage_update({"u": jnp.asarray(u)},
                              {"u1": jnp.asarray(u1)}, g0, g1, bdt)
    want = np.asarray(want["u"])
    state = {"u": torch.from_numpy(u.copy())}
    saved = {"u1": torch.from_numpy(u1)}
    plain, _ = pt.stage_update(state, saved, g0, g1, bdt)
    kpath = pt.bvals.fill_ghosts(z4c_stage.fused_z4c_stage(
        state["u"], saved["u1"], pt, g0, g1, bdt))
    for got in (plain["u"].numpy(), kpath.numpy()):
        err = (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max()
        assert err <= 1e-10


def test_gates_and_switch():
    _, pt, _, _, st = torch_main.build(_pin(), device="cpu")
    assert pt.use_stage_kernel and pt.fold_bc
    assert not pt.kernel_path(st["u"])          # a CPU tensor
    off = torch_main.build(_pin(["z4c/use_kernels=false"]), device="cpu")[1]
    assert not off.use_stage_kernel and not off.fold_bc
    per = torch_main.build(_pin([f"mesh/{s}{a}_bc=periodic"
                                 for a in ("x1", "x2", "x3")
                                 for s in ("i", "o")]), device="cpu")[1]
    assert per.use_stage_kernel and not per.fold_bc
    assert per.sbc_mask is None


def test_stage_rejects_what_the_kernel_does_not_take():
    """The wrapper's checks, which run before any launch."""
    _, pt, _, _, st = torch_main.build(_pin(), device="cpu")
    u = st["u"]
    with pytest.raises(ValueError):
        z4c_stage._check_stage(u[:, :21], u[:, :21], pt)
    with pytest.raises(ValueError):
        z4c_stage._check_stage(u, u.float(), pt)
    with pytest.raises(ValueError):
        z4c_stage._check_stage(u, u.transpose(3, 4), pt)
    z4c_stage._check_stage(u, u.clone(), pt)


def test_params_follow_the_kernel_enum():
    """The scalars are passed in the order of the C enum."""
    with open(os.path.join(ROOT, "athenak_tpu_torch", "csrc",
                           "z4c_stage.cuh")) as f:
        text = f.read()
    body = re.search(r"enum Z4cPrmIndex \{(.*?)\};", text, re.S).group(1)
    names = [n.strip() for n in body.replace("\n", " ").split(",")]
    names = [n for n in names if n and n != "P_COUNT"]
    assert [n[2:].lower() for n in names] == list(z4c_stage._PRM_NAMES)
