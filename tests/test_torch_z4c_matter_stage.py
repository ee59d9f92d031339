"""Kernel H's matter source against the JAX package, on the CPU.

The Z4c stage with the fluid's stress-energy (``tmunu``: E, S_d, S_dd,
undensitised and cell-centred, as ``DynGRMHD.set_tmunu`` returns it)
adds the matter terms of ``rhs_core.py`` to Khat, Theta, Gam^a and A_ab.
A seeded physical stress-energy (``test_torch_z4c_host.physical_tmunu``:
E > 0, S_dd symmetric and bounded by E) goes with a perturbed puncture
state through:

  * the port's plain stage ``fused_z4c_stage_plain(..., tmunu)`` (what
    the CUDA kernel's matter instances are held to on the card, and on
    the host in ``tests/test_torch_z4c_host.py``) against the JAX
    package's jnp stage ``Z4c.stage_update(..., tmunu=...)`` on the four
    RK4 coefficient sets: float64 to 1e-10 on the two-block outflow pool
    of ``tests/test_torch_z4c_stage.py``, float32 (JAX with 64-bit types
    off) to 2e-5 on one block, of max(|value|, 1) on interior cells;
  * the JAX package's Pallas ``fused_z4c_stage(..., tmunu=...)`` in
    interpret mode, in float32 as ``tests/test_pallas_z4c.py`` runs it,
    against the same jnp stage and the port's plain stage, to 2e-5 (no
    caller of the JAX package reaches this branch: its gate takes the
    kernel only without matter);
  * the port's ``Z4c.stage_update`` with ``tmunu`` and its kernel gate
    opened for CPU tensors: the stage kernel is not called (the gate
    stays the JAX package's), and the result is the plain stage's.

The JAX side runs outside ``jax.jit`` but for the Pallas call (see
``tests/test_torch_z4c_ops.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu.ops import pallas_z4c  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.ops import z4c_stage  # noqa: E402
from athenak_tpu_torch.z4c import z4c as torch_z4c  # noqa: E402
from test_torch_z4c_host import physical_tmunu, tmunu_dict  # noqa: E402
from test_torch_z4c_stage import (POOL, _pin, _stage_sets,  # noqa: E402
                                  builds, inputs, jax_f32, scaled_err)


def jax_tmunu(mat):
    """The JAX package's tmunu dict of a stacked [nmb, 10, ...] array."""
    m = jnp.asarray(mat)
    return {"E": m[:, 0], "S_d": [m[:, 1 + a] for a in range(3)],
            "S_dd": [m[:, 4 + q] for q in range(6)]}


def jax_stage(pj, u, u1, g0, g1, bdt, tm):
    """The JAX package's jnp stage (rhs, RK combine, fill, AlgConstr)."""
    out, _ = pj.stage_update({"u": jnp.asarray(u)}, {"u1": jnp.asarray(u1)},
                             g0, g1, bdt, tmunu=tm)
    return np.asarray(out["u"])


def test_plain_matter_stage_matches_jax_f64():
    """The two-block outflow pool, the four RK4 stages; the source moves
    the stage."""
    (_, pj, _, _, sj), (_, pt, _, _, _) = builds(POOL)
    u, u1 = inputs(sj, pt)
    mat = physical_tmunu(u.shape, 21)
    tm = tmunu_dict(torch.from_numpy(mat))
    for g0, g1, bdt in _stage_sets(torch.float64):
        want = jax_stage(pj, u, u1, g0, g1, bdt, jax_tmunu(mat))
        args = (torch.from_numpy(u), torch.from_numpy(u1), pt, g0, g1, bdt)
        got = z4c_stage.fused_z4c_stage(*args, tmunu=tm)
        assert got.dtype == torch.float64
        assert scaled_err(got.numpy(), want, 2) <= 1e-10
        vac = z4c_stage.fused_z4c_stage_plain(*args).numpy()
        assert scaled_err(vac, want, 2) > 1e-6
    assert kernels.Z4C_STAGE.launches == kernels.Z4C_STAGE_MATTER.launches \
        == 0


def test_plain_matter_stage_matches_jax_f32(jax_f32):
    """One block in float32, the four RK4 stages."""
    (_, pj, _, _, sj), (_, pt, _, _, _) = builds(["job/precision=single"])
    u, u1 = inputs({"u": np.asarray(sj["u"], np.float64)},
                   torch_main.build(_pin(), device="cpu")[1])
    u, u1 = u.astype(np.float32), u1.astype(np.float32)
    mat = physical_tmunu(u.shape, 22).astype(np.float32)
    for g0, g1, bdt in _stage_sets(torch.float32):
        want = jax_stage(pj, u, u1, g0, g1, bdt, jax_tmunu(mat))
        assert want.dtype == np.float32
        got = z4c_stage.fused_z4c_stage(
            torch.from_numpy(u), torch.from_numpy(u1), pt, g0, g1, bdt,
            tmunu=tmunu_dict(torch.from_numpy(mat)))
        assert got.dtype == torch.float32
        assert scaled_err(got.numpy(), want, 2) <= 2e-5


@pytest.fixture
def pallas_interpret(jax_f32):
    pallas_z4c.INTERPRET = True
    yield
    pallas_z4c.INTERPRET = False


def test_pallas_matter_branch_matches_jnp(pallas_interpret):
    """The JAX package's Pallas stage with tmunu in interpret mode (one
    block, float32) against its jnp stage and the port's plain stage, on
    RK4's second and third stages (gam0 of either sign)."""
    (_, pj, _, _, sj), (_, pt, _, _, _) = builds(["job/precision=single"])
    assert pallas_z4c.supports_z4c_stage(pj, pj.mesh)
    u, u1 = inputs({"u": np.asarray(sj["u"], np.float64)},
                   torch_main.build(_pin(), device="cpu")[1])
    u, u1 = u.astype(np.float32), u1.astype(np.float32)
    mat = physical_tmunu(u.shape, 23).astype(np.float32)
    stage = jax.jit(lambda a, b, m, g0, g1, bdt: pallas_z4c.fused_z4c_stage(
        a, b, pj, g0, g1, bdt, tmunu=jax_tmunu(m)))
    for g0, g1, bdt in _stage_sets(torch.float32)[1:3]:
        want = jax_stage(pj, u, u1, g0, g1, bdt, jax_tmunu(mat))
        got = np.asarray(stage(jnp.asarray(u), jnp.asarray(u1),
                               jnp.asarray(mat), g0, g1, bdt))
        assert scaled_err(got, want, 2) <= 2e-5
        port = z4c_stage.fused_z4c_stage(
            torch.from_numpy(u), torch.from_numpy(u1), pt, g0, g1, bdt,
            tmunu=tmunu_dict(torch.from_numpy(mat)))
        assert scaled_err(got, port.numpy(), 2) <= 2e-5


def test_stage_update_with_tmunu_takes_no_kernel(monkeypatch):
    """The gate stays the JAX package's: with the stage kernel's gate
    opened for CPU tensors a stage without matter calls the kernel's
    wrapper, a stage with matter does not, and its result is the plain
    stage's on every interior cell."""
    monkeypatch.setattr(torch_z4c, "kernel_dtype_ok", lambda t: True)
    calls = []
    orig = z4c_stage.fused_z4c_stage

    def counted(*a, **k):
        calls.append(k.get("tmunu"))
        return orig(*a, **k)
    monkeypatch.setattr(z4c_stage, "fused_z4c_stage", counted)
    (_, _, _, _, sj), (_, pt, _, _, _) = builds(POOL)
    u, u1 = inputs(sj, pt)
    tm = tmunu_dict(torch.from_numpy(physical_tmunu(u.shape, 24)))
    g0, g1, bdt = _stage_sets(torch.float64)[2]
    state, saved = {"u": torch.from_numpy(u)}, {"u1": torch.from_numpy(u1)}
    assert pt.kernel_path(state["u"])
    pt.stage_update(state, saved, g0, g1, bdt)
    assert len(calls) == 1 and calls[0] is None
    out, _ = pt.stage_update(state, saved, g0, g1, bdt, tmunu=tm)
    assert len(calls) == 1
    want = z4c_stage.fused_z4c_stage_plain(state["u"], saved["u1"], pt, g0,
                                           g1, bdt, tmunu=tm)
    assert scaled_err(out["u"].numpy(), want.numpy(), 2) <= 1e-12
    assert kernels.Z4C_STAGE_MATTER.launches == 0


def test_stacked_order_and_checks():
    """The wrapper stacks the dict in the JAX kernel's order (E, S_d,
    S_dd) into one contiguous tensor; its checks refuse a stress-energy
    of another shape, dtype or layout before any launch."""
    _, pt, _, _, st = torch_main.build(_pin(), device="cpu")
    u = st["u"]
    mat = torch.from_numpy(physical_tmunu(u.shape, 25))
    stacked = z4c_stage._stack_tmunu(tmunu_dict(mat))
    assert stacked.is_contiguous() and torch.equal(stacked, mat)
    ref = jnp.stack([jax_tmunu(mat.numpy())["E"],
                     *jax_tmunu(mat.numpy())["S_d"],
                     *jax_tmunu(mat.numpy())["S_dd"]], axis=1)
    np.testing.assert_array_equal(np.asarray(ref), mat.numpy())
    z4c_stage._check_stage(u, u.clone(), pt, mat)
    for bad in (mat[:, :9], mat.float(), mat.transpose(3, 4)):
        with pytest.raises(ValueError):
            z4c_stage._check_stage(u, u.clone(), pt, bad)
