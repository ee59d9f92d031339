"""The driven-MHD-turbulence slice through both packages.

The deck is ``inputs/hydro/turb.athinput``'s mesh, time and driving
blocks at 16^3 with ``<hydro>`` replaced by ``<mhd>`` (PLM, HLLD) and a
uniform x1 field b0 = 0.1, in float64 (JAX runs in float64 in this
suite, tests/conftest.py), on one block and on a 2x2x2 pool of 8^3
blocks.

The port draws its random amplitudes from the JAX package's own stream:
the threefry key in the state, split as ``athenak_tpu/turb_driver.py:
101, 107-109, 155`` splits it (``athenak_tpu_torch/prng.py``).  The keys
and the random words are bitwise equal to JAX's, the normals equal to
within the rounding of the inverse error function, and with no draws
injected the mode tables are equal, the force field and the forced
state agree to 1e-12, and three cycles of the deck agree to 1e-10 of
the field scale, with the dt chain.  The v1 stage
route and the pool fill run here too: with the kernel gate opened for
CPU tensors, each wrapper runs its plain version.  The JAX side runs
under ``jax.jit`` at XLA's backend optimisation level 0, which compiles
faster on the CPU.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu_torch import bvals as torch_bvals  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch import prng  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.physics import mhd as torch_mhd  # noqa: E402
from athenak_tpu_torch.state import state_from_numpy  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401

INT = (slice(None), slice(None), slice(2, -2), slice(2, -2), slice(2, -2))
INTF = INT[1:]
POOL = ["meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8"]

DECK = """
<job>
basename = turb
precision = double
<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
ix1_bc = periodic
ox1_bc = periodic
nx2 = 16
x2min = -0.5
x2max = 0.5
ix2_bc = periodic
ox2_bc = periodic
nx3 = 16
x3min = -0.5
x3max = 0.5
ix3_bc = periodic
ox3_bc = periodic
coalesce = false
pencil_pack = false
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0
<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld
<turb_driving>
nlow = 1
nhigh = 2
dedt = 0.5
tcorr = 0.5
seed = 1
<problem>
pgen_name = turb
d0 = 1.0
p0 = 1.0
b0 = 0.1
"""


def _builds(extra=()):
    pj, pt = JaxInput.from_string(DECK), ParameterInput.from_string(DECK)
    pj.modify_from_cmdline(list(extra))
    pt.modify_from_cmdline(list(extra))
    return jax_main.build(pj), torch_main.build(pt, device="cpu")


def _key(jkey):
    """A JAX key as the port's int64 key tensor."""
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 123456789, 2 ** 33 + 5])
def test_threefry_words_match_jax(seed):
    """PRNGKey, split and the random words of a draw, bitwise."""
    from jax._src import prng as jax_prng
    kj = jax.random.PRNGKey(seed)
    kt = prng.prng_key(seed)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    for _ in range(3):
        kj, sj = jax.random.split(kj)
        kt, st = prng.split(kt)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    bits = np.asarray(jax_prng.threefry_random_bits(sj, 32, (29, 3)))
    b1, b2 = prng._hash_iota(st, 87)
    np.testing.assert_array_equal((b1 ^ b2).numpy().reshape(29, 3), bits)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_normals_match_jax(dtype):
    """jax.random.normal and the port's normal on the same keys: the
    uniforms bitwise, the normals to the inverse error function's
    rounding (XLA's CPU log1p sits up to 128 ulp from the correctly
    rounded one in float64): 5e-15 relative in float64, 4 ulp in
    float32."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    worst = 0.0
    for seed in range(8):
        kj = jax.random.split(jax.random.PRNGKey(seed))[1]
        kt = _key(kj)
        uj = np.asarray(jax.random.uniform(kj, (500, 3), dtype=jd,
                                           minval=1.0, maxval=2.0))
        np.testing.assert_array_equal(
            prng.uniform_bits(kt, (500, 3), td).numpy(), uj)
        a = np.asarray(jax.random.normal(kj, (500, 3), dtype=jd))
        b = prng.normal(kt, (500, 3), td).numpy()
        assert b.dtype == a.dtype
        if dtype == "float64":
            worst = max(worst, float(np.max(np.abs(b - a) / np.abs(a))))
        else:
            worst = max(worst, float(np.max(np.abs(b - a)
                                            / np.spacing(np.abs(a)))))
    assert worst <= (5e-15 if dtype == "float64" else 4), worst


def _jit_o0(fn):
    """``jax.jit`` at backend optimisation level 0."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _close(got, ref, tol, label):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()
    assert err <= tol, f"{label}: {err:g}"


@pytest.mark.parametrize("extra", [[], POOL])
def test_tables_match_jax(extra):
    (mj, pj, _, _, sj), (mt, pt, _, _, st) = _builds(extra)
    dj, dt_ = pj.pturb, pt.pturb
    assert mt.nmb_total == mj.nmb_total == (8 if extra else 1)
    assert dt_.nmode == dj.nmode and dt_.shape == dj.shape
    for name in ("kvec", "norm", "xc", "yc", "zc", "wvol"):
        np.testing.assert_array_equal(getattr(dt_, name), getattr(dj, name),
                                      err_msg=name)
    # the state carries the OU force and the JAX package's key
    assert set(st) == set(sj)
    assert not st["turb_force"].any()
    np.testing.assert_array_equal(state_to_numpy(st)["turb_key"],
                                  np.asarray(sj["turb_key"]))
    moved = state_from_numpy(jax.tree_util.tree_map(np.asarray, sj), "cpu",
                             torch.float64)
    assert set(moved) == set(st)
    assert set(state_to_numpy(moved)) == set(st)
    assert pt.use_mega_stage and not pt.use_mega_v2


def test_synthesize_and_apply_match_jax():
    """One force field from the same key, then apply() on a random state
    with a random OU force and key: force, u and turb_force to 1e-12, the
    next key bitwise."""
    (_, pj, _, _, _), (_, pt, _, _, _) = _builds(POOL)
    sub = jax.random.PRNGKey(7)
    fj = _jit_o0(lambda k: pj.pturb._synthesize(k, jnp.float64))(sub)
    ft = pt.pturb._synthesize(_key(sub), torch.float64)
    _close(ft.numpy(), fj, 1e-12, "force")

    rng = np.random.default_rng(3)
    shape = pt.pturb.shape
    n = (shape[0], 5) + shape[2:]
    w = np.concatenate([rng.uniform(0.5, 1.5, (n[0], 1) + n[2:]),
                        rng.uniform(-0.5, 0.5, (n[0], 3) + n[2:]),
                        rng.uniform(0.5, 1.5, (n[0], 1) + n[2:])], axis=1)
    u = w.copy()
    u[:, 1:4] *= u[:, :1]
    force0 = rng.normal(size=shape)
    dt = 0.01
    key = jax.random.PRNGKey(11)
    state_j = {"u": jnp.asarray(u), "w": jnp.asarray(w),
               "turb_force": jnp.asarray(force0), "turb_key": key}
    state_t = {"u": torch.from_numpy(u.copy()), "w": torch.from_numpy(w),
               "turb_force": torch.from_numpy(force0), "turb_key": _key(key)}
    oj = _jit_o0(lambda s, d: pj.pturb.apply(s, d, pj))(state_j,
                                                        jnp.asarray(dt))
    ot = pt.pturb.apply(state_t, dt, pt)
    _close(ot["u"].numpy(), oj["u"], 1e-12, "u")
    _close(ot["turb_force"].numpy(), oj["turb_force"], 1e-12, "turb_force")
    np.testing.assert_array_equal(ot["turb_key"].numpy(),
                                  np.asarray(oj["turb_key"]))
    # the input state is not written; the net momentum is removed
    np.testing.assert_array_equal(state_t["u"].numpy(), u)
    mom = ot["u"][INT][:, 1:4].sum(dim=(0, 2, 3, 4))
    assert float(mom.abs().max()) <= 1e-12 * float(ot["u"][INT][:, 1:4]
                                                   .abs().sum())


_JAX_RUNS = {}


def _jax_run(extra):
    """The JAX package's first dt and three jitted cycles, each cycle's
    state and new dt as numpy (computed once per layout, shared by both
    routes).  Unlike the blast at rest (``test_torch_mhd_slice.py``), the
    forced state has no symmetry plane whose zero mass flux XLA's
    rounding could tip, so the jitted cycle serves as the reference."""
    key = tuple(extra)
    if key not in _JAX_RUNS:
        (mj, _, _, dj, sj), _ = _builds(extra)
        cyc = _jit_o0(dj.make_cycle_fn())
        sj = dj.initialize(sj)
        dt, steps = mj.dt, []
        for _ in range(3):
            sj, dn, _ = cyc(sj, jnp.asarray(dt))
            steps.append((jax.tree_util.tree_map(np.asarray, sj),
                          float(dn), dt))
            dt = min(2.0 * dt, 0.3 * float(dn))
        _JAX_RUNS[key] = (mj.dt, steps)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("extra,route", [
    ([], "general"), (POOL, "general"), ([], "v1"), (POOL, "v1")])
def test_three_cycles_match_jax(extra, route, monkeypatch):
    """Three cycles of the deck on one block and on the pool: u and the
    face field on the interior, turb_force on the whole array, to 1e-10;
    the dt chain to 1e-10.  ``v1`` opens the kernel gate for CPU tensors,
    so the stage takes the v1 route (E, the face fill, F; the pool fill
    on the pool) through the wrappers' plain versions."""
    dt0, steps = _jax_run(extra)
    if route == "v1":
        monkeypatch.setattr(torch_mhd, "kernel_dtype_ok", lambda t: True)
        monkeypatch.setattr(torch_bvals, "kernel_dtype_ok", lambda t: True)
    _, (mt, pt, _, dt_, st) = _builds(extra)
    assert pt.bvals.pool_fill_active(st["u"]) == (route == "v1"
                                                  and bool(extra))
    st = dt_.initialize(st)
    np.testing.assert_allclose(mt.dt, dt0, rtol=1e-12)
    cyc_t = dt_.make_cycle_fn()
    for sj, dn_j, dt in steps:
        st, dn_t, _ = cyc_t(st, dt)
        got = state_to_numpy(st)
        _close(got["u"][INT], sj["u"][INT], 1e-10, "u")
        bmax = max(float(np.abs(v).max()) for v in sj["bfc"].values())
        for c, v in sj["bfc"].items():
            err = np.abs(got["bfc"][c][INTF] - v[INTF]).max()
            assert err <= 1e-10 * bmax, f"{c}: {err / bmax:g}"
        _close(got["turb_force"], sj["turb_force"], 1e-10, "turb_force")
        np.testing.assert_array_equal(got["turb_key"], sj["turb_key"])
        np.testing.assert_allclose(float(dn_t), dn_j, rtol=1e-10)
    # the forcing moved the gas; nothing launched a CUDA kernel
    assert float(np.abs(got["u"][:, 1:4]).max()) > 1e-3
    assert all(k.launches == 0 for k in kernels.ALL)


@pytest.mark.parametrize("extra", [[], POOL])
def test_cli_run_matches_jax(extra, monkeypatch, tmp_path):
    """``main.cli`` on the deck for three cycles, drawing from the deck's
    seed: the final state as after three JAX cycles."""
    _, steps = _jax_run(extra)
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    deck = tmp_path / "turb.athinput"
    deck.write_text(DECK)
    mesh, _, driver, state = torch_main.cli(
        ["-i", str(deck), "-d", str(tmp_path / "run"), "time/nlim=3",
         *extra])
    assert mesh.ncycle == 3 and mesh.nmb_total == (8 if extra else 1)
    assert driver.zone_cycles == 3 * 16 ** 3
    sj = steps[-1][0]
    got = state_to_numpy(state)
    _close(got["u"][INT], sj["u"][INT], 1e-10, "u")
    _close(got["turb_force"], sj["turb_force"], 1e-10, "turb_force")
