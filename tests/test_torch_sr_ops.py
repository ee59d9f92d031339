"""The port's SR MHD EOS and Riemann solvers against the JAX package.

``ops/eos_sr.py`` (c2p, p2c, fast speeds) and ``ops/rsolvers_srmhd.py``
(HLLE, LLF) on random SR states made with ``numpy.random.default_rng``.
The JAX side runs eagerly (``jax.disable_jit``), operation by operation
as torch does.  Tolerances:

  * float64: relative error within 1e-12 of each field's maximum;
  * float32 c2p: the primitives within 8 x ``_tol_for(float32)`` (about
    64 ulp) of each field's maximum.  The root find stops within
    ``_tol_for`` of the root, so two float32 runs that round differently
    may stop at neighbouring iterates; 8 tolerances covers that.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.ops import eos_sr as jsr  # noqa: E402
from athenak_tpu.ops import rsolvers_srmhd as jrs  # noqa: E402
from athenak_tpu.ops.eos import EOSData as JEOS  # noqa: E402
from athenak_tpu_torch.ops import eos_sr as tsr  # noqa: E402
from athenak_tpu_torch.ops import rsolvers_srmhd as trs  # noqa: E402
from athenak_tpu_torch.ops.eos import EOSData as TEOS  # noqa: E402

SHAPE = (2, 6, 5, 7)   # [nmb, n3, n2, n1]
GAMMA = 4.0 / 3.0


def _prims(rng, umax=2.0, bmax=1.0):
    """Random SR primitives (rho, u^i, e) and a cell field."""
    w = np.stack([rng.uniform(0.5, 1.5, SHAPE),
                  rng.uniform(-umax, umax, SHAPE),
                  rng.uniform(-umax, umax, SHAPE),
                  rng.uniform(-umax, umax, SHAPE),
                  rng.uniform(0.05, 2.0, SHAPE)], axis=1)
    b = rng.uniform(-bmax, bmax, (SHAPE[0], 3) + SHAPE[1:])
    return w, b


def _rel(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=(-3, -2, -1), keepdims=True)
    return float((np.abs(got - ref) / np.maximum(scale, 1e-300)).max())


def _t(a, dtype=torch.float64):
    return torch.tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("seed", [0, 1])
def test_prim_to_cons_and_fast_speeds_f64(seed):
    w, b = _prims(np.random.default_rng(seed))
    ref = np.asarray(jsr.prim_to_cons_sr_mhd(jnp.asarray(w), jnp.asarray(b),
                                             JEOS(gamma=GAMMA)))
    got = tsr.prim_to_cons_sr_mhd(_t(w), _t(b), TEOS(gamma=GAMMA))
    assert _rel(got.numpy(), ref) <= 1e-12
    lor = np.sqrt(1.0 + (w[:, 1:4] ** 2).sum(axis=1))
    p = (GAMMA - 1.0) * w[:, 4]
    bsq = (b ** 2).sum(axis=1)
    for c in (1, 2, 3):
        jl = jsr.sr_mhd_fast_speeds(JEOS(gamma=GAMMA), jnp.asarray(w[:, 0]),
                                    jnp.asarray(p), jnp.asarray(w[:, c]),
                                    jnp.asarray(lor), jnp.asarray(bsq))
        tl = tsr.sr_mhd_fast_speeds(TEOS(gamma=GAMMA), _t(w[:, 0]), _t(p),
                                    _t(w[:, c]), _t(lor), _t(bsq))
        for a, r in zip(tl, jl):
            assert _rel(a.numpy()[:, None], np.asarray(r)[:, None]) <= 1e-12


@pytest.mark.parametrize("case", ["plain", "strong_field", "floors"])
def test_cons_to_prim_f64(case):
    """The Kastaun c2p on states made by p2c: primitives, the floored
    conserved state and every counter, nc2p_fail among them, agree."""
    rng = np.random.default_rng({"plain": 3, "strong_field": 4,
                                 "floors": 5}[case])
    w, b = _prims(rng, bmax=4.0 if case == "strong_field" else 1.0)
    u = np.array(jsr.prim_to_cons_sr_mhd(jnp.asarray(w), jnp.asarray(b),
                                         JEOS(gamma=GAMMA)))
    kw = {}
    if case == "floors":
        # a plane of cells below the density floor and one with negative
        # tau, their momenta cut so that the floored states stay far
        # from |v| -> 1, where the root find is ill-conditioned
        u[:, 0, 0] = 1e-3
        u[:, 1:4, 0] *= 1e-3
        u[:, 4, 1] = -0.5
        u[:, 1:4, 1] = 0.0
        kw = {"dfloor": 1e-2, "pfloor": 1e-3}
    with jax.disable_jit():
        jw, ju, jc = jsr.cons_to_prim_sr_mhd(
            jnp.asarray(u), jnp.asarray(b), JEOS(gamma=GAMMA, **kw))
    tw, tu, tc = tsr.cons_to_prim_sr_mhd(_t(u), _t(b),
                                         TEOS(gamma=GAMMA, **kw))
    assert _rel(tw.numpy(), jw) <= 1e-12
    assert _rel(tu.numpy(), ju) <= 1e-12
    assert set(tc) == {"neos_dfloor", "neos_efloor", "nc2p_fail"}
    for k in tc:
        assert int(tc[k]) == int(jc[k]), k
    if case == "floors":
        assert int(tc["neos_dfloor"]) > 0 and int(tc["neos_efloor"]) > 0
    else:
        # the states came from p2c: the c2p recovers them
        assert _rel(tw.numpy(), w) <= 1e-9


def test_cons_to_prim_f32():
    w, b = _prims(np.random.default_rng(6))
    u = np.asarray(jsr.prim_to_cons_sr_mhd(jnp.asarray(w), jnp.asarray(b),
                                           JEOS(gamma=GAMMA)))
    u32, b32 = u.astype(np.float32), b.astype(np.float32)
    with jax.disable_jit():
        jw, _, jc = jsr.cons_to_prim_sr_mhd(
            jnp.asarray(u32), jnp.asarray(b32), JEOS(gamma=GAMMA))
    tw, _, tc = tsr.cons_to_prim_sr_mhd(_t(u32, torch.float32),
                                        _t(b32, torch.float32),
                                        TEOS(gamma=GAMMA))
    assert tw.dtype == torch.float32
    tol = tsr._tol_for(torch.float32)
    assert tol == jsr._tol_for(np.float32)
    assert _rel(tw.numpy(), jw) <= 8 * tol
    assert int(tc["nc2p_fail"]) == int(jc["nc2p_fail"]) == 0


@pytest.mark.parametrize("solver", ["hlle", "llf"])
@pytest.mark.parametrize("ivx", [1, 2, 3])
def test_sr_solvers_f64(solver, ivx):
    rng = np.random.default_rng(10 * ivx + len(solver))
    wl, bl = _prims(rng)
    wr, br = _prims(rng)
    bx = rng.uniform(-1.0, 1.0, SHAPE)
    jargs = [jnp.asarray(a) for a in (wl, wr, bl, br, bx)]
    targs = [_t(a) for a in (wl, wr, bl, br, bx)]
    jf, jey, jez = jrs.SR_MHD_RSOLVER_FNS[solver](
        *jargs, JEOS(gamma=GAMMA), ivx)
    tf, tey, tez = trs.SR_MHD_RSOLVER_FNS[solver](
        *targs, TEOS(gamma=GAMMA), ivx)
    assert _rel(tf.numpy(), jf) <= 1e-12
    assert _rel(tey.numpy()[:, None], np.asarray(jey)[:, None]) <= 1e-12
    assert _rel(tez.numpy()[:, None], np.asarray(jez)[:, None]) <= 1e-12
