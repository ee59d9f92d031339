"""The port's primitive-solver EOS framework held against the JAX package
on the CPU (float64): every policy's thermodynamics on
tests/test_eos_ps.py's grid of states (seed 7), prim_to_con and
con_to_prim with the floor and failure counters, the NQT logs bitwise,
and the c2p's fixed trip counts.

Tolerances: the thermodynamic functions to 1e-12 of each value.  The
temperatures are conditioned by a cancellation (T = (e - e_cold) (G-1)/n,
so an ulp of e moves T by eps e/n), and the tabulated policies invert by
a 40-trip bisection in log2 T whose last bracket, 2^-40 of the table's
log2 T range, is their resolution: they are held to 1e-12 of e/n (p/n)
or to two final brackets, whichever is larger.  The c2p inverts an
ill-conditioned map in cold, magnetised cells, so its primitives are
compared through their p2c image (ROADMAP F12), to 1e-10 of the cell's
energy scale tau + D.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import athenak_tpu.eos_ps as J
import athenak_tpu_torch.eos_ps as T
from test_eos_ps import _states

torch.set_num_threads(1)
N = 2000
PP = ([1e-8, 1e-4, 1e-2], [1.4, 5.0 / 3.0, 2.0], 1e-6)


def _tt(a):
    return torch.tensor(np.asarray(a))


def _pair(name):
    """(JAX policy, port policy) with equal tables."""
    if name == "ideal":
        return J.IdealGasPS(5.0 / 3.0), T.IdealGasPS(5.0 / 3.0)
    if name == "piecewise_poly":
        return (J.PiecewisePolytropePS(PP[0], PP[1], P0=PP[2]),
                T.PiecewisePolytropePS(PP[0], PP[1], P0=PP[2]))
    if name.startswith("compose"):
        nqt = name.endswith("nqt")
        jc = J.CompOSEPS.from_function(J.IdealGasPS(5.0 / 3.0), 1e-9, 10.0,
                                       1e-7, 100.0, use_nqt=nqt)
        tc = T.CompOSEPS.from_function(T.IdealGasPS(5.0 / 3.0), 1e-9, 10.0,
                                       1e-7, 100.0, use_nqt=nqt)
        for k in ("ln", "lt", "ye", "tab_lp", "tab_le", "tab_cs"):
            np.testing.assert_array_equal(getattr(tc, k), getattr(jc, k))
        return jc, tc
    nqt = name.endswith("nqt")
    jh = J.HybridPS.from_cold_policy(
        J.PiecewisePolytropePS(PP[0], PP[1], P0=PP[2]), 1e-9, 10.0,
        use_nqt=nqt)
    th = T.HybridPS.from_cold_policy(
        T.PiecewisePolytropePS(PP[0], PP[1], P0=PP[2]), 1e-9, 10.0,
        use_nqt=nqt)
    # the cold curves sampled by either package's pow agree to an ulp;
    # the parity runs on the JAX package's tables
    for k in ("ln", "tab_lp", "tab_le", "tab_cs"):
        np.testing.assert_allclose(getattr(th, k), getattr(jh, k),
                                   rtol=1e-15)
    return jh, T.HybridPS(jh.ln, jh.tab_lp, jh.tab_le, jh.tab_cs,
                          mb=jh.mb, use_nqt=nqt)


POLICIES = ["ideal", "piecewise_poly", "compose", "compose_nqt", "hybrid",
            "hybrid_nqt"]


@pytest.fixture(scope="module")
def grid():
    rng = np.random.default_rng(7)
    return _states(rng, N)


@pytest.mark.parametrize("name", POLICIES)
def test_policy_thermodynamics_match_jax(name, grid):
    """pressure, energy, enthalpy and sound speed on the (n, T) grid to
    1e-12 of each value."""
    jp, tp = _pair(name)
    n, Tt = grid[0], grid[1]
    for fn in ("pressure", "energy", "enthalpy", "sound_speed"):
        ref = np.asarray(getattr(jp, fn)(n, Tt))
        got = getattr(tp, fn)(_tt(n), _tt(Tt)).numpy()
        err = np.abs(got - ref) / np.abs(ref)
        assert err.max() <= 1e-12, (fn, err.max())


@pytest.mark.parametrize("name", POLICIES)
def test_policy_temperatures_match_jax(name, grid):
    """temperature_from_e and temperature_from_p of the grid's energies
    and pressures, to 1e-12 of e/n (p/n), or two final bisection
    brackets for the tabulated policies (see the module docstring)."""
    jp, tp = _pair(name)
    n, Tt = np.asarray(grid[0]), grid[1]
    lt = getattr(jp, "lt", None)
    for inv, fwd in (("temperature_from_e", "energy"),
                     ("temperature_from_p", "pressure")):
        x = np.asarray(getattr(jp, fwd)(jnp.asarray(n), Tt))
        ref = np.asarray(getattr(jp, inv)(jnp.asarray(n), jnp.asarray(x)))
        got = getattr(tp, inv)(_tt(n), _tt(x)).numpy()
        tol = 1e-12 * x / n
        if lt is not None:
            bracket = 2.0 * (lt[-1] - lt[0]) * 2.0 ** -40
            tol = np.maximum(tol, np.abs(ref) * (2.0 ** bracket - 1.0))
        assert (np.abs(got - ref) <= tol).all(), (
            inv, float(np.max(np.abs(got - ref) / tol)))


def test_nqt_logs_bitwise():
    """NQT log2 and exp2 on the float's bits: float64 and float32 equal
    to the JAX package's bit for bit, over 60 decades and both signs of
    the exponent."""
    rng = np.random.default_rng(3)
    x = 10.0 ** rng.uniform(-30.0, 30.0, 5000)
    y = rng.uniform(-90.0, 90.0, 5000)
    jl, tl = J.NQTLogs(), T.NQTLogs()
    for dt, jdt in ((torch.float64, jnp.float64), (torch.float32,
                                                   jnp.float32)):
        a = np.asarray(jl.log2(jnp.asarray(x, jdt)))
        b = tl.log2(torch.tensor(x, dtype=dt)).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b)
        a = np.asarray(jl.exp2(jnp.asarray(y, jdt)))
        b = tl.exp2(torch.tensor(y, dtype=dt)).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _cons(jps, jp, grid):
    n, Tt, Wv, B, g3d, _ = grid
    P = jp.pressure(n, Tt)
    return P, jps.prim_to_con(n, Wv, P, Tt, B, g3d)


def _spoil(D, S, tau, rng):
    """Cells that must floor or fail: D below the atmosphere (40 cells),
    no energy (tau NaN, 40), a negative energy (40) and |S| far above
    tau + D (40)."""
    D, tau = np.array(D), np.array(tau)
    S = [np.array(s) for s in S]
    idx = rng.permutation(N)[:160]
    D[idx[:40]] = 1e-14
    tau[idx[40:80]] = np.nan
    tau[idx[80:120]] = -0.9 * D[idx[80:120]]
    for s in S:
        s[idx[120:]] = 1e3 * (tau[idx[120:]] + D[idx[120:]])
    return D, S, tau


_C2P = {}


def _jax_c2p(name, jps, grid):
    """The JAX package's c2p of a policy, compiled once for the module
    (the states differ, the shapes do not)."""
    if name not in _C2P:
        _, _, _, B, g3d, g3u = grid
        _C2P[name] = jax.jit(
            lambda D, S, t: jps.con_to_prim(D, S, t, B, g3d, g3u))
    return _C2P[name]


@pytest.mark.parametrize("spoiled", [False, True])
@pytest.mark.parametrize("name", POLICIES)
def test_prim_con_round_trip_matches_jax(name, spoiled, grid):
    """prim_to_con to 1e-12 of each conserved value; con_to_prim on the
    result (and on a copy with floor and failure cells) with equal
    nfloor and nfail, the re-synced conserved state and the primitives
    of floored cells to 1e-12, and the other primitives through
    their p2c image to 1e-10 of tau + D."""
    jp, tp = _pair(name)
    jps = J.PrimitiveSolverPS(jp, dfloor=1e-12)
    tps = T.PrimitiveSolverPS(tp, dfloor=1e-12)
    n, Tt, Wv, B, g3d, g3u = grid
    P, (D, S, tau) = _cons(jps, jp, grid)
    Dt, St, taut = tps.prim_to_con(_tt(n), [_tt(v) for v in Wv], _tt(P),
                                   _tt(Tt), [_tt(v) for v in B],
                                   [_tt(v) for v in g3d])
    for got, ref in zip([Dt] + St + [taut], [D] + list(S) + [tau]):
        ref = np.asarray(ref)
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    if spoiled:
        D, S, tau = _spoil(D, S, tau, np.random.default_rng(11))
    jout = _jax_c2p(name, jps, grid)(
        jnp.asarray(D), [jnp.asarray(s) for s in S], jnp.asarray(tau))
    Bt, gt = [_tt(v) for v in B], [_tt(v) for v in g3d]
    tout = tps.con_to_prim(_tt(D), [_tt(s) for s in S], _tt(tau), Bt, gt,
                           [_tt(v) for v in g3u])
    assert int(tout["nfloor"]) == int(jout["nfloor"])
    assert int(tout["nfail"]) == int(jout["nfail"])
    if spoiled:
        assert int(jout["nfloor"]) >= 80 and int(jout["nfail"]) >= 40
    E = np.abs(np.asarray(jout["tau"])) + np.asarray(jout["D"])
    for k in ("D", "tau"):
        assert (np.abs(tout[k].numpy() - np.asarray(jout[k]))
                <= 1e-12 * E).all(), k
    for a in range(3):
        assert (np.abs(tout["S_d"][a].numpy() - np.asarray(jout["S_d"][a]))
                <= 1e-12 * E).all()
    bad = np.asarray(jout["n"]) == jps.n_atm
    for k in ("n", "P", "T"):
        np.testing.assert_allclose(tout[k].numpy()[bad],
                                   np.asarray(jout[k])[bad], rtol=1e-12,
                                   atol=0.0)
    jimg = tps.prim_to_con(_tt(jout["n"]), [_tt(v) for v in jout["Wv_u"]],
                           _tt(jout["P"]), _tt(jout["T"]), Bt, gt)
    timg = tps.prim_to_con(tout["n"], tout["Wv_u"], tout["P"], tout["T"],
                           Bt, gt)
    for got, ref in zip([timg[0]] + timg[1] + [timg[2]],
                        [jimg[0]] + jimg[1] + [jimg[2]]):
        assert (np.abs(got.numpy() - ref.numpy()) <= 1e-10 * E).all()


def test_c2p_takes_the_fixed_trips(grid, monkeypatch):
    """The port's c2p runs the JAX package's trip counts, never fewer:
    20 Newton trips of the upper bound, then f(mu) at 0, the bound, the
    wide bound, 30 false-position and 30 bisection trips and the root
    (64 evaluations), on converged cells too, and its densities are the
    JAX package's."""
    jps = J.PrimitiveSolverPS(J.IdealGasPS(5.0 / 3.0), dfloor=1e-12)
    tps = T.PrimitiveSolverPS(T.IdealGasPS(5.0 / 3.0), dfloor=1e-12)
    assert (tps.n_newton, tps.n_falsepos, tps.n_bisect) == \
        (jps.n_newton, jps.n_falsepos, jps.n_bisect) == (20, 30, 30)
    calls = {"root": 0, "upper": 0}
    root, upper = tps._root_f, tps._upper_f

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tps, "_root_f", count("root", root))
    monkeypatch.setattr(tps, "_upper_f", count("upper", upper))
    n, Tt, Wv, B, g3d, g3u = grid
    _, (D, S, tau) = _cons(jps, jps.eos, grid)
    full = tps.con_to_prim(_tt(D), [_tt(s) for s in S], _tt(tau),
                           [_tt(v) for v in B], [_tt(v) for v in g3d],
                           [_tt(v) for v in g3u])
    assert calls == {"root": 3 + 30 + 30 + 1, "upper": 20}
    jout = jax.jit(lambda D, S, t: jps.con_to_prim(D, S, t, B, g3d, g3u))(
        D, S, tau)
    ref = np.asarray(jout["n"])
    assert (np.abs(full["n"].numpy() - ref) <= 1e-10 * ref).all()
