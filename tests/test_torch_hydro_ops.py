"""Parity of the port's hydro numerics with the JAX package, in float64
on seeded random states, to 1e-12 of each output's scale:

  * every reconstruction method (DC, PLM, PPM4, PPMX, WENO-Z, TENO) on
    rough data with flat stretches and extrema, along each axis;
  * every hydro Riemann solver (LLF, HLLE, HLLC, Roe, advection) for the
    ideal and the isothermal gas, in each direction, with one passive
    scalar riding along (HLLC raises on the isothermal gas in both);
  * the hydro c2p and p2c with the floors firing: the primitives, the
    floored conserved state and the floor counters (exactly), ideal and
    isothermal, with a scalar that goes negative.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.ops import eos as jeos  # noqa: E402
from athenak_tpu.ops import recon as jrecon  # noqa: E402
from athenak_tpu.ops import rsolvers as jrs  # noqa: E402
from athenak_tpu_torch.ops import eos as teos  # noqa: E402
from athenak_tpu_torch.ops import recon as trecon  # noqa: E402
from athenak_tpu_torch.ops import rsolvers as trs  # noqa: E402

SHAPE = (2, 10, 11, 12)
TOL = 1e-12


def close(got, ref, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, label
    err = np.abs(got - ref).max()
    assert err <= TOL * np.abs(ref).max(), f"{label}: {err:g}"


def rough(rng, nvar=5):
    """Random data with flat stretches, steps and smooth parts."""
    q = rng.normal(size=(SHAPE[0], nvar) + SHAPE[1:])
    q[..., 3:6] = q[..., 3:4]                      # flat in x1
    q[:, :, 2:4] = q[:, :, 2:3]                    # flat in x3
    x = np.linspace(0.0, 3.0, SHAPE[3])
    q[:, :, :, 5:] += np.sin(4.0 * x)              # a smooth stretch
    q[:, :, :, :, 7:] += 3.0                       # a step
    return q


def test_recon_tables():
    assert set(trecon.RECON_FNS) == set(jrecon.RECON_FNS)
    assert trecon.FLOORED_METHODS == jrecon.FLOORED_METHODS


@pytest.mark.parametrize("axis", [2, 3, 4])
@pytest.mark.parametrize("method", ["dc", "plm", "ppm4", "ppmx", "wenoz",
                                    "teno"])
def test_recon_matches_jax(method, axis):
    q = rough(np.random.default_rng(5))
    lj, rj = jrecon.reconstruct(method, jnp.asarray(q), axis)
    lt, rt = trecon.reconstruct(method, torch.from_numpy(q), axis)
    close(lt, lj, f"{method} left")
    close(rt, rj, f"{method} right")


def prims(rng, ideal=True, nscalars=1):
    """Random primitives (positive density and energy; the energy channel
    only for the ideal gas) with passive scalars."""
    d = rng.uniform(0.2, 2.0, (SHAPE[0], 1) + SHAPE[1:])
    v = rng.uniform(-1.5, 1.5, (SHAPE[0], 3) + SHAPE[1:])
    chans = [d, v]
    if ideal:
        chans.append(rng.uniform(0.05, 2.0, d.shape))
    chans.append(rng.uniform(0.0, 1.0, (SHAPE[0], nscalars) + SHAPE[1:]))
    return np.concatenate(chans, axis=1)


def eos_pair(ideal=True, **kw):
    kw = dict(gamma=1.4, is_ideal=ideal, iso_cs=0.7, **kw)
    return jeos.EOSData(**kw), teos.EOSData(**kw)


@pytest.mark.parametrize("ivx", [1, 2, 3])
@pytest.mark.parametrize("ideal", [True, False], ids=["ideal", "isothermal"])
@pytest.mark.parametrize("solver", ["llf", "hlle", "hllc", "roe", "advect"])
def test_solver_matches_jax(solver, ideal, ivx):
    rng = np.random.default_rng(17 + ivx)
    wl, wr = prims(rng, ideal), prims(rng, ideal)
    # some faces with equal states, where the contact sits at rest
    wr[:, :, :3] = wl[:, :, :3]
    wr[:, 1:4, :3] = 0.0
    wl[:, 1:4, :3] = 0.0
    je, te = eos_pair(ideal)
    args_j = (jnp.asarray(wl), jnp.asarray(wr), je, ivx)
    args_t = (torch.from_numpy(wl), torch.from_numpy(wr), te, ivx)
    if solver == "hllc" and not ideal:
        with pytest.raises(ValueError):
            jrs.HYDRO_RSOLVER_FNS[solver](*args_j)
        with pytest.raises(ValueError):
            trs.HYDRO_RSOLVER_FNS[solver](*args_t)
        return
    fj = jrs.HYDRO_RSOLVER_FNS[solver](*args_j)
    ft = trs.HYDRO_RSOLVER_FNS[solver](*args_t)
    close(ft, fj, solver)
    assert set(trs.HYDRO_RSOLVER_FNS) == set(jrs.HYDRO_RSOLVER_FNS)


@pytest.mark.parametrize("ideal", [True, False], ids=["ideal", "isothermal"])
def test_c2p_p2c_floors_match_jax(ideal):
    rng = np.random.default_rng(23)
    w = prims(rng, ideal, nscalars=2)
    je, te = eos_pair(ideal, dfloor=0.5, pfloor=0.3, tfloor=0.2)
    uj = jeos.prim_to_cons_hydro(jnp.asarray(w), je)
    ut = teos.prim_to_cons_hydro(torch.from_numpy(w), te)
    close(ut, uj, "p2c")
    u = np.array(uj)
    if ideal:
        u[:, 4] -= rng.uniform(0.0, 0.6, u[:, 4].shape)
    u[:, -1] -= 0.4                                 # negative scalars
    wj, ufj, cj = jeos.cons_to_prim_hydro(jnp.asarray(u), je)
    wt, uft, ct = teos.cons_to_prim_hydro(torch.from_numpy(u), te)
    close(wt, wj, "c2p w")
    close(uft, ufj, "c2p u_fixed")
    assert set(ct) == set(cj) == ({"neos_dfloor", "neos_efloor",
                                   "neos_tfloor"} if ideal
                                  else {"neos_dfloor"})
    for k in cj:
        assert int(ct[k]) == int(cj[k]) > 0, k
    assert float(uft[:, -1].min()) == 0.0
