"""Parity of the port's EOS, reconstruction and Riemann solver with the
JAX package, in float64 on random physical states (density and pressure
positive), to rtol 1e-12."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.ops import eos as jeos  # noqa: E402
from athenak_tpu.ops import recon as jrecon  # noqa: E402
from athenak_tpu.ops import rsolvers_mhd as jrs  # noqa: E402
from athenak_tpu_torch.ops import eos as teos  # noqa: E402
from athenak_tpu_torch.ops import recon as trecon  # noqa: E402
from athenak_tpu_torch.ops import rsolvers_mhd as trs  # noqa: E402

SHAPE = (2, 12, 12, 12)
RTOL = 1e-12


def _close(got, ref, label):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, label
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(
        ref).max(), err_msg=label)


def _prims(rng):
    """Random primitives [2, 5, 12, 12, 12] and bcc [2, 3, ...]."""
    d = rng.uniform(0.2, 2.0, SHAPE)
    v = rng.uniform(-1.0, 1.0, (3,) + SHAPE)
    e = rng.uniform(0.1, 2.0, SHAPE)
    w = np.stack([d, v[0], v[1], v[2], e], axis=1)
    bcc = rng.uniform(-1.0, 1.0, (SHAPE[0], 3) + SHAPE[1:])
    return w, bcc


def _eos_pair(**kw):
    return jeos.EOSData(**kw), teos.EOSData(**kw)


@pytest.mark.parametrize("floors", [{}, {"dfloor": 0.6, "pfloor": 0.4}],
                         ids=["default_floors", "raised_floors"])
def test_c2p_p2c_parity(floors):
    rng = np.random.default_rng(11)
    w, bcc = _prims(rng)
    je, te = _eos_pair(gamma=5.0 / 3.0, **floors)
    # p2c, then a c2p that fires floors where they are raised
    uj = jeos.prim_to_cons_mhd(jnp.asarray(w), jnp.asarray(bcc), je)
    ut = teos.prim_to_cons_mhd(torch.from_numpy(w), torch.from_numpy(bcc),
                               te)
    _close(ut, uj, "p2c")
    u = np.array(uj)
    u[:, 4] -= rng.uniform(0.0, 0.5, SHAPE)   # some negative e as well
    wj, ufj, cj = jeos.cons_to_prim_mhd(jnp.asarray(u), jnp.asarray(bcc), je)
    wt, uft, ct = teos.cons_to_prim_mhd(torch.from_numpy(u),
                                        torch.from_numpy(bcc), te)
    _close(wt, wj, "c2p w")
    _close(uft, ufj, "c2p u_fixed")
    for k in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
        assert int(ct[k]) == int(cj[k]), k
    if floors:
        assert int(ct["neos_dfloor"]) > 0 and int(ct["neos_efloor"]) > 0


@pytest.mark.parametrize("method", ["plm", "dc"])
@pytest.mark.parametrize("axis", [2, 3, 4])
def test_recon_parity(method, axis):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 5) + SHAPE[1:])
    lj, rj = jrecon.RECON_FNS[method](jnp.asarray(q), axis)
    lt, rt = trecon.RECON_FNS[method](torch.from_numpy(q), axis)
    _close(lt, lj, f"{method} left")
    _close(rt, rj, f"{method} right")


@pytest.mark.parametrize("ivx", [1, 2, 3])
def test_hlld_parity(ivx):
    rng = np.random.default_rng(7 + ivx)
    wl, bl = _prims(rng)
    wr, br = _prims(rng)
    bx = rng.uniform(-1.0, 1.0, SHAPE)
    bx[0, :2] = 0.0                       # exercise the B_x ~ 0 branches
    je, te = _eos_pair(gamma=5.0 / 3.0)
    fj, eyj, ezj = jrs.hlld(*(jnp.asarray(a) for a in (wl, wr, bl, br, bx)),
                            je, ivx)
    ft, eyt, ezt = trs.hlld(*(torch.from_numpy(a)
                              for a in (wl, wr, bl, br, bx)), te, ivx)
    _close(ft, fj, "flux")
    _close(eyt, eyj, "ey")
    _close(ezt, ezj, "ez")
