"""Kernel J's plain version (``ops/flux.py::flux_dir_plain``) against the
JAX package.

  * Against the Pallas kernel ``pallas_flux.fused_flux_dir`` in Pallas
    interpret mode, float32 with x64 off (as ``test_pallas_parity.py``'s
    ``f32_interpret`` fixture runs it), on random multi-block 3-D states
    for x1, x2 and x3 and on a 2-D state (n3 = 1) for x1 and x2, with the
    density floor raised so that the face floors bind: every face the RK
    update and the corner EMFs read (all but the first two and the last
    along the direction, whose stencils wrap) within 1e-5 of the
    channel's scale.
  * Against the JAX package's own pieces, ``recon.plm``, the face floors
    of ``MHD.fluxes`` and ``rsolvers_mhd.hlld``, in float64: every face
    within 1e-12 of the channel's scale.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu.indices import IDN, IEN  # noqa: E402
from athenak_tpu.ops import eos as jeos  # noqa: E402
from athenak_tpu.ops import pallas_flux, recon, rsolvers_mhd  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.ops import eos as teos  # noqa: E402
from athenak_tpu_torch.ops import flux  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401

# (direction, cell axis, ivx)
DIRS = {"x1": (4, 1), "x2": (3, 2), "x3": (2, 3)}
FLOORS = {"dfloor": 0.6, "pfloor": 0.5}
CASES = [("3d", "x1"), ("3d", "x2"), ("3d", "x3"), ("2d", "x1"),
         ("2d", "x2")]


def _state(rng, kind, dtype):
    """Random primitives, cell-centred and face fields on 2 blocks."""
    shp = (2, 12, 10, 14) if kind == "3d" else (2, 1, 12, 16)
    w = np.stack([rng.uniform(0.5, 1.5, shp), rng.uniform(-0.5, 0.5, shp),
                  rng.uniform(-0.5, 0.5, shp), rng.uniform(-0.5, 0.5, shp),
                  rng.uniform(0.5, 1.5, shp)], axis=1)
    bcc = rng.uniform(-0.5, 0.5, (2, 3) + shp[1:])
    faces = {"x1": (2, shp[1], shp[2], shp[3] + 1),
             "x2": (2, shp[1], shp[2] + 1, shp[3]),
             "x3": (2, shp[1] + 1, shp[2], shp[3])}
    bfc = {k: rng.uniform(-0.5, 0.5, s).astype(dtype)
           for k, s in faces.items()}
    return w.astype(dtype), bcc.astype(dtype), bfc


def _bface(bnormal, name):
    """The normal field at the lower face of each cell."""
    axis = DIRS[name][0] - 1
    return bnormal.take(np.arange(bnormal.shape[axis] - 1), axis=axis)


def _read_faces(a, name, ndim):
    """The faces the RK update and the corner EMFs read along ``name``:
    all but the first two and the last, whose stencils wrap."""
    axis = DIRS[name][0] - (5 - ndim)
    return a.take(np.arange(2, a.shape[axis] - 1), axis=axis)


def _assert_close(got, ref, name, tol):
    f, ey, ez = (np.asarray(x, np.float64) for x in got)
    fr, eyr, ezr = (np.asarray(x, np.float64) for x in ref)
    f, fr = _read_faces(f, name, 5), _read_faces(fr, name, 5)
    for c in range(5):
        scale = np.abs(fr[:, c]).max()
        err = np.abs(f[:, c] - fr[:, c]).max() / scale
        assert err <= tol, f"flux channel {c}: {err:g}"
    for label, a, b in (("ey", ey, eyr), ("ez", ez, ezr)):
        a, b = _read_faces(a, name, 4), _read_faces(b, name, 4)
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= tol, f"{label}: {err:g}"


@pytest.fixture
def f32_interpret():
    """float32 + Pallas interpret mode, restored afterwards."""
    jax.config.update("jax_enable_x64", False)
    pallas_flux.INTERPRET = True
    yield
    pallas_flux.INTERPRET = False
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("kind,name", CASES)
def test_plain_matches_pallas_interpret(f32_interpret, kind, name):
    rng = np.random.default_rng(7)
    w, bcc, bfc = _state(rng, kind, np.float32)
    ivx = DIRS[name][1]
    ref = pallas_flux.fused_flux_dir(
        jnp.asarray(w), jnp.asarray(bcc), jnp.asarray(_bface(bfc[name],
                                                             name)),
        jeos.EOSData(**FLOORS), name, ivx)
    got = flux.fused_flux_dir(torch.from_numpy(w), torch.from_numpy(bcc),
                              torch.from_numpy(bfc[name]),
                              teos.EOSData(**FLOORS), name, ivx)
    assert all(g.dtype == torch.float32 for g in got)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in ref]
    _assert_close(got, ref, name, 1e-5)
    # the floors bound on some face states; the CPU launched nothing
    assert (w[:, IDN] < FLOORS["dfloor"]).any()
    assert kernels.FLUX_DIR.launches == 0


@pytest.mark.parametrize("kind,name", CASES)
def test_plain_matches_jax_pieces_f64(kind, name):
    rng = np.random.default_rng(11)
    w, bcc, bfc = _state(rng, kind, np.float64)
    axis, ivx = DIRS[name]
    eos = jeos.EOSData(**FLOORS)
    wj, bj = jnp.asarray(w), jnp.asarray(bcc)
    wl, wr = recon.plm(wj, axis)
    bl, br = recon.plm(bj, axis)
    efloor = eos.pfloor / (eos.gamma - 1.0)
    wl = wl.at[:, IDN].max(eos.dfloor).at[:, IEN].max(efloor)
    wr = wr.at[:, IDN].max(eos.dfloor).at[:, IEN].max(efloor)
    ref = rsolvers_mhd.hlld(wl, wr, bl, br,
                            jnp.asarray(_bface(bfc[name], name)), eos, ivx)
    got = flux.fused_flux_dir(torch.from_numpy(w), torch.from_numpy(bcc),
                              torch.from_numpy(bfc[name]),
                              teos.EOSData(**FLOORS), name, ivx)
    _assert_close(got, ref, name, 1e-12)


def test_gate():
    """Kernel J takes Newtonian PLM + HLLD decks only."""
    class P:
        is_sr = False
        recon_method = "plm"
        rsolver = "hlld"
        eos = teos.EOSData()
        nscalars = 0

    assert flux.supports_flux_dir(P)
    for attr, val in (("is_sr", True), ("rsolver", "llf"),
                      ("recon_method", "dc"), ("nscalars", 1)):
        q = type("Q", (P,), {attr: val})
        assert not flux.supports_flux_dir(q), attr
