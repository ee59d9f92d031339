"""The mixed-level ghost fills and the EMF correction against the JAX
package's, on the SMR decks of ``test_torch_refinement.py``.

Every sweep of the port computes its ghost slabs from the array as it
stood before the sweep, as the JAX package's functional sweeps do, and
keeps the JAX package's operation order, so a random float64 state fills
to the same values (held at 1e-14 of the field's scale).  The JAX side
runs under ``jax.jit`` at XLA's backend optimisation level 0.  The
linear-field exactness check of ``tests/test_smr_mhd.py:81-143`` runs
on the port: restriction and prolongation reproduce a linear face field
in every mixed-level face ghost.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.physics import mhd_smr  # noqa: E402
from test_torch_refinement import deck, one_torch_thread  # noqa: E402,F401

FILL_DECKS = ("2d", "3d", "nested", "outflow")


def _jit_o0(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


@functools.cache
def _builds(name):
    """(JAX physics, port physics) of a deck, built once a module (the
    fills and the EMF correction leave them as they were)."""
    text = deck(name)
    _, pj, _, _, _ = jax_main.build(JaxInput.from_string(text))
    _, pt, _, _, _ = torch_main.build(ParameterInput.from_string(text),
                                      device="cpu")
    return pj, pt


def _err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", FILL_DECKS)
def test_fill_ghosts_matches_jax(name):
    """The cell-centred fill of a random state: two rounds of sweeps with
    the restriction and prolongation overrides, then the corner pass;
    the physical boundaries on the outflow deck."""
    pj, pt = _builds(name)
    rng = np.random.default_rng(1)
    u = rng.normal(size=(pt.mesh.nmb_total, 5) + pt.fc_shapes["x1f"][1:3]
                   + (pt.fc_shapes["x1f"][3] - 1,))
    ref = _jit_o0(pj.bvals.fill_ghosts)(jnp.asarray(u))
    got = pt.bvals.fill_ghosts(torch.from_numpy(u.copy()))
    assert _err(got, ref) <= 1e-14
    assert not np.array_equal(np.asarray(ref), u)


@pytest.mark.parametrize("name", ["2d", "3d", "outflow", "2d wide"])
def test_fill_ghosts_fc_matches_jax(name):
    """The face-field fill of a random field: the shared face owned by
    the fine side, area-average restriction, min-mod/average
    prolongation, the corner pass; on ``2d wide`` the donors come from
    the two bands of planes the sweep copies, not a whole copy."""
    pj, pt = _builds(name)
    rng = np.random.default_rng(2)
    bfc = {k: rng.normal(size=s) for k, s in pt.fc_shapes.items()}
    ref = _jit_o0(pj.fill_ghosts_fc)({k: jnp.asarray(v)
                                      for k, v in bfc.items()})
    got = pt.fill_ghosts_fc({k: torch.from_numpy(v.copy())
                             for k, v in bfc.items()})
    scale = max(np.abs(v).max() for v in bfc.values())
    for k in bfc:
        err = np.abs(got[k].numpy() - np.asarray(ref[k])).max() / scale
        assert err <= 1e-14, (k, err)


@pytest.mark.parametrize("name", ["2d", "3d", "nested"])
def test_emf_correct_matches_jax(name):
    """The same-level edge sync and the fine-average EMF correction of
    random edge EMFs."""
    pj, pt = _builds(name)
    rng = np.random.default_rng(3)
    shape = pt.fc_shapes["x1f"][:3] + (pt.fc_shapes["x1f"][3] - 1,)
    es = [rng.normal(size=shape) for _ in range(3)]
    ref = _jit_o0(pj._emf_correct)(*[jnp.asarray(e) for e in es])
    inp = [torch.from_numpy(e.copy()) for e in es]
    got = mhd_smr.emf_correct(pt.mesh, pt.bvals.active_axes, *inp)
    for g, r in zip(got, ref):
        assert _err(g, r) <= 1e-14
    # the inputs are not written
    for t, e in zip(inp, es):
        np.testing.assert_array_equal(t.numpy(), e)


def test_fc_linear_ghost_exactness_2d():
    """Linear B components are reproduced exactly in all mixed-level face
    ghosts (skipping periodic-wrap faces); ``tests/test_smr_mhd.py``'s
    check on the port."""
    _, phys = _builds("2d")
    mesh = phys.mesh
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    ng = mbi.ng

    def f1(x, y):
        return 0.2 + 1.3 * x - 0.7 * y

    def f2(x, y):
        return -0.4 + 0.6 * x + 1.1 * y

    b1 = np.zeros((nmb, 1, mbi.ncells2, mbi.ncells1 + 1))
    b2 = np.zeros((nmb, 1, mbi.ncells2 + 1, mbi.ncells1))
    b3 = np.zeros((nmb, 2, mbi.ncells2, mbi.ncells1))
    for gid in range(nmb):
        x1f, x2f, _ = mesh.face_edges(gid)
        x1v, x2v, _ = mesh.cell_centers(gid)
        b1[gid, 0] = f1(x1f[None, :], x2v[:, None])
        b2[gid, 0] = f2(x1v[None, :], x2f[:, None])
        b3[gid, :] = f1(x1v[None, :], x2v[:, None])
    filled = {k: v.numpy() for k, v in phys.fill_ghosts_fc(
        {"x1f": torch.from_numpy(b1), "x2f": torch.from_numpy(b2),
         "x3f": torch.from_numpy(b3)}).items()}

    errs = []
    for gid in range(nmb):
        lloc = mesh.lloc_eachmb[gid]
        nb = 4 << mesh.mb_lev[gid]
        x1f, x2f, _ = mesh.face_edges(gid)
        x1v, x2v, _ = mesh.cell_centers(gid)
        ex1 = f1(x1f[None, :], x2v[:, None])
        ex2 = f2(x1v[None, :], x2f[:, None])
        jt = slice(mbi.js, mbi.je + 1)
        it = slice(mbi.is_, mbi.ie + 1)
        jtf = slice(mbi.js, mbi.je + 2)
        itf = slice(mbi.is_, mbi.ie + 2)
        if lloc[0] > 0:
            errs.append(np.abs(filled["x1f"][gid, 0, jt, :ng]
                               - ex1[jt, :ng]).max())
            errs.append(np.abs(filled["x2f"][gid, 0, jtf, :ng]
                               - ex2[jtf, :ng]).max())
        if lloc[0] < nb - 1:
            errs.append(np.abs(filled["x1f"][gid, 0, jt, -ng:]
                               - ex1[jt, -ng:]).max())
            errs.append(np.abs(filled["x2f"][gid, 0, jtf, -ng:]
                               - ex2[jtf, -ng:]).max())
        if lloc[1] > 0:
            errs.append(np.abs(filled["x2f"][gid, 0, :ng, it]
                               - ex2[:ng, it]).max())
            errs.append(np.abs(filled["x1f"][gid, 0, :ng, itf]
                               - ex1[:ng, itf]).max())
        if lloc[1] < nb - 1:
            errs.append(np.abs(filled["x2f"][gid, 0, -ng:, it]
                               - ex2[-ng:, it]).max())
            errs.append(np.abs(filled["x1f"][gid, 0, -ng:, itf]
                               - ex1[-ng:, itf]).max())
    assert len(errs) > 4 * nmb
    assert max(errs) < 1e-12, max(errs)
