"""The port's superposed binary black hole (``pgen/dynbbh.py``) held
against the JAX package on the CPU (float64): the prescribed metric and
the tracker refinement flags at t = 0 and a quarter orbit later, the
shipped deck cut to four blocks held to the JAX package for three
cycles (up to its first tree update), and the port alone through that
update, where the JAX package's rebuild drops the prescribed spacetime
(ROADMAP F26) and the port's rebinds it to the new tree.

Tolerances: the ADM fields and the initial state to 1e-12 of each
field's scale (the extrinsic curvature, a central difference of the
4-metric with step h = 5e-5, with the rounding of that difference on
top: 16 eps / (2 h)), the flags exactly, three cycles to 1e-10 (u, T, the
face field; w through its p2c image, ROADMAP F12).
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenak_tpu import main as jax_main
from athenak_tpu.athinput import ParameterInput as JaxInput
from athenak_tpu_torch import main as torch_main
from athenak_tpu_torch.athinput import ParameterInput
from torch_deck_parity import (JAX_EXTRA, DeckPair, assert_close,
                               assert_states_close, deck_literal, deck_text,
                               interior)

torch.set_num_threads(1)
BBH = "inputs/dyn_grmhd/dynbbh.athinput"
# the shipped deck cut to a 16 x 16 x 8 root of four 8^3 blocks; its
# first tree check falls after cycle 4 (refinement_interval 4)
CUT = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=8", "meshblock/nx1=8",
       "meshblock/nx2=8", "meshblock/nx3=8"]
EPS = float(np.finfo(np.float64).eps)
H = 5e-5   # the metric's finite-difference step (pgen/dynbbh.py)
ADM_KEYS = ("g3d", "alpha", "beta_u", "K_dd")


def _fields(adm):
    out = []
    for k in ADM_KEYS:
        v = adm[k]
        out += list(v) if isinstance(v, list) else [v]
    return [np.asarray(f) if not isinstance(f, torch.Tensor)
            else f.numpy() for f in out]


@pytest.fixture(scope="module")
def built():
    """tests/test_dynbbh.py's deck built by both packages."""
    text = deck_literal("test_dynbbh.py", "DECK")
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA)
    jm, jp, _, _, jst = jax_main.build(pj)
    tm, tp, _, _, tst = torch_main.build(ParameterInput.from_string(text),
                                         device="cpu")
    return jm, jp, jst, tm, tp, tst


@pytest.mark.parametrize("quarter", [False, True])
def test_bbh_metric_and_flags_match_jax(built, quarter):
    """The prescribed ADM fields (metric, lapse, shift, curvature; ghosts
    included) at t = 0 and a quarter orbit later, and the tracker flags
    at that time; the lapse minima sit at the holes."""
    jm, jp, jst, tm, tp, tst = built
    t = 0.25 * 2.0 * math.pi / 20.0 ** -1.5 if quarter else 0.0
    ja = _fields(jp.adm_of({"t": jnp.asarray(t)}))
    ta = _fields(tp.adm_of({"t": torch.tensor(t, dtype=torch.float64)}))
    for k, (got, ref) in enumerate(zip(ta, ja)):
        assert np.isfinite(got).all()
        if k < 10:
            assert_close(got, ref, 1e-12, f"adm field {k}")
        else:
            # K_ij is a central difference of the 4-metric (|g| ~ 1) with
            # step h: the rounding of its terms, 16 eps / (2 h), on top
            assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max() \
                + 16.0 * EPS / (2.0 * H), f"adm field {k}"
    np.testing.assert_array_equal(tp.user_refine_func({"t": t}, tm),
                                  jp.user_refine_func({"t": t}, jm))
    # the deepest lapse minima at the holes: (+-10, 0) at t = 0, (0, +-10)
    # a quarter orbit later
    a = ta[6]
    mbi = tm.mb_indcs
    mins = []
    for gid in range(tm.nmb_total):
        x1v, x2v, _ = tm.cell_centers(gid)
        sl = a[gid, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
               mbi.is_:mbi.ie + 1]
        k, j, i = np.unravel_index(sl.argmin(), sl.shape)
        mins.append((sl[k, j, i], x1v[mbi.is_ + i], x2v[mbi.js + j]))
    pos = sorted((x, y) for _, x, y in sorted(mins)[:2])
    want = [(0.0, -10.0), (0.0, 10.0)] if quarter else [(-10.0, 0.0),
                                                         (10.0, 0.0)]
    want = sorted(want)
    for (x, y), (wx, wy) in zip(pos, want):
        assert abs(x - wx) < 2.6 and abs(y - wy) < 2.6, pos


def test_bbh_initial_state_matches_jax(built):
    """The floor atmosphere's conserved state, primitives and
    temperature on the t = 0 metric."""
    _, _, jst, _, _, tst = built
    for k in ("u", "w", "T"):
        assert_close(tst[k].numpy(), np.asarray(jst[k]), 1e-12, k)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return DeckPair(deck_text(BBH), CUT,
                    rundir=str(tmp_path_factory.mktemp("bbh")))


def test_dynbbh_three_cycles_to_its_first_update(pair):
    """The shipped deck cut to four 8^3 blocks, three cycles through both
    packages (the first tree update comes after cycle 4): the state and
    the time to 1e-10."""
    assert pair.mesh.ncycle == 3 and pair.mesh.nmb_total == 4
    assert pair.driver.pamr.updates == []
    assert_states_close(pair.port_init, pair.jax_init, 1e-12, 2,
                        ("u", "w", "T"))
    assert_states_close(pair.state, pair.jax_state, 1e-10, 2, ("u", "T"))
    phys = pair.phys
    images = []
    for st in (pair.state, pair.jax_state):
        t = {k: torch.as_tensor(v) for k, v in st.items()
             if not isinstance(v, dict)}
        images.append(interior(phys.prim_to_cons_state(
            t["w"], t["T"], t["bcc"], phys.adm_of(t)).numpy()))
    assert_close(images[0], images[1], 1e-10, "p2c(w)")
    np.testing.assert_allclose(pair.mesh.time, pair.jax_time, rtol=1e-12)


def test_dynbbh_port_runs_through_the_update(tmp_path, monkeypatch):
    """The port alone through the first tree update (cycle 4) and two
    cycles past it, with the deck's history output: the tree refines,
    the prescribed spacetime is rebound to the new tree (the fields of a
    fresh metric on its cells), the state stays finite.  The JAX
    package's physics of the new tree has no spacetime (F26)."""
    from athenak_tpu.bvals import BoundaryValues as JaxBV
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu_torch.pgen.dynbbh import SuperposedBBH, _params
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    cwd = os.getcwd()
    try:
        mesh, phys, driver, st = torch_main.cli(
            ["-i", os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), BBH), "-d", str(tmp_path),
             *CUT, "time/nlim=6", "output1/dt=0.5"])
    finally:
        os.chdir(cwd)
    assert mesh.ncycle == 6 and len(driver.pamr.updates) == 1
    assert driver.pamr.updates[0]["ncycle"] == 4
    assert mesh.nmb_total > 4 and phys.mesh is mesh
    for k in ("u", "w", "T"):
        assert torch.isfinite(st[k]).all(), k
    fresh = SuperposedBBH(mesh, _params(ParameterInput.from_string(
        deck_text(BBH))), "cpu", torch.float64)(0.0)
    for got, ref in zip(_fields(phys.adm_of(st)), _fields(fresh)):
        assert got.shape[0] == mesh.nmb_total
        np.testing.assert_array_equal(got, ref)
    rows = (tmp_path / "dynbbh.hst").read_text().splitlines()
    assert len(rows) >= 4
    # the JAX package's make_physics on the refined tree: no spacetime
    pj = JaxInput.from_string(deck_text(BBH))
    pj.modify_from_cmdline(JAX_EXTRA + CUT)
    jm = JaxMesh(pj, leaves=[tuple(lf) for lf in mesh.leaves])
    jp = jax_main.make_physics(pj, jm, JaxBV(jm))
    with pytest.raises(RuntimeError, match="set_fixed_adm"):
        jp.adm_of({})
