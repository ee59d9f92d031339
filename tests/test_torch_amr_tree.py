"""The port's adaptive-refinement building blocks against the JAX
package's, in float64 on the CPU.

  * ``update_tree`` on random trees and random flags, 2-D and 3-D,
    periodic and outflow, and on ``tests/test_amr.py``'s cases (a single
    refinement, the 2:1 ripple, a family derefinement, a no-op): the new
    leaves and the provenance list must be equal exactly;
  * the criteria (``make_flag_fn``: min_max on both bounds, slope,
    second_deriv; ``location``) and ``AMR.check_flags`` with its vetoes
    (the finest level, level 0, ``refinement_interval``): equal flags on
    random states;
  * the remap (``remap_cc``, ``remap_fc``, ``fc_internal``) on random
    states over trees with blocks of all three kinds (same, refined,
    derefined): equal to 1e-12 of each array's scale, and the refined
    blocks' div(B) at round-off when the old field is divergence-free.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from athenak_tpu import amr as jax_amr  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu_torch import amr  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.mesh import Mesh  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401

PERIODIC = {"x1": True, "x2": True, "x3": True}
OUTFLOW = {"x1": False, "x2": True, "x3": False}


def _flat(nrbx, active):
    leaves = [(l1, l2, l3, 0) for l3 in range(nrbx[2])
              for l2 in range(nrbx[1]) for l1 in range(nrbx[0])]
    return [(a, b, c, lev) for (lev, a, b, c) in jax_amr._zorder(
        [(0, a, b, c) for (a, b, c, _) in leaves], nrbx, active)]


def _random_flags(rng, leaves, p_refine=0.2):
    """Random flags in which, besides single -1, 0 and +1, whole
    families (the children of a random half of the parents) ask to be
    derefined."""
    flags = rng.choice([-1, 0, 1], size=len(leaves),
                       p=[0.5 - p_refine / 2, 0.5 - p_refine / 2,
                          p_refine])
    parents = {(lev - 1, a >> 1, b >> 1, c >> 1)
               for (a, b, c, lev) in leaves if lev > 0}
    chosen = {pk for pk in sorted(parents) if rng.random() < 0.5}
    for i, (a, b, c, lev) in enumerate(leaves):
        if lev > 0 and (lev - 1, a >> 1, b >> 1, c >> 1) in chosen:
            flags[i] = -1
    return flags


def _random_tree(rng, nrbx, active, wraps, max_level, rounds=3):
    """A tree grown from the flat root by random flags (JAX's update)."""
    leaves = _flat(nrbx, active)
    for _ in range(rounds):
        flags = _random_flags(rng, leaves, 0.3)
        new, _ = jax_amr.update_tree(leaves, flags, nrbx, active, wraps,
                                     max_level)
        if new is not None:
            leaves = new
    return leaves


def _both_update(leaves, flags, nrbx, active, wraps, max_level):
    ref = jax_amr.update_tree(leaves, flags, nrbx, active, wraps, max_level)
    got = amr.update_tree(list(leaves), flags, nrbx, active, wraps,
                          max_level)
    assert got == ref
    return ref


TREES = [((4, 4, 1), (True, True, False), PERIODIC, 3),
         ((4, 2, 1), (True, True, False), OUTFLOW, 2),
         ((2, 2, 2), (True, True, True), PERIODIC, 2),
         ((2, 3, 2), (True, True, True), OUTFLOW, 3)]


@pytest.mark.parametrize("case", range(len(TREES)))
def test_update_tree_random_matches_jax(case):
    nrbx, active, wraps, max_level = TREES[case]
    rng = np.random.default_rng(100 + case)
    kinds = set()
    for trial in range(6):
        leaves = _random_tree(rng, nrbx, active, wraps, max_level)
        flags = _random_flags(rng, leaves)
        new, prov = _both_update(leaves, flags, nrbx, active, wraps,
                                 max_level)
        if prov is not None:
            kinds |= {p[0] for p in prov}
        # the no-op
        assert _both_update(leaves, np.zeros(len(leaves), np.int32), nrbx,
                            active, wraps, max_level) == (None, None)
    assert kinds == {"same", "refined", "derefined"}


def test_update_tree_cases_match_jax():
    """tests/test_amr.py's cases: one refinement, the 2:1 ripple, a whole
    family derefined."""
    nrbx, active = (4, 4, 1), (True, True, False)
    leaves = _flat(nrbx, active)
    flags = np.zeros(16, np.int32)
    flags[leaves.index((1, 1, 0, 0))] = 1
    new, prov = _both_update(leaves, flags, nrbx, active, PERIODIC, 2)
    assert [p[0] for p in prov].count("refined") == 4
    flags = np.zeros(16, np.int32)
    flags[0] = 1
    lv1, _ = _both_update(leaves, flags, nrbx, active, PERIODIC, 3)
    flags2 = np.zeros(len(lv1), np.int32)
    flags2[next(i for i, (a, b, _, lev) in enumerate(lv1)
                if lev == 1 and (a, b) == (1, 1))] = 1
    lv2, _ = _both_update(lv1, flags2, nrbx, active, PERIODIC, 3)
    assert sum(1 for leaf in lv2 if leaf[3] == 2) == 4
    nrbx = (2, 2, 1)
    lv1, _ = _both_update(_flat(nrbx, active), np.ones(4, np.int32), nrbx,
                          active, PERIODIC, 2)
    lv2, prov2 = _both_update(lv1, -np.ones(len(lv1), np.int32), nrbx,
                              active, PERIODIC, 2)
    assert len(lv2) == 4
    assert all(p[0] == "derefined" and len(p[1]) == 4 for p in prov2)


# ---------------------------------------------------------------------------
# criteria and check_flags
# ---------------------------------------------------------------------------
DECK = """
<job>
basename = amrtree
<mesh>
nghost = 2
nx1 = 16
x1min = -0.5
x1max = 0.5
nx2 = 16
x2min = -0.5
x2max = 0.5
nx3 = {n3}
x3min = -0.5
x3max = 0.5
ix1_bc = {bc}
ox1_bc = {bc}
<meshblock>
nx1 = 4
nx2 = 4
nx3 = {mb3}
<mesh_refinement>
refinement = adaptive
num_levels = 3
refinement_interval = 3
{criteria}
<hydro>
eos = ideal
gamma = 1.4
<time>
tlim = 1.0
"""

CRITERIA = {
    "min_max": """<amr_criterion1>
method = min_max
variable = hydro_u_d
value_max = 1.6
value_min = 0.4""",
    "slope": """<amr_criterion1>
method = slope
variable = hydro_w_d
value_max = 0.5""",
    "second_deriv": """<amr_criterion1>
method = second_deriv
variable = hydro_u_d
value_max = 0.7""",
    "location": """<amr_criterion1>
method = location
location_x1 = 0.1
location_x2 = -0.2
location_x3 = 0.05
location_rad = 0.15""",
    "combined": """<amr_criterion1>
method = slope
variable = hydro_u_d
value_max = 0.6
<amr_criterion2>
method = min_max
variable = hydro_w_d
value_max = 1.7
<amr_criterion3>
method = location
location_x1 = -0.3
location_x2 = 0.3
location_rad = 0.1""",
}


def _meshes(crit, dim, bc, rng):
    text = DECK.format(n3=16 if dim == 3 else 1, mb3=4 if dim == 3 else 1,
                       bc=bc, criteria=CRITERIA[crit])
    jm0 = JaxMesh(JaxInput.from_string(text))
    wraps = {"x1": bc == "periodic", "x2": True, "x3": True}
    leaves = _random_tree(rng, jm0.tree_nrbx, jm0.tree_active, wraps, 2)
    pj, pt = JaxInput.from_string(text), ParameterInput.from_string(text)
    return pj, pt, JaxMesh(pj, leaves=leaves), Mesh(pt, leaves=leaves)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("crit", sorted(CRITERIA))
def test_check_flags_match_jax(crit, dim):
    rng = np.random.default_rng(7 + dim)
    pj, pt, jmesh, mesh = _meshes(crit, dim, "outflow" if dim == 3
                                  else "periodic", rng)
    assert mesh.leaves == [tuple(v) for v in jmesh.leaves]
    shape = (mesh.nmb_total, 5, mesh.mb_indcs.ncells3,
             mesh.mb_indcs.ncells2, mesh.mb_indcs.ncells1)
    ja, ta = jax_amr.AMR(pj, jmesh), amr.AMR(pt, mesh)
    for trial in range(3):
        u = 1.0 + 1.6 * (rng.random(shape) - 0.5) * rng.random(
            (shape[0], 1, 1, 1, 1))
        w = u * (1.0 + 0.3 * rng.random(shape))
        # vetoes: random cycle counts since the last refinement
        cyc = rng.integers(0, 6, size=mesh.nmb_total)
        ja.ncyc_since_ref, ta.ncyc_since_ref = cyc.copy(), cyc.copy()
        ref = ja.check_flags({"u": jnp.asarray(u), "w": jnp.asarray(w)},
                             jmesh, None)
        got = ta.check_flags({"u": torch.as_tensor(u),
                              "w": torch.as_tensor(w)}, mesh, None)
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
        # the criteria alone, before the vetoes
        if crit != "location":
            fj = np.asarray(jax_amr.make_flag_fn(ja.criteria, None, jmesh)(
                {"u": jnp.asarray(u), "w": jnp.asarray(w)}))
            ft = ta._flag_fn({"u": torch.as_tensor(u),
                              "w": torch.as_tensor(w)}).numpy()
            np.testing.assert_array_equal(ft, fj)
            if trial == 0:
                assert set(fj.tolist()) >= {-1, 1}, crit


# ---------------------------------------------------------------------------
# the remap
# ---------------------------------------------------------------------------
def _remap_text(dim):
    """The remap decks: 16^2 / 4^2 in 2-D, 8^3 / 4^3 in 3-D."""
    text = DECK.format(n3=8 if dim == 3 else 1, mb3=4 if dim == 3 else 1,
                       bc="periodic", criteria=CRITERIA["min_max"])
    if dim == 3:
        text = text.replace("nx1 = 16", "nx1 = 8").replace("nx2 = 16",
                                                           "nx2 = 8")
    return text


def _remap_case(dim, seed):
    """A tree, its update with all three provenance kinds, and the
    meshes of both packages on the old and the new tree."""
    rng = np.random.default_rng(seed)
    text = _remap_text(dim)
    jm0 = JaxMesh(JaxInput.from_string(text))
    nrbx, active = jm0.tree_nrbx, jm0.tree_active
    for _ in range(50):
        leaves = _random_tree(rng, nrbx, active, PERIODIC, 2, rounds=2)
        flags = _random_flags(rng, leaves)
        new, prov = jax_amr.update_tree(leaves, flags, nrbx, active,
                                        PERIODIC, 2)
        if prov is not None and {p[0] for p in prov} == {
                "same", "refined", "derefined"}:
            break
    pt = ParameterInput.from_string(text)
    return rng, leaves, new, prov, JaxMesh(JaxInput.from_string(text),
                                           leaves=new), Mesh(pt, leaves=new)


def _div_free_bfc(mesh, rng):
    """A face field with zero discrete divergence in every block: the
    discrete curl of a random edge potential (A3 only in 2-D)."""
    mbi = mesh.mb_indcs
    nmb, n3, n2, n1 = (mesh.nmb_total, mbi.ncells3, mbi.ncells2,
                       mbi.ncells1)
    three = mbi.nx3 > 1
    a1 = rng.standard_normal((nmb, n3 + 1, n2 + 1, n1)) if three else None
    a2 = rng.standard_normal((nmb, n3 + 1, n2, n1 + 1)) if three else None
    a3 = rng.standard_normal((nmb, n3, n2 + 1, n1 + 1))
    x1f = a3[:, :, 1:, :] - a3[:, :, :-1, :]
    x2f = -(a3[:, :, :, 1:] - a3[:, :, :, :-1])
    x3f = np.zeros((nmb, n3 + 1, n2, n1))
    if three:
        x1f = x1f - (a2[:, 1:, :, :] - a2[:, :-1, :, :])
        x2f = x2f + (a1[:, 1:, :, :] - a1[:, :-1, :, :])
        x3f = (a2[:, :, :, 1:] - a2[:, :, :, :-1]) \
            - (a1[:, :, 1:, :] - a1[:, :, :-1, :])
    return {"x1f": x1f, "x2f": x2f, "x3f": x3f}


def _div(bfc, three):
    d = (bfc["x1f"][..., 1:] - bfc["x1f"][..., :-1]) \
        + (bfc["x2f"][..., 1:, :] - bfc["x2f"][..., :-1, :])
    if three:
        d = d + bfc["x3f"][:, 1:] - bfc["x3f"][:, :-1]
    return d


def _close(got, ref, tol=1e-12):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * np.abs(ref).max(), err


@pytest.mark.parametrize("dim", [2, 3])
def test_remap_matches_jax(dim):
    rng, leaves, new, prov, jnew, tnew = _remap_case(dim, 20 + dim)
    mbi = jnew.mb_indcs
    act = ["x1", "x2"] + (["x3"] if dim == 3 else [])
    tbl = jax_amr._prov_tables(prov)
    assert all(np.array_equal(v, amr._prov_tables(prov)[k])
               for k, v in tbl.items())
    nold = len(leaves)
    u = rng.standard_normal((nold, 5, mbi.ncells3, mbi.ncells2,
                             mbi.ncells1))
    _close(amr.remap_cc(torch.as_tensor(u), tbl, tnew.mb_indcs, act),
           jax_amr.remap_cc(jnp.asarray(u), tbl, mbi, act))
    # face fields: random, and divergence-free on the old tree
    old_mesh = Mesh(ParameterInput.from_string(_remap_text(dim)),
                    leaves=leaves)
    for bfc in (_div_free_bfc(old_mesh, rng),
                {k: rng.standard_normal(v.shape) for k, v in
                 _div_free_bfc(old_mesh, rng).items()}):
        ref = jax_amr.remap_fc({k: jnp.asarray(v) for k, v in bfc.items()},
                               tbl, mbi, act)
        got = amr.remap_fc({k: torch.as_tensor(v) for k, v in bfc.items()},
                           tbl, tnew.mb_indcs, act)
        for k in ref:
            _close(got[k], ref[k])
        mask = tbl["mode"] == 1
        ref = jax_amr.fc_internal(ref, mbi, act, mask)
        got = amr.fc_internal(got, tnew.mb_indcs, act, mask)
        for k in ref:
            _close(got[k], ref[k])
    # the last field of the loop is random; the first was divergence-free
    bfc = _div_free_bfc(old_mesh, rng)
    got = amr.fc_internal(amr.remap_fc(
        {k: torch.as_tensor(v) for k, v in bfc.items()}, tbl,
        tnew.mb_indcs, act), tnew.mb_indcs, act, mask)
    got = {k: v.numpy() for k, v in got.items()}
    ng = mbi.ng
    inner = (slice(None), slice(ng, -ng) if dim == 3 else slice(None),
             slice(ng, -ng), slice(ng, -ng))
    div = _div(got, dim == 3)[inner]
    scale = max(np.abs(v).max() for v in bfc.values())
    assert np.abs(div[mask]).max() <= 1e-13 * scale
    # fc_internal changes nothing on blocks outside its mask
    keep = amr.fc_internal({k: torch.as_tensor(v) for k, v in bfc.items()},
                           old_mesh.mb_indcs, act,
                           np.zeros(old_mesh.nmb_total, bool))
    for k in bfc:
        np.testing.assert_array_equal(keep[k].numpy(), bfc[k])


def test_fc_internal_1d_matches_jax():
    rng = np.random.default_rng(3)
    text = DECK.format(n3=1, mb3=1, bc="periodic",
                       criteria=CRITERIA["min_max"]).replace(
        "nx2 = 16", "nx2 = 1").replace("nx2 = 4", "nx2 = 1")
    mesh = Mesh(ParameterInput.from_string(text))
    jmesh = JaxMesh(JaxInput.from_string(text))
    mbi = mesh.mb_indcs
    bfc = {"x1f": rng.standard_normal((mesh.nmb_total, 1, 1,
                                       mbi.ncells1 + 1)),
           "x2f": rng.standard_normal((mesh.nmb_total, 1, 2, mbi.ncells1)),
           "x3f": rng.standard_normal((mesh.nmb_total, 2, 1, mbi.ncells1))}
    mask = rng.random(mesh.nmb_total) < 0.5
    ref = jax_amr.fc_internal({k: jnp.asarray(v) for k, v in bfc.items()},
                              jmesh.mb_indcs, ["x1"], mask)
    got = amr.fc_internal({k: torch.as_tensor(v) for k, v in bfc.items()},
                          mbi, ["x1"], mask)
    for k in ref:
        _close(got[k], ref[k])
