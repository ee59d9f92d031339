"""The port's static refinement against the JAX package's: the octree,
the mixed-level donor tables, the block geometry and the restriction,
prolongation and flux-correction operators.

The decks (shared with the other SMR test files of the port):

  * ``2d``: ``tests/test_smr_mhd.py``'s deck, the Orszag-Tang vortex on a
    32^2 root grid of 8^2 blocks with one level-1 region (28 blocks);
  * ``3d``: the MHD blast on a 16^3 root grid of 4^3 blocks with one
    level-1 region (120 blocks), so that mixed-level faces, edges and
    corners all occur.  The domain is shifted by a quarter of a root
    cell, so that the blast's centre is a cell centre of the fine level
    and no face lies on a symmetry plane: there the mass flux is zero up
    to rounding, and the upwind selects of the corner EMFs would follow
    the sign of rounding noise, which differs between torch and XLA;
  * ``nested``: the 2-D deck with a level-2 region inside the level-1
    one (three levels);
  * ``outflow``: the 3-D deck with outflow x1 and reflecting x2
    boundaries;
  * ``2d wide``: the 2-D deck on a 64^2 root grid of 16^2 blocks (28
    blocks), wide enough that the face fill's donor bands
    (``mhd_smr.DonorBands``) do not cover the whole block.

The tables are built by host numpy code copied into the port, so they
must be equal, entry by entry; the operators keep the JAX package's
operation order, so in float64 they agree to the last bit (held here at
1e-15 relative).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from athenak_tpu import refinement as jax_ref  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu_torch import refinement as torch_ref  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.mesh import Mesh  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one CPU thread for the module.  These tests issue
    thousands of small torch operations; with one thread per core in
    each of several test processes, torch's waiting worker threads take
    the cores from one another and a run takes tens of times longer."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_BASE = """
<job>
basename = smr
<mesh>
nghost = 2
nx1 = {n}
x1min = {lo}
x1max = {hi}
nx2 = {n}
x2min = {lo}
x2max = {hi}
nx3 = {n3}
x3min = {lo}
x3max = {hi}
{bcs}
<meshblock>
nx1 = {mb}
nx2 = {mb}
nx3 = {mb3}
<mesh_refinement>
refinement = static
<refined_region1>
level = 1
x1min = -0.125
x1max = 0.125
x2min = -0.125
x2max = 0.125
x3min = -0.125
x3max = 0.125
{region2}
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 0.1
<mhd>
eos = ideal
gamma = 1.6666666666666667
reconstruct = plm
rsolver = hlld
<problem>
pgen_name = {pgen}
inner_radius = 0.08
outer_radius = 0.15
prat = 20.0
b_amb = 0.2
"""

_REGION2 = """<refined_region2>
level = 2
x1min = -0.0625
x1max = 0.0625
x2min = -0.0625
x2max = 0.0625
"""

# a quarter of a root cell of the 3-D deck: the fine level's cell centre
# lands on the blast's centre
_SHIFT = 1.0 / 64.0


def deck(name: str) -> str:
    """The text of one of the decks above."""
    if name in ("2d", "nested", "2d wide"):
        n, mb = (64, 16) if name == "2d wide" else (32, 8)
        return _BASE.format(n=n, n3=1, lo=-0.5, hi=0.5, bcs="", mb=mb,
                            mb3=1, pgen="orszag_tang",
                            region2=_REGION2 if name == "nested" else "")
    bcs = ("ix1_bc = outflow\nox1_bc = outflow\n"
           "ix2_bc = reflect\nox2_bc = reflect") if name == "outflow" else ""
    return _BASE.format(n=16, n3=16, lo=-0.5 - _SHIFT, hi=0.5 - _SHIFT,
                        bcs=bcs, mb=4, mb3=4, pgen="blast", region2="")


DECKS = ("2d", "3d", "nested", "outflow")


def meshes(name: str):
    """(JAX Mesh, port Mesh) of a deck."""
    text = deck(name)
    return (JaxMesh(JaxInput.from_string(text)),
            Mesh(ParameterInput.from_string(text)))


def _assert_tables_equal(ref, got, where):
    if isinstance(ref, dict):
        assert set(k for k in got if not str(k).startswith("_")) == set(ref), \
            where
        for k in ref:
            _assert_tables_equal(ref[k], got[k], f"{where}/{k}")
    elif isinstance(ref, np.ndarray):
        assert got.dtype == ref.dtype, where
        np.testing.assert_array_equal(got, ref, err_msg=where)
    else:
        assert got == ref, where


@pytest.mark.parametrize("name", DECKS)
def test_tree_and_tables_match_jax(name):
    """Leaves, levels, logical locations, every ml table, the neighbour
    tables and masks, and the block geometry: equal to the JAX
    package's."""
    mj, mt = meshes(name)
    assert mt.multilevel and mj.multilevel
    assert mt.leaves == mj.leaves
    assert mt.nmb_total == mj.nmb_total == {"2d": 28, "3d": 120,
                                            "nested": 40,
                                            "outflow": 120}[name]
    assert mt.max_level == mj.max_level == (2 if name == "nested" else 1)
    np.testing.assert_array_equal(mt.lloc_eachmb, mj.lloc_eachmb)
    np.testing.assert_array_equal(mt.mb_lev, mj.mb_lev)
    _assert_tables_equal(mj.ml, mt.ml, "ml")
    assert set(mt.nbr_gid) == set(mj.nbr_gid)
    for key in mj.nbr_gid:
        np.testing.assert_array_equal(mt.nbr_gid[key], mj.nbr_gid[key])
        np.testing.assert_array_equal(mt.phys_bc_mask[key],
                                      mj.phys_bc_mask[key])
    assert set(mt.mb_size) == set(mj.mb_size)
    for key in mj.mb_size:
        np.testing.assert_array_equal(mt.mb_size[key], mj.mb_size[key])
    for gid in range(mj.nmb_total):
        for a, b in zip(mt.cell_centers(gid) + mt.face_edges(gid),
                        mj.cell_centers(gid) + mj.face_edges(gid)):
            np.testing.assert_array_equal(a, b)


def _rel(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(got.numpy() - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("axes", [[-1], [-2, -1], [-3, -2, -1], [-3, -1]])
def test_restrict_and_prolong_match_jax(axes):
    """restrict_cc and prolong_cc of random float64 arrays."""
    rng = np.random.default_rng(len(axes))
    x = rng.normal(size=(3, 2, 6, 8, 10))
    assert _rel(torch_ref.restrict_cc(torch.from_numpy(x), axes),
                jax_ref.restrict_cc(jnp.asarray(x), axes)) <= 1e-15
    assert _rel(torch_ref.prolong_cc(torch.from_numpy(x), axes),
                jax_ref.prolong_cc(jnp.asarray(x), axes)) <= 1e-15


@pytest.mark.parametrize("name", ["2d", "3d"])
def test_flux_correct_matches_jax(name):
    """flux_correct_cc on random fluxes: the coarse faces next to finer
    blocks take the fine average, every other face keeps its flux."""
    mj, mt = meshes(name)
    mbi = mt.mb_indcs
    dirs = ["x1", "x2", "x3"][:3 if mbi.nx3 > 1 else 2]
    rng = np.random.default_rng(5)
    shape = (mt.nmb_total, 5, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    flx = {d: rng.normal(size=shape) for d in dirs}
    ref = jax_ref.flux_correct_cc({d: jnp.asarray(f) for d, f in flx.items()},
                                  mj, dirs)
    inp = {d: torch.from_numpy(f.copy()) for d, f in flx.items()}
    got = torch_ref.flux_correct_cc(inp, mt, dirs)
    for d in dirs:
        assert _rel(got[d], ref[d]) <= 1e-15, d
        assert not np.array_equal(np.asarray(ref[d]), flx[d])
        # the input is not written
        np.testing.assert_array_equal(inp[d].numpy(), flx[d])
