"""Parity of the port's pool fill (``athenak_tpu_torch/ops/pool_fill.py``)
with the JAX package.

  * ``neighbor27``: the same donor table as the JAX package's.
  * The plain version (the ordered x3 -> x2 -> x1 slab copies) against the
    JAX ``pool_fill`` in Pallas interpret mode, float32, bitwise, cell and
    face arrays, over three block layouts.
  * The same against the port's and the JAX package's general sweep
    fills (``fill_ghosts``, ``fill_ghosts_fc``) in float64, bitwise:
    every ghost is a copy of one interior element, whatever the order.
Inputs are random arrays from numpy's default_rng, ghosts included.  The
JAX side runs under ``jax.jit`` at XLA's backend optimisation level 0,
which compiles faster on the CPU; a copy is a copy at any level.
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.athinput import ParameterInput  # noqa: E402
from athenak_tpu.main import build as jax_build  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu.ops import pallas_pool_fill  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput as TorchInput  # noqa
from athenak_tpu_torch.main import build as torch_build  # noqa: E402
from athenak_tpu_torch.mesh import Mesh as TorchMesh  # noqa: E402
from athenak_tpu_torch.ops import pool_fill  # noqa: E402

NB = 8          # cells of a block along each axis
LAYOUTS = [(2, 2, 2), (4, 2, 1), (1, 1, 2)]   # blocks along x1, x2, x3

DECK = """
<job>
basename = pool
<mesh>
nghost = 2
nx1 = {n1}
x1min = -0.5
x1max = 0.5
nx2 = {n2}
x2min = -0.5
x2max = 0.5
nx3 = {n3}
x3min = -0.5
x3max = 0.5
coalesce = false
pencil_pack = false
<meshblock>
nx1 = {nb}
nx2 = {nb}
nx3 = {nb}
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.3
tlim = 1.0
<mhd>
eos = ideal
reconstruct = plm
rsolver = hlld
<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 100.0
"""


def _deck(layout):
    return DECK.format(n1=NB * layout[0], n2=NB * layout[1],
                       n3=NB * layout[2], nb=NB)


def _arrays(nmb, dtype, seed=3):
    """Random cell and face arrays of nmb blocks, keyed by pool-fill kind."""
    rng = np.random.default_rng(seed)
    n = NB + 4
    shapes = {"cc": (nmb, 5, n, n, n), "x1f": (nmb, n, n, n + 1),
              "x2f": (nmb, n, n + 1, n), "x3f": (nmb, n + 1, n, n)}
    return {k: rng.normal(size=s).astype(dtype) for k, s in shapes.items()}


def _jit_o0(fn):
    """``jax.jit`` at backend optimisation level 0."""
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


@pytest.fixture
def f32_interpret():
    """float32 + Pallas interpret mode, restored afterwards."""
    jax.config.update("jax_enable_x64", False)
    pallas_pool_fill.INTERPRET = True
    yield
    pallas_pool_fill.INTERPRET = False
    jax.config.update("jax_enable_x64", True)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_neighbor27_matches_jax(layout):
    mt = TorchMesh(TorchInput.from_string(_deck(layout)))
    mj = JaxMesh(ParameterInput.from_string(_deck(layout)))
    assert mt.nmb_total == mj.nmb_total == int(np.prod(layout))
    assert pool_fill.supports_pool_fill(mt)
    np.testing.assert_array_equal(pool_fill.neighbor27(mt),
                                  pallas_pool_fill.neighbor27(mj))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_pool_fill_matches_pallas_interpret(f32_interpret, layout):
    mt = TorchMesh(TorchInput.from_string(_deck(layout)))
    mj = JaxMesh(ParameterInput.from_string(_deck(layout)))
    arrs = _arrays(mt.nmb_total, np.float32)
    nbr = pool_fill.neighbor27(mt)
    ref_u, ref_b = _jit_o0(lambda u, b: (
        pallas_pool_fill.pool_fill_cc(u, nbr, mj),
        pallas_pool_fill.pool_fill_fc(b, nbr, mj)))(
        jnp.asarray(arrs["cc"]),
        {k: jnp.asarray(arrs[k]) for k in ("x1f", "x2f", "x3f")})
    got = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    out_u = pool_fill.pool_fill_cc(got["cc"], nbr, mt)
    out_b = pool_fill.pool_fill_fc(
        {k: got[k] for k in ("x1f", "x2f", "x3f")}, nbr, mt)
    assert out_u is got["cc"]           # filled in place
    np.testing.assert_array_equal(got["cc"].numpy(), np.asarray(ref_u))
    for k in ("x1f", "x2f", "x3f"):
        assert out_b[k] is got[k]
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref_b[k]),
                                      err_msg=k)
    # the ghosts changed, the interiors did not
    assert not np.array_equal(got["cc"].numpy(), arrs["cc"])
    np.testing.assert_array_equal(got["cc"].numpy()[..., 2:-2, 2:-2, 2:-2],
                                  arrs["cc"][..., 2:-2, 2:-2, 2:-2])
    assert kernels.POOL_FILL.launches == 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_pool_fill_matches_sweep_fills_f64(layout):
    """Bitwise equal to the port's general sweeps (x1 -> x2 -> x3, the
    pool gate switched off) and to the JAX package's, in float64."""
    mj, pj, _, _, _ = jax_build(ParameterInput.from_string(_deck(layout)))
    mt, pt, _, _, _ = torch_build(TorchInput.from_string(_deck(layout)),
                                  device="cpu")
    assert pt.bvals.use_pool_fill and not pt.bvals.pool_fill_active(
        torch.zeros(1, dtype=torch.float64))
    arrs = _arrays(mt.nmb_total, np.float64, seed=4)
    nbr = pt.bvals.nbr27()
    fcs = ("x1f", "x2f", "x3f")
    got = {k: torch.from_numpy(v.copy()) for k, v in arrs.items()}
    pool_fill.pool_fill_cc(got["cc"], nbr, mt)
    pool_fill.pool_fill_fc({k: got[k] for k in fcs}, nbr, mt)
    sweep_u = pt.bvals.fill_ghosts(torch.from_numpy(arrs["cc"].copy()))
    sweep_b = pt.fill_ghosts_fc({k: torch.from_numpy(arrs[k].copy())
                                 for k in fcs})
    jax_u, jax_b = _jit_o0(lambda u, b: (pj.bvals.fill_ghosts(u),
                                         pj.fill_ghosts_fc(b)))(
        jnp.asarray(arrs["cc"]), {k: jnp.asarray(arrs[k]) for k in fcs})
    jax_u = np.asarray(jax_u)
    np.testing.assert_array_equal(got["cc"].numpy(), sweep_u.numpy())
    np.testing.assert_array_equal(got["cc"].numpy(), jax_u)
    for k in fcs:
        np.testing.assert_array_equal(got[k].numpy(), sweep_b[k].numpy(),
                                      err_msg=k)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jax_b[k]),
                                      err_msg=k)


# ---------------------------------------------------------------------------
# Kernel G's flat enumeration (csrc/pool_fill.cuh), mirrored in numpy and
# built for the host with g++: every ghost written once, from its donor.

KTHREADS, KSLOTS = 256, 8          # csrc/common.cuh kThreads, pool_fill.cu
# (blocks along x1, x2, x3, cells of a block): the turb8 and pool decks'
# pools, the layouts above and one odd interior extent
ENUM_CASES = [((2, 2, 2), 64), ((2, 2, 2), 62)] + \
    [(layout, NB) for layout in LAYOUTS] + [((2, 1, 2), 7)] \
    + [((4, 4, 4), 16)]   # inputs/mhd/blast_amr's flat tree, no pool
CALLS = [("cc",), ("x1f", "x2f", "x3f")]

ENUM_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "pool_fill.cuh"
using namespace athenak;
// argv: table out nmb narr ng3 ng2 ng1, then per array nc n3 n2 n1 nint3
// nint2 nint1 vec.  Writes [q, m, c, k, j, i, dst, src] (int64) for every
// item in order.
int main(int argc, char** argv) {
  PoolCall p{};
  int a = 3;
  p.nmb = atoi(argv[a++]);
  p.narr = atoi(argv[a++]);
  p.ng3 = atoi(argv[a++]);
  p.ng2 = atoi(argv[a++]);
  p.ng1 = atoi(argv[a++]);
  for (int q = 0; q < p.narr; ++q) {
    PoolArray& r = p.arr[q];
    int* f[] = {&r.nc, &r.n3, &r.n2, &r.n1, &r.nint3, &r.nint2, &r.nint1,
                &r.vec};
    for (int* x : f) *x = atoi(argv[a++]);
  }
  pool_finish(p);
  std::vector<int> nbr(p.nmb * 27);
  FILE* t = fopen(argv[1], "rb");
  if (fread(nbr.data(), 4, nbr.size(), t) != nbr.size()) return 1;
  fclose(t);
  FILE* o = fopen(argv[2], "wb");
  for (long long it = 0; it < p.total; ++it) {
    const GhostItem g = pool_locate(p, static_cast<int>(it));
    long long rec[8] = {g.q, g.m, g.c, g.k, g.j, g.i, 0, 0};
    pool_offsets(p, g, nbr[g.m * 27 + pool_dir(g)], rec[6], rec[7]);
    fwrite(rec, 8, 8, o);
  }
  fclose(o);
  return 0;
}
"""


def _enum_mesh(layout, nb):
    deck = DECK.format(n1=nb * layout[0], n2=nb * layout[1],
                       n3=nb * layout[2], nb=nb)
    return TorchMesh(TorchInput.from_string(deck))


def _call(mesh, kinds):
    """The C entry's description of a fill of ``kinds`` on ``mesh``:
    dims, ghost widths, and each array's shape and vec (pointers of a
    fresh allocation are aligned)."""
    nmb, n = mesh.nmb_total, mesh.mb_indcs.ncells1
    shapes = {"cc": (nmb, 5, n, n, n), "x1f": (nmb, n, n, n + 1),
              "x2f": (nmb, n, n + 1, n), "x3f": (nmb, n + 1, n, n)}
    shp = [shapes[k] for k in kinds]
    dims, ngs = pool_fill.call_dims(shp, kinds, mesh)
    vecs = [2 if (d[3] % 2 == 0 and ngs[2] % 2 == 0 and d[6] % 2 == 0)
            else 1 for d in np.reshape(dims, (-1, 8))]
    return dims, ngs, shp, vecs


def _mirror_items(dims, ngs, nmb, vecs):
    """[q, m, c, k, j, i] of every item in the kernel's order, listed
    plane by plane (not by the kernel's divisions)."""
    ng3, ng2, ng1 = ngs
    per_m = []
    for q, (nc, n3, n2, n1, *_), vec in zip(range(len(vecs)),
                                            np.reshape(dims, (-1, 8)), vecs):
        row = np.arange(0, n1, vec)
        cols = np.concatenate([np.arange(0, ng1, vec),
                               np.arange(n1 - ng1, n1, vec)])
        ghost = [(j, i) for j in range(n2) for i in row]
        inner = ([(j, i) for j in range(ng2) for i in row]
                 + [(j, i) for j in range(ng2, n2 - ng2) for i in cols]
                 + [(j, i) for j in range(n2 - ng2, n2) for i in row])
        ghost, inner = np.array(ghost), np.array(inner).reshape(-1, 2)
        items = []
        for c in range(nc):
            for k in range(n3):
                ji = ghost if (k < ng3 or k >= n3 - ng3) else inner
                head = np.tile([q, c, k], (len(ji), 1))
                items.append(np.concatenate([head, ji], axis=1))
        per_m.append(np.concatenate(items))
    block = np.concatenate(per_m)            # [q, c, k, j, i]
    out = np.empty((nmb * len(block), 6), dtype=np.int64)
    for m in range(nmb):
        sl = slice(m * len(block), (m + 1) * len(block))
        out[sl, 0] = block[:, 0]
        out[sl, 1] = m
        out[sl, 2:] = block[:, 1:]
    return out


def _side(p, n, ng):
    return np.where(p < ng, -1, np.where(p >= n - ng, 1, 0))


def _mirror_offsets(items, dims, ngs, nbr):
    """(dst, src) element offsets of each item's first element."""
    d = np.reshape(dims, (-1, 8))[items[:, 0]]
    nc, n3, n2, n1, i3, i2, i1 = (d[:, x].astype(np.int64) for x in range(7))
    q, m, c, k, j, i = items.T
    d3, d2, d1 = _side(k, n3, ngs[0]), _side(j, n2, ngs[1]), \
        _side(i, n1, ngs[2])
    donor = nbr[m, 9 * (d3 + 1) + 3 * (d2 + 1) + (d1 + 1)].astype(np.int64)
    plane = n2 * n1
    dst = ((m * nc + c) * n3 + k) * plane + j * n1 + i
    src = ((donor * nc + c) * n3 + k - d3 * i3) * plane \
        + (j - d2 * i2) * n1 + i - d1 * i1
    return dst, src


@pytest.mark.parametrize("layout,nb", ENUM_CASES)
@pytest.mark.parametrize("kinds", CALLS, ids=["cc", "fc"])
def test_pool_fill_enumeration_covers_every_ghost_once(layout, nb, kinds):
    """The numpy mirror of the kernel's (chunk, thread, slot) -> item ->
    (array, m, c, k, j, i) -> donor: every ghost of the plain fill is
    written exactly once, from the element ``ghost_donors`` finds, and a
    chunk's items touch only the rows of the donor table its CUDA block
    stages for it."""
    import chip_smoke
    mesh = _enum_mesh(layout, nb)
    nmb = mesh.nmb_total
    nbr = pool_fill.neighbor27(mesh)
    dims, ngs, shapes, vecs = _call(mesh, kinds)
    items = _mirror_items(dims, ngs, nmb, vecs)
    total = len(items)
    per_block = total // nmb
    ipb = KTHREADS * KSLOTS
    nblocks = -(-total // ipb)
    b, s, x = np.meshgrid(np.arange(nblocks), np.arange(KSLOTS),
                          np.arange(KTHREADS), indexing="ij")
    t = (b * ipb + s * KTHREADS + x).ravel()
    t = t[t < total]
    assert np.array_equal(np.sort(t), np.arange(total))
    span = min((ipb - 1) // per_block + 2, nmb)
    m_lo = (np.arange(nblocks) * ipb) // per_block
    m_of = items[:, 1]
    blk = np.arange(total) // ipb
    assert np.all((m_of >= m_lo[blk]) & (m_of < m_lo[blk] + span))
    dst, src = _mirror_offsets(items, dims, ngs, nbr)
    for q, (kind, shape) in enumerate(zip(kinds, shapes)):
        sel = items[:, 0] == q
        vec = vecs[q]
        e_dst = (dst[sel][:, None] + np.arange(vec)).ravel()
        e_src = (src[sel][:, None] + np.arange(vec)).ravel()
        g_dst, g_src = chip_smoke.ghost_donors(torch, pool_fill, shape, kind,
                                               nbr, mesh)
        order = np.argsort(e_dst)
        np.testing.assert_array_equal(e_dst[order], g_dst.numpy(),
                                      err_msg=kind)
        np.testing.assert_array_equal(e_src[order], g_src.numpy(),
                                      err_msg=kind)


@pytest.fixture(scope="module")
def enum_harness(tmp_path_factory):
    import shutil
    import subprocess
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("pool_enum")
    (d / "h.cpp").write_text(ENUM_HARNESS)
    csrc = str(Path(pool_fill.__file__).parent.parent / "csrc")
    exe = d / "h"
    subprocess.run([gxx, "-std=c++17", "-O1", "-D__host__=", "-D__device__=",
                    "-I", csrc, "-o", str(exe), str(d / "h.cpp")],
                   check=True)
    return exe, d


@pytest.mark.parametrize("layout,nb", ENUM_CASES)
def test_pool_fill_enumeration_host_build(enum_harness, layout, nb):
    """``csrc/pool_fill.cuh`` built with g++ gives, item by item, the
    mirror's (array, m, c, k, j, i) and offsets, for the cell call and
    the face call."""
    import subprocess
    exe, d = enum_harness
    mesh = _enum_mesh(layout, nb)
    nmb = mesh.nmb_total
    nbr = pool_fill.neighbor27(mesh)
    table = d / f"nbr_{nmb}.bin"
    nbr.astype(np.int32).tofile(table)
    for kinds in CALLS:
        dims, ngs, _, vecs = _call(mesh, kinds)
        args = [str(nmb), str(len(kinds)), *map(str, ngs)]
        for q, dq in enumerate(np.reshape(dims, (-1, 8))):
            args += [str(v) for v in dq[:7]] + [str(vecs[q])]
        out = d / "items.bin"
        subprocess.run([str(exe), str(table), str(out), *args], check=True)
        got = np.fromfile(out, dtype=np.int64).reshape(-1, 8)
        items = _mirror_items(dims, ngs, nmb, vecs)
        np.testing.assert_array_equal(got[:, :6], items, err_msg=str(kinds))
        dst, src = _mirror_offsets(items, dims, ngs, nbr)
        np.testing.assert_array_equal(got[:, 6], dst)
        np.testing.assert_array_equal(got[:, 7], src)
