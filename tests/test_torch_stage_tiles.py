"""The tile geometry of kernels A and E (``csrc/stage_tile.cuh``), built
for the host with g++.

Kernel A (``csrc/mega_stage_v2.cu``) cuts the interior cells of a pool
into CUDA blocks of tj x ti columns and a segment of planes, and computes
around each tile the primitives, fluxes and corner EMFs its updates read
(``prim_range``, ``flux_range``, ``edge_range`` and their k ranges).  The
header is plain C++ apart from CUDA's function qualifiers; this file
compiles it with g++ and checks, at the 124^3 blast (128^3 with ghosts),
the 8 x 62^3 pool (66^3), the 64 x 32 x 32 MHD test decks
(``linear_wave_mhd``, ``cpaw3d``, ``field_loop3d``: 68 x 36 x 36 with
ghosts) and the card tests' small shapes, with the
float32 and float64 tiles and for several numbers of resident blocks;
and the same for kernel E (``csrc/mega_stage_v1.cu``), which takes the
same cut and ranges, at turb1 (132^3), turb8 (8 x 68^3) and its card
tests' shapes, with its own shared memory (``stage_v1_smem``):

  * every interior cell is updated by exactly one CUDA block;
  * every face flux and corner EMF that a cell's update reads, and every
    flux, EMF and primitive that those in turn read, lies inside
    what its block computes, and every primitive that a used flux or EMF
    reads lies inside the array (a ragged tile clamps only reads nobody
    uses);
  * a block's shared memory stays within the 227 KB a block may have on
    an H100, and a float32 block leaves room for two on one SM.

The reads are listed here from the stage's stencils (PLM over four cells,
the GS07 corners and the update and CT of ``mega_stage_v2.cu``'s
phases C and D), not from the header.  The test skips where no g++ is
installed.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parent.parent / "athenak_tpu_torch" / "csrc"
SMEM_BLOCK = 232448          # bytes a block may use on an H100
SMEM_SM = 233472             # bytes of shared memory an SM holds
SMEM_RESERVED = 1024         # bytes the runtime keeps for each block
STATIC_SMEM = 256            # bytes of static shared memory, at most

# (nmb, n3, n2, n1) with ghosts: the 124^3 blast, the 8 x 62^3 pool, the
# 64 x 32 x 32 MHD test decks, and tests/test_torch_cuda.py's 20^3 block,
# 2 x 2 x 1 pool of 13 x 17 x 11 interior cells and 12^3 block; last,
# inputs/mhd/blast_amr's flat tree without its block pool (64 x 16^3)
SHAPES = [(1, 128, 128, 128), (8, 66, 66, 66), (1, 36, 36, 68),
          (1, 24, 24, 24), (4, 15, 21, 17), (1, 12, 12, 12),
          (64, 20, 20, 20)]
SLOTS = [264, 132, 7]        # resident blocks: 2 an SM, 1 an SM, a few

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include "stage_tile.cuh"
using namespace athenak;

template <class T>
void run(int nmb, int n3, int n2, int n1, long long slots) {
  using S = StageTile<T>;
  const TileGeom g = tile_geom(nmb, n3, n2, n1, 2, S::TJ, S::TI, slots);
  printf("tile %d %d %d %d\n", S::TJ, S::TI, S::NT, S::MINB);
  printf("smem %zu\n", stage_smem(S::TJ, S::TI).total * sizeof(T));
  printf("smem_v1 %zu\n", stage_v1_smem(S::TJ, S::TI).total * sizeof(T) +
                           stage_v1_smem(S::TJ, S::TI).tables * sizeof(int));
  const TileRange rs[] = {prim_range(S::TJ, S::TI),
                          flux_range(0, S::TJ, S::TI),
                          flux_range(1, S::TJ, S::TI),
                          flux_range(2, S::TJ, S::TI),
                          edge_range(0, S::TJ, S::TI),
                          edge_range(1, S::TJ, S::TI),
                          edge_range(2, S::TJ, S::TI)};
  const KRange ks[] = {kPrimK, kFluxK12, kFluxK12, kFluxK3,
                       kEdgeK12, kEdgeK12, kEdgeK3};
  for (int q = 0; q < 7; ++q)
    printf("range %d %d %d %d %d %d\n", rs[q].j_lo, rs[q].nj, rs[q].i_lo,
           rs[q].ni, ks[q].lo, ks[q].hi);
  printf("geom %d %d %lld\n", g.nseg, g.seg, g.blocks);
  for (long long b = 0; b < g.blocks; ++b) {
    const TileBox t = tile_box(g, b);
    printf("box %d %d %d %d %d %d %d\n", t.m, t.k0, t.k1, t.j0, t.j1, t.i0,
           t.i1);
  }
}

int main(int argc, char** argv) {
  const int nmb = atoi(argv[2]), n3 = atoi(argv[3]), n2 = atoi(argv[4]),
            n1 = atoi(argv[5]);
  const long long slots = atoll(argv[6]);
  if (std::string(argv[1]) == "f32")
    run<float>(nmb, n3, n2, n1, slots);
  else
    run<double>(nmb, n3, n2, n1, slots);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("stage_tiles")
    (d / "h.cpp").write_text(HARNESS)
    exe = d / "h"
    subprocess.run([gxx, "-std=c++17", "-O1", "-D__host__=", "-D__device__=",
                    "-I", str(CSRC), "-o", str(exe), str(d / "h.cpp")],
                   check=True)
    return exe


def _run(exe, dtype, shape, slots):
    out = subprocess.run([str(exe), dtype, *map(str, shape), str(slots)],
                         check=True, capture_output=True, text=True).stdout
    rec = {"range": [], "box": []}
    for line in out.splitlines():
        key, *vals = line.split()
        vals = [int(v) for v in vals]
        if key in rec:
            rec[key].append(vals)
        else:
            rec[key] = vals
    rec["box"] = np.array(rec["box"], dtype=np.int64).reshape(-1, 7)
    return rec


class Box:
    """A box of (k, j, i) indices, inclusive bounds."""

    def __init__(self, k, j, i):
        self.k, self.j, self.i = k, j, i

    def empty(self):
        return any(lo > hi for lo, hi in (self.k, self.j, self.i))

    def shift(self, dk=(0, 0), dj=(0, 0), di=(0, 0)):
        """The union of the box moved by dk, dj, di (each a (lo, hi)
        span of offsets)."""
        return Box(*((lo + d[0], hi + d[1]) for (lo, hi), d in
                     zip((self.k, self.j, self.i), (dk, dj, di))))

    def within(self, other):
        return self.empty() or all(
            o[0] <= lo and hi <= o[1]
            for (lo, hi), o in zip((self.k, self.j, self.i),
                                   (other.k, other.j, other.i)))


def _computed(rng, kr, b):
    """What a block computes of one quantity: its TileRange and KRange
    applied to the block's tile and planes."""
    j_lo, nj, i_lo, ni = rng[:4]
    _, k0, k1, j0, _, i0, _ = b
    return Box((k0 + kr[0], k1 - 1 + kr[1]), (j0 + j_lo, j0 + j_lo + nj - 1),
               (i0 + i_lo, i0 + i_lo + ni - 1))


def _check_block(rec, b, shape):
    nmb, n3, n2, n1 = shape
    names = ("prim", "x1", "x2", "x3", "e1", "e2", "e3")
    comp = {n: _computed(r, r[4:], b) for n, r in zip(names, rec["range"])}
    _, k0, k1, j0, j1, i0, i1 = b
    cells = Box((k0, k1 - 1), (j0, j1 - 1), (i0, i1 - 1))
    # what the updates read (a face or edge carries the index of the cell
    # above it): the RK update's fluxes and the CT's corner EMFs
    need = {"x1": cells.shift(di=(0, 1)), "x2": cells.shift(dj=(0, 1)),
            "x3": cells.shift(dk=(0, 1)),
            "e1": cells.shift(dk=(0, 1), dj=(0, 1)),
            "e2": cells.shift(dk=(0, 1), di=(0, 1)),
            "e3": cells.shift(dj=(0, 1), di=(0, 1))}
    # what the corner EMFs read (the gs07 calls of phase C)
    e1, e2, e3 = need["e1"], need["e2"], need["e3"]
    extra = {"x2": [e1.shift(dk=(-1, 0)), e3.shift(di=(-1, 0))],
             "x3": [e1.shift(dj=(-1, 0)), e2.shift(di=(-1, 0))],
             "x1": [e2.shift(dk=(-1, 0)), e3.shift(dj=(-1, 0))]}
    cc = [e1.shift(dk=(-1, 0), dj=(-1, 0)), e2.shift(dk=(-1, 0), di=(-1, 0)),
          e3.shift(dj=(-1, 0), di=(-1, 0))]
    for name, box in need.items():
        assert box.within(comp[name]), (name, b)
    for name, boxes in extra.items():
        for box in boxes:
            assert box.within(comp[name]), (name, b)
    # the primitives the used fluxes and EMFs read: PLM's four cells
    used = {n: [need[n]] + extra.get(n, []) for n in ("x1", "x2", "x3")}
    prim = [bx.shift(di=(-2, 1)) for bx in used["x1"]] + \
        [bx.shift(dj=(-2, 1)) for bx in used["x2"]] + \
        [bx.shift(dk=(-2, 1)) for bx in used["x3"]] + cc + [cells]
    array = Box((0, n3 - 1), (0, n2 - 1), (0, n1 - 1))
    for box in prim:
        assert box.within(comp["prim"]), ("prim", b)
        assert box.within(array), ("array", b)


def _cells_once(harness, dtype, shape):
    nmb, n3, n2, n1 = shape
    for slots in SLOTS:
        rec = _run(harness, dtype, shape, slots)
        count = np.zeros(shape, dtype=np.int64)
        for m, k0, k1, j0, j1, i0, i1 in rec["box"]:
            count[m, k0:k1, j0:j1, i0:i1] += 1
        assert count[:, 2:-2, 2:-2, 2:-2].min() == 1
        assert count.max() == 1
        assert count.sum() == nmb * (n3 - 4) * (n2 - 4) * (n1 - 4)
        nseg, seg, blocks = rec["geom"]
        assert blocks == len(rec["box"]) and nseg * seg >= n3 - 4


def _reads_inside(harness, dtype, shape):
    rec = _run(harness, dtype, shape, SLOTS[0])
    for b in rec["box"]:
        _check_block(rec, b, shape)


def _smem_fits(harness, dtype, key):
    rec = _run(harness, dtype, SHAPES[0], SLOTS[0])
    tj, ti, nt, minb = rec["tile"]
    smem = rec[key][0] + STATIC_SMEM
    assert smem <= SMEM_BLOCK
    assert minb * (smem + SMEM_RESERVED) <= SMEM_SM
    if dtype == "f32":
        assert minb >= 2


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_every_interior_cell_once(harness, dtype, shape):
    _cells_once(harness, dtype, shape)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES)
def test_reads_lie_inside_the_halo(harness, dtype, shape):
    _reads_inside(harness, dtype, shape)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_shared_memory_fits(harness, dtype):
    _smem_fits(harness, dtype, "smem")


# Kernel E (csrc/mega_stage_v1.cu) takes the same cut, ranges and k
# ranges: at turb1 (128^3, 132^3 with ghosts), turb8 (8 x 68^3) and
# tests/test_torch_cuda.py's kernel E shapes
SHAPES_V1 = [(1, 132, 132, 132), (8, 68, 68, 68), (2, 16, 16, 16),
             (3, 15, 21, 17), (2, 13, 22, 19)]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES_V1)
def test_v1_every_interior_cell_once(harness, dtype, shape):
    _cells_once(harness, dtype, shape)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES_V1)
def test_v1_reads_lie_inside_the_halo(harness, dtype, shape):
    _reads_inside(harness, dtype, shape)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_v1_shared_memory_fits(harness, dtype):
    _smem_fits(harness, dtype, "smem_v1")
