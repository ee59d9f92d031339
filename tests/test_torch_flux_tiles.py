"""The tile geometry of kernel J (``csrc/flux_tile.cuh``), built for the
host with g++.

Kernel J (``csrc/flux_dir.cu``) cuts the cells of a pool, ghosts
included, into CUDA blocks of tj x ti columns and a segment of planes,
and stages for each plane the stencil window of its faces along the
direction (``flux_window``; its cells by ``flux_cell``).  This file
compiles the header with g++ and checks, for the three directions, at
the smr deck's 120 blocks of 36^3, the Orszag-Tang deck's 1028^2 plane
(n3 = 1: x1 and x2 only), the 2-D MHD decks (``kh2d-lecoanet-mhd``
132^2, ``current_sheet`` 68 x 132), the 1-D ``bw`` row (260 cells with
ghosts, n3 = n2 = 1: x1 only) and ragged shapes, for several numbers of
resident blocks:

  * every output face (every entry of flux, ey and ez) is computed by
    exactly one CUDA block;
  * every stencil read of a face, at the window position the kernel
    reads (column ir + s along x1, row jr + s along x2, sequence plane
    k - 2 + s along x3), holds the cell the plain version's ``torch.roll``
    reads, wrapped reads included; every staged cell lies inside the
    block;
  * a block's shared memory fits the blocks an SM the design counts on.

The test skips where no g++ is installed.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parent.parent / "athenak_tpu_torch" / "csrc"
SMEM_SM = 233472             # bytes of shared memory an SM holds
SMEM_RESERVED = 1024         # bytes the runtime keeps for each block

# (nmb, n3, n2, n1): the smr deck, the 1028^2 Orszag-Tang block, the
# 2-D MHD decks, the 1-D bw row, and ragged shapes
# (tests/test_torch_cuda.py's among them, its 1-D rows too); last,
# rt2d-mhd's 64 x 192 block with its ghosts; last, inputs/mhd/blast_amr's
# 64 blocks of 16^3 with their ghosts
SHAPES = [(120, 36, 36, 36), (1, 1, 1028, 1028), (1, 1, 132, 132),
          (1, 1, 68, 132), (1, 1, 1, 260), (2, 1, 1, 37), (2, 12, 10, 14),
          (2, 1, 12, 16), (3, 9, 7, 5), (1, 4, 4, 4), (2, 1, 30, 27),
          (2, 40, 14, 38), (1, 1, 196, 68), (64, 20, 20, 20)]
SLOTS = [396, 132, 7]        # resident blocks: 3 an SM, 1 an SM, a few

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include "flux_tile.cuh"
using namespace athenak;

template <class T>
void run(int dir, int nmb, int n3, int n2, int n1, long long slots) {
  using S = FluxTile<T>;
  const FluxGeom g = flux_geom(nmb, n3, n2, n1, dir, S::TJ, S::TI, slots);
  const FluxWin w = flux_window(dir, S::TJ, S::TI);
  printf("tile %d %d %d\n", S::TJ, S::TI, S::MINB);
  printf("smem %zu %d\n", flux_smem(dir, S::TJ, S::TI) * sizeof(T),
         flux_ring(dir));
  printf("window %d %d %d %d %d %d\n", w.j_lo, w.nj, w.i_lo, w.ni, w.k_lo,
         w.k_hi);
  printf("geom %d %d %d %d %lld\n", g.ntj, g.nti, g.nseg, g.seg, g.blocks);
  for (int m = 0; m < nmb; ++m)
    for (int s = 0; s < g.nseg; ++s)
      for (int t = 0; t < g.ntj * g.nti; ++t) {
        const FluxBox b = flux_box(g, t, s, m);
        printf("box %d %d %d %d %d %d %d\n", b.m, b.k0, b.k1, b.j0, b.j1,
               b.i0, b.i1);
        printf("rows");
        for (int jj = 0; jj < w.nj; ++jj)
          printf(" %d", flux_cell(b.j0 + w.j_lo + jj, n2, dir == 1));
        printf("\ncols");
        for (int ii = 0; ii < w.ni; ++ii)
          printf(" %d", flux_cell(b.i0 + w.i_lo + ii, n1, dir == 0));
        printf("\nplanes");
        for (int q = b.k0 + w.k_lo; q <= b.k1 - 1 + w.k_hi; ++q)
          printf(" %d", flux_cell(q, n3, dir == 2));
        printf("\n");
      }
}

int main(int argc, char** argv) {
  const int dir = atoi(argv[2]), nmb = atoi(argv[3]), n3 = atoi(argv[4]),
            n2 = atoi(argv[5]), n1 = atoi(argv[6]);
  const long long slots = atoll(argv[7]);
  if (std::string(argv[1]) == "f32")
    run<float>(dir, nmb, n3, n2, n1, slots);
  else
    run<double>(dir, nmb, n3, n2, n1, slots);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("flux_tiles")
    (d / "h.cpp").write_text(HARNESS)
    exe = d / "h"
    subprocess.run([gxx, "-std=c++17", "-O1", "-D__host__=", "-D__device__=",
                    "-I", str(CSRC), "-o", str(exe), str(d / "h.cpp")],
                   check=True)
    return exe


def _run(exe, dtype, d, shape, slots):
    out = subprocess.run([str(exe), dtype, str(d), *map(str, shape),
                          str(slots)], check=True, capture_output=True,
                         text=True).stdout
    rec = {"blocks": []}
    for line in out.splitlines():
        key, *vals = line.split()
        vals = np.array([int(v) for v in vals], dtype=np.int64)
        if key == "box":
            rec["blocks"].append({"box": vals})
        elif key in ("rows", "cols", "planes"):
            rec["blocks"][-1][key] = vals
        else:
            rec[key] = vals
    return rec


def _dirs(shape):
    """The directions a block of this shape runs: x2 and x3 only where
    the axis has cells beyond its ghosts."""
    return [0] + [1] * (shape[2] >= 4) + [2] * (shape[1] >= 4)


CASES = [(dt, d, s) for dt in ("f32", "f64") for s in SHAPES
         for d in _dirs(s)]


def _id(case):
    dt, d, s = case
    return f"{dt}-x{d + 1}-{'x'.join(map(str, s))}"


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_every_face_once(harness, case):
    dtype, d, shape = case
    nmb, n3, n2, n1 = shape
    for slots in SLOTS:
        rec = _run(harness, dtype, d, shape, slots)
        count = np.zeros(shape, dtype=np.int64)
        for blk in rec["blocks"]:
            m, k0, k1, j0, j1, i0, i1 = blk["box"]
            count[m, k0:k1, j0:j1, i0:i1] += 1
        assert count.min() == 1 and count.max() == 1
        ntj, nti, nseg, seg, blocks = rec["geom"]
        assert blocks == len(rec["blocks"]) == nmb * ntj * nti * nseg
        assert nseg * seg >= n3


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_stencil_reads_inside_the_window(harness, case):
    dtype, d, shape = case
    _, n3, n2, n1 = shape
    rec = _run(harness, dtype, d, shape, SLOTS[0])
    j_lo, _, i_lo, _, k_lo, k_hi = rec["window"]
    for blk in rec["blocks"]:
        _, k0, k1, j0, j1, i0, i1 = blk["box"]
        rows, cols, planes = blk["rows"], blk["cols"], blk["planes"]
        # every staged cell lies inside the block
        for idx, n in ((rows, n2), (cols, n1), (planes, n3)):
            assert idx.min() >= 0 and idx.max() < n
        assert len(planes) == (k1 - k0) - k_lo + k_hi
        # the faces of the block: thread (jr, ir) of planes k0 .. k1 - 1
        shape2 = (j1 - j0, i1 - i0)
        jr = np.arange(j1 - j0)[:, None]
        ir = np.arange(i1 - i0)[None, :]
        j, i = j0 + jr, i0 + ir
        k = np.arange(k0, k1)
        for s in range(4):
            if d == 0:
                got = rows[jr - j_lo], cols[ir + s], planes[k - k0]
                want = j, (i - 2 + s) % n1, k
            elif d == 1:
                got = rows[jr + s], cols[ir - i_lo], planes[k - k0]
                want = (j - 2 + s) % n2, i, k
            else:
                # sequence position k - 2 + s is planes[k - k0 + s]
                got = rows[jr - j_lo], cols[ir - i_lo], planes[k - k0 + s]
                want = j, i, (k - 2 + s) % n3
            for g, w in zip(got[:2], want[:2]):
                assert np.array_equal(np.broadcast_to(g, shape2),
                                      np.broadcast_to(w, shape2)), (blk, s)
            assert np.array_equal(got[2], want[2]), (blk, s)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("d", [0, 1, 2])
def test_shared_memory_fits(harness, dtype, d):
    rec = _run(harness, dtype, d, SHAPES[0], SLOTS[0])
    minb = rec["tile"][2]
    smem, ring = rec["smem"]
    assert ring == (5 if d == 2 else 2)
    assert minb * (smem + SMEM_RESERVED) <= SMEM_SM
    if dtype == "f32":
        assert minb >= 3
