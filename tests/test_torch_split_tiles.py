"""The tile geometry of kernel C (``csrc/split_tile.cuh``), built for the
host with g++.

Kernel C (``csrc/fused_stage.cu``) cuts the cells of a pool, ghosts
included, into tiles of tj x ti columns and segments of planes (kernel
J's cut), marches each tile through its planes, stages for every plane
a wrapped window of the eight channels and the normal field of its
faces in a ring of five planes, and solves one work list of faces a
plane (``split_item``).  This file compiles the header with g++ and
replays the kernel's march for every CUDA block, at the SR blast's
128^3 block with ghosts, at 2 x 36^3 and at ragged shapes, for several
numbers of resident blocks, float and double tiles:

  * every entry of acc (each cell) and of the mass fluxes and face EMFs
    (each lower face of a cell, per direction), ghosts included, is
    written by exactly one CUDA block (``split_owns``);
  * every stencil read of a face lies inside the staged window, in a
    plane the ring holds at that step, and finds the cell the plain
    version's ``torch.roll`` reads, wrapped reads included; the normal
    field of each face is the face the plain version reads
    (``split_nf``); the register update finds the x3 fluxes of its
    plane's two faces;
  * a block's shared memory fits the blocks an SM the design counts on.

The test skips where no g++ is installed.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parent.parent / "athenak_tpu_torch" / "csrc"
SMEM_SM = 233472             # bytes of shared memory an SM holds
SMEM_RESERVED = 1024         # bytes the runtime keeps for each block
SMEM_BLOCK = 232448          # the most one block may take

# (nmb, n3, n2, n1): the SR blast's block with ghosts, 2 x 36^3, ragged
# and small shapes (tests/test_torch_cuda.py's among them)
SHAPES = [(1, 128, 128, 128), (2, 36, 36, 36), (3, 9, 13, 37),
          (2, 12, 10, 14), (1, 6, 6, 6), (2, 15, 21, 17)]
SLOTS = [264, 132, 7]        # resident blocks: 2 an SM, 1 an SM, a few

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#define __host__
#define __device__
#include "split_tile.cuh"
using namespace athenak;

template <class T>
void run(int nmb, int n3, int n2, int n1, long long slots) {
  using S = SplitTile<T>;
  const int tj = S::TJ, ti = S::TI;
  const SplitShape H = split_shape(tj, ti);
  printf("smem %zu %d\n", (size_t)split_smem(tj, ti) * sizeof(T), S::MINB);
  const FluxGeom g = flux_geom(nmb, n3, n2, n1, 2, tj, ti, slots);
  const size_t nc = (size_t)nmb * n3 * n2 * n1;
  std::vector<int> acc(nc, 0), face(3 * nc, 0);
  long long bad_win = 0, bad_ring = 0, bad_cell = 0, bad_nf = 0,
            bad_f3 = 0;
  auto wrap = [](int p, int n) { return ((p % n) + n) % n; };
  for (int m = 0; m < nmb; ++m)
    for (int s = 0; s < g.nseg; ++s)
      for (int t = 0; t < g.ntj * g.nti; ++t) {
        const FluxBox b = flux_box(g, t, s, m);
        int ring[kSplitRing], f3[2] = {-1000, -1000};
        auto slot = [&](int q) { return (q - b.k0 + 2) % kSplitRing; };
        auto load = [&](int q) { ring[slot(q)] = q; };
        auto item = [&](int it, int k) {
          const SplitItem q = split_item(it, tj, ti);
          const int kf = q.dir == 2 ? k + 1 : k;
          for (int st = 0; st < 4; ++st) {
            const int row = q.dir == 1 ? q.wr + st : q.wr;
            const int col = q.dir == 0 ? q.wcol + st : q.wcol;
            const int pl = q.dir == 2 ? k - 1 + st : k;
            if (row < 0 || row >= H.wj || col < 0 || col >= H.wi) ++bad_win;
            if (ring[slot(pl)] != pl) ++bad_ring;
            // the staged cell, and the one torch.roll's stencil reads
            const int sk = split_cell(pl, n3),
                      sj = split_cell(b.j0 - 2 + row, n2),
                      si = split_cell(b.i0 - 2 + col, n1);
            const int d = st - 2;  // f-2 .. f+1
            const int ek = wrap(kf + (q.dir == 2 ? d : 0), n3),
                      ej = wrap(b.j0 + q.r + (q.dir == 1 ? d : 0), n2),
                      ei = wrap(b.i0 + q.c + (q.dir == 0 ? d : 0), n1);
            if (sk != ek || sj != ej || si != ei) ++bad_cell;
          }
          const int nf = split_nf(q, b.j0, b.i0, n2, n1);
          const int fj = wrap(b.j0 + q.r, n2), fi = wrap(b.i0 + q.c, n1);
          if (nf != (q.dir == 0 ? fj * (n1 + 1) + fi : fj * n1 + fi) ||
              ring[slot(kf)] != kf)
            ++bad_nf;
          if (q.dir == 2) f3[kf & 1] = kf;
          if (split_owns(q, b, kf))
            ++face[((q.dir * (size_t)nmb + m) * n3 + kf) * n2 * n1 +
                   (size_t)(b.j0 + q.r) * n1 + b.i0 + q.c];
        };
        for (int q = b.k0 - 2; q <= b.k0 + 2; ++q) load(q);
        for (int it = H.n1 + H.n2; it < H.nit; ++it) item(it, b.k0 - 1);
        for (int k = b.k0; k < b.k1; ++k) {
          if (k + 3 <= b.k1 + 1) load(k + 3);
          for (int it = 0; it < H.nit; ++it) item(it, k);
          if (f3[k & 1] != k || f3[(k + 1) & 1] != k + 1) ++bad_f3;
          for (int c = 0; c < H.n3; ++c) {
            const int j = b.j0 + c / ti, i = b.i0 + c % ti;
            if (j < b.j1 && i < b.i1)
              ++acc[(((size_t)m * n3 + k) * n2 + j) * n1 + i];
          }
        }
      }
  long long acc_once = 0, face_once = 0;
  for (size_t e = 0; e < nc; ++e) acc_once += acc[e] == 1;
  for (size_t e = 0; e < 3 * nc; ++e) face_once += face[e] == 1;
  printf("written %lld %lld\n", acc_once, face_once);
  printf("reads %lld %lld %lld %lld %lld\n", bad_win, bad_ring, bad_cell,
         bad_nf, bad_f3);
}

int main(int argc, char** argv) {
  const int nmb = atoi(argv[2]), n3 = atoi(argv[3]), n2 = atoi(argv[4]),
            n1 = atoi(argv[5]);
  const long long slots = atoll(argv[6]);
  if (std::string(argv[1]) == "f32") run<float>(nmb, n3, n2, n1, slots);
  else run<double>(nmb, n3, n2, n1, slots);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the tile geometry for the host")
    d = tmp_path_factory.mktemp("split_tiles")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{CSRC}", "-o", str(exe),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=300)
    return {}, exe


def _run(harness, dtype, shape, slots):
    cache, exe = harness
    key = (dtype, shape, slots)
    if key not in cache:
        out = subprocess.run([str(exe), dtype, *map(str, shape), str(slots)],
                             check=True, capture_output=True, text=True,
                             timeout=300)
        cache[key] = {ln.split()[0]: [int(v) for v in ln.split()[1:]]
                      for ln in out.stdout.splitlines()}
    return cache[key]


CASES = [(dt, s, n) for dt in ("f32", "f64") for s in SHAPES for n in SLOTS]


def _id(c):
    return f"{c[0]}-{'x'.join(map(str, c[1]))}-{c[2]}"


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_every_entry_once(harness, case):
    dtype, shape, slots = case
    nmb, n3, n2, n1 = shape
    acc_once, face_once = _run(harness, dtype, shape, slots)["written"]
    assert acc_once == nmb * n3 * n2 * n1
    assert face_once == 3 * nmb * n3 * n2 * n1


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_stencil_reads_inside_the_window(harness, case):
    assert _run(harness, *case)["reads"] == [0, 0, 0, 0, 0]


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_shared_memory_fits(harness, dtype):
    smem, minb = _run(harness, dtype, SHAPES[0], SLOTS[0])["smem"]
    assert smem <= SMEM_BLOCK
    assert minb * (smem + SMEM_RESERVED) <= SMEM_SM
