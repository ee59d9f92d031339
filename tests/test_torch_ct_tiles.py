"""Kernel D's tile geometry (``csrc/ct_tile.cuh``) and kernel I's numbering
of the ghosts (``csrc/outflow_fill.cuh``), built for the host with g++.

Kernel D (``csrc/fused_ct.cu``) cuts the faces of a pool into tiles of
tj x ti columns and segments of planes (kernel J's cut, ``ct_geom``),
marches each tile through the planes k0-1 .. k1, stages a wrapped window
of its 15 input channels a plane ahead in a ring of three, forms the cell
EMFs of the window and the edges of the plane in rings of two, and
writes the faces of the plane below (``ct_face``, ``ct_owns``,
``ct_face_edges``).
This file replays that march for every CUDA block, at the SR blast's
128^3 block with ghosts, at pools and at ragged shapes, for several
numbers of resident blocks, float and double tiles:

  * every face of the three face arrays, the extra face of each normal
    axis included, is written by exactly one CUDA block, and every edge
    of the pool is formed by at least one;
  * every read of an edge (the window, its cell EMFs, mass fluxes and
    face EMFs, in planes p and p-1) lies inside the staged window, in a
    plane the ring holds at that step, and finds the cell the first
    design read, wrapped reads included; every face reads b and b_old
    staged for its plane at its own offset, and the four edges the first
    design's face kernel differenced, in a plane the edge ring holds;
  * a block's shared memory fits the blocks an SM the design counts on.

Kernel I (``csrc/z4c_stage.cu``) numbers the ghosts of one block with six
outflow faces: the items visit every ghost element once and no interior
one, each element's donor is the clamped cell a numpy mirror gives, and
every vector item is aligned, at nghost 2-5 and every item width.

The tests skip where no g++ is installed.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

CSRC = Path(__file__).resolve().parent.parent / "athenak_tpu_torch" / "csrc"
SMEM_SM = 233472             # bytes of shared memory an SM holds
SMEM_RESERVED = 1024         # bytes the runtime keeps for each block
SMEM_BLOCK = 232448          # the most one block may take

# (nmb, n3, n2, n1): the SR blast's block with ghosts, pools, ragged and
# small shapes (tests/test_torch_cuda.py's among them)
SHAPES = [(1, 128, 128, 128), (2, 36, 36, 36), (2, 14, 21, 37),
          (3, 9, 13, 37), (2, 12, 10, 14), (1, 6, 6, 6), (2, 15, 21, 17)]
SLOTS = [264, 132, 7]        # resident blocks: 2 an SM, 1 an SM, a few

# (nch, n3, n2, n1, ng) with ghosts: the z4c and puncture decks' blocks
# (two channels of 22), a ragged block at nghost 4 and 5, and small ones
OUTFLOW = [(2, 64, 64, 64, 2), (2, 70, 70, 70, 3), (3, 44, 42, 48, 4),
           (2, 52, 48, 56, 5), (1, 9, 11, 13, 2), (2, 11, 12, 13, 5)]

HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#define __host__
#define __device__
#include "ct_tile.cuh"
#include "outflow_fill.cuh"
using namespace athenak;

static int wrap(int p, int n) { return ((p % n) + n) % n; }

template <class T>
void run_ct(int nmb, int n3, int n2, int n1, long long slots) {
  using S = CtTile<T>;
  const int tj = S::TJ, ti = S::TI;
  const CtShape H = ct_shape(tj, ti);
  printf("smem %zu %d %d %d %d\n", (size_t)ct_smem(tj, ti) * sizeof(T),
         S::MINB, S::NT, H.wc, std::max(H.nf1, std::max(H.nf2, H.nf3)));
  const FluxGeom g = ct_geom(nmb, n3, n2, n1, tj, ti, slots);
  const size_t nc = (size_t)nmb * n3 * n2 * n1;
  const size_t nfa[3] = {(size_t)nmb * n3 * n2 * (n1 + 1),
                         (size_t)nmb * n3 * (n2 + 1) * n1,
                         (size_t)nmb * (n3 + 1) * n2 * n1};
  const int nfq[3] = {H.nf1, H.nf2, H.nf3};
  std::vector<int> fw[3] = {std::vector<int>(nfa[0], 0),
                            std::vector<int>(nfa[1], 0),
                            std::vector<int>(nfa[2], 0)};
  std::vector<int> edges(nc, 0);
  long long bad_win = 0, bad_ring = 0, bad_cell = 0, bad_edge = 0,
            bad_face = 0;
  // the in-plane offset of cell (j, i), wrapped
  auto cell = [&](int j, int i) { return wrap(j, n2) * n1 + wrap(i, n1); };
  for (int m = 0; m < nmb; ++m)
    for (int s = 0; s < g.nseg; ++s)
      for (int t = 0; t < g.ntj * g.nti; ++t) {
        const FluxBox b = flux_box(g, t, s, m);
        auto rslot = [&](int p) { return (p - b.k0 + 1) % kCtRing; };
        // the plane each ring slot holds (-1000: none, or a copy in
        // flight), and the copies of each committed group
        int raw[kCtRing], fst[2], ecc[2], edg[2];
        for (int q = 0; q < kCtRing; ++q) raw[q] = -1000;
        fst[0] = fst[1] = ecc[0] = ecc[1] = edg[0] = edg[1] = -1000;
        struct Copy { int* ring; int slot, plane; };
        std::vector<std::vector<Copy>> groups;
        std::vector<Copy> open;
        auto issue = [&](int* ring, int slot, int plane) {
          ring[slot] = -1000;
          open.push_back(Copy{ring, slot, plane});
        };
        auto commit = [&]() { groups.push_back(open); open.clear(); };
        auto wait = [&](size_t newest) {  // cp.async.wait_group
          while (groups.size() > newest) {
            for (const Copy& c : groups.front()) c.ring[c.slot] = c.plane;
            groups.erase(groups.begin());
          }
        };
        // a read of window cell h of plane p from a ring slot: inside the
        // window, in the ring, staged from cell (j, i)
        auto rd = [&](const int* ring, int slot, int p, int h, int j, int i) {
          if (h < 0 || h >= H.wc) {
            ++bad_win;
            return;
          }
          if (ring[slot] != p) ++bad_ring;
          if (ct_win(h, H.wi, b.j0, b.i0, n2, n1) != cell(j, i)) ++bad_cell;
        };
        // face f of plane k: written once, b and b_old staged for plane k
        // (not the extra x3 face, read directly), the first design's
        // edges in a plane the edge ring holds
        auto face = [&](const CtFace& f, int k) {
          const int j = b.j0 + f.r, i = b.i0 + f.c;
          const size_t pl = f.arr == 0 ? (size_t)n2 * (n1 + 1)
                            : f.arr == 1 ? (size_t)(n2 + 1) * n1
                                         : (size_t)n2 * n1;
          const size_t np = f.arr == 2 ? n3 + 1 : n3;
          const int off = f.arr == 0 ? j * (n1 + 1) + i : j * n1 + i;
          if (ct_face_off(f, b.j0, b.i0, n1) != off) ++bad_face;
          if (k < n3 && fst[k & 1] != k) ++bad_face;
          ++fw[f.arr][(m * np + k) * pl + off];
          const int ie = i == n1 ? 0 : i, je = j == n2 ? 0 : j,
                    ke = k == n3 ? 0 : k;
          int want[4][4];
          if (f.arr == 0) {
            int w0[4][4] = {{2, k, j + 1, ie}, {2, k, j, ie},
                            {1, k + 1, j, ie}, {1, k, j, ie}};
            std::copy(&w0[0][0], &w0[0][0] + 16, &want[0][0]);
          } else if (f.arr == 1) {
            int w1[4][4] = {{2, k, je, i + 1}, {2, k, je, i},
                            {0, k + 1, je, i}, {0, k, je, i}};
            std::copy(&w1[0][0], &w1[0][0] + 16, &want[0][0]);
          } else {
            int w2[4][4] = {{1, ke, j, i + 1}, {1, ke, j, i},
                            {0, ke, j + 1, i}, {0, ke, j, i}};
            std::copy(&w2[0][0], &w2[0][0] + 16, &want[0][0]);
          }
          CtEdge es[4];
          ct_face_edges(f, H.ei, es);
          for (int q = 0; q < 4; ++q) {
            const int pe = k + es[q].dk;
            if (es[q].idx < 0 || es[q].idx >= H.ec || edg[pe & 1] != pe) {
              ++bad_edge;
              continue;
            }
            const int ej = b.j0 + es[q].idx / H.ei,
                      ei = b.i0 + es[q].idx % H.ei;
            if (es[q].comp != want[q][0] ||
                wrap(pe, n3) != wrap(want[q][1], n3) ||
                cell(ej, ei) != cell(want[q][2], want[q][3]))
              ++bad_edge;
          }
        };
        issue(raw, rslot(b.k0 - 1), b.k0 - 1);
        commit();
        for (int p = b.k0 - 1; p <= b.k1; ++p) {
          wait(0);
          if (p + 1 <= b.k1) issue(raw, rslot(p + 1), p + 1);
          if (p >= b.k0 && p < b.k1) issue(fst, p & 1, p);
          commit();
          for (int h = 0; h < H.wc; ++h)  // the cell EMFs
            rd(raw, rslot(p), p, h, b.j0 - 1 + h / H.wi,
               b.i0 - 1 + h % H.wi);
          ecc[p & 1] = p;
          if (p >= b.k0) {
            for (int h = 0; h < H.wc; ++h) {
              const int wr = h / H.wi, wc = h % H.wi;
              if (wr < 1 || wc < 1) continue;
              const int j = b.j0 + wr - 1, i = b.i0 + wc - 1;
              // the window and cell EMFs of plane p (the cell, one row
              // and one column below, both), of plane p-1 (the cell; the
              // cell EMFs one row or column below)
              for (const int* ring : {raw, ecc}) {
                const int sl = ring == raw ? rslot(p) : p & 1;
                rd(ring, sl, p, h, j, i);
                rd(ring, sl, p, h - H.wi, j - 1, i);
                rd(ring, sl, p, h - 1, j, i - 1);
                rd(ring, sl, p, h - H.wi - 1, j - 1, i - 1);
              }
              rd(raw, rslot(p - 1), p - 1, h, j, i);
              rd(ecc, (p - 1) & 1, p - 1, h, j, i);
              rd(ecc, (p - 1) & 1, p - 1, h - H.wi, j - 1, i);
              rd(ecc, (p - 1) & 1, p - 1, h - 1, j, i - 1);
              ++edges[((size_t)m * n3 + wrap(p, n3)) * n2 * n1 + cell(j, i)];
            }
            edg[p & 1] = p;
          }
          if (p > b.k0)
            for (int q = 0; q < 3; ++q)
              for (int e = 0; e < nfq[q]; ++e) {
                const CtFace f = ct_face(q, e, ti);
                if (!ct_owns(f, b, n2, n1)) continue;
                face(f, p - 1);
                if (q == 2 && p == n3) face(f, n3);
              }
        }
      }
  long long once[3] = {0, 0, 0}, formed = 0;
  for (int q = 0; q < 3; ++q)
    for (size_t e = 0; e < nfa[q]; ++e) once[q] += fw[q][e] == 1;
  for (size_t e = 0; e < nc; ++e) formed += edges[e] > 0;
  printf("written %lld %lld %lld\n", once[0], once[1], once[2]);
  printf("edges %lld\n", formed);
  printf("reads %lld %lld %lld %lld %lld\n", bad_win, bad_ring, bad_cell,
         bad_edge, bad_face);
}

// Every item of kernel I's numbering: each element it writes, with its
// donor, as int32 pairs into a file; the items whose access is not
// aligned to its width counted on stdout.
void run_outflow(int nch, int n3, int n2, int n1, int ng, int vec,
                 const char* path) {
  const OutflowCall p = outflow_call(nch, n3, n2, n1, ng, vec);
  FILE* f = fopen(path, "wb");
  long long misaligned = 0, elems = 0;
  const int lo = ng, hi = n1 - ng - 1;
  for (int t = 0; t < p.total; ++t) {
    const OutflowItem it = outflow_item(p, t);
    if (!it.side && (it.dst % vec || (it.row + it.i) % vec)) ++misaligned;
    const int n = it.side ? ng : vec;
    for (int e = 0; e < n; ++e) {
      const int src = it.side ? it.row + (it.side == 1 ? lo : hi)
                              : it.row + outflow_clamp(it.i + e, lo, hi);
      const int pair[2] = {it.dst + e, src};
      fwrite(pair, sizeof(int), 2, f);
      ++elems;
    }
  }
  fclose(f);
  printf("items %lld %lld %lld\n", (long long)p.total, elems, misaligned);
}

int main(int argc, char** argv) {
  if (argv[1][0] == 'o') {
    run_outflow(atoi(argv[2]), atoi(argv[3]), atoi(argv[4]), atoi(argv[5]),
                atoi(argv[6]), atoi(argv[7]), argv[8]);
    return 0;
  }
  if (argv[1][0] == 'v') {  // outflow_vec of n1, an address, element bytes
    printf("vec %d\n", outflow_vec(atoi(argv[2]), atoll(argv[3]),
                                   atoi(argv[4])));
    return 0;
  }
  const int nmb = atoi(argv[2]), n3 = atoi(argv[3]), n2 = atoi(argv[4]),
            n1 = atoi(argv[5]);
  const long long slots = atoll(argv[6]);
  if (std::string(argv[1]) == "f32") run_ct<float>(nmb, n3, n2, n1, slots);
  else run_ct<double>(nmb, n3, n2, n1, slots);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the tile geometry for the host")
    d = tmp_path_factory.mktemp("ct_tiles")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{CSRC}", "-o", str(exe),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=300)
    return {}, exe, d


def _run(harness, *args):
    cache, exe, _ = harness
    key = tuple(map(str, args))
    if key not in cache:
        out = subprocess.run([str(exe), *key], check=True,
                             capture_output=True, text=True, timeout=300)
        cache[key] = {ln.split()[0]: [int(v) for v in ln.split()[1:]]
                      for ln in out.stdout.splitlines()}
    return cache[key]


CASES = [(dt, s, n) for dt in ("f32", "f64") for s in SHAPES for n in SLOTS]


def _id(c):
    return f"{c[0]}-{'x'.join(map(str, c[1]))}-{c[2]}"


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_ct_every_face_once(harness, case):
    dtype, (nmb, n3, n2, n1), slots = case
    got = _run(harness, dtype, nmb, n3, n2, n1, slots)
    assert got["written"] == [nmb * n3 * n2 * (n1 + 1),
                              nmb * n3 * (n2 + 1) * n1,
                              nmb * (n3 + 1) * n2 * n1]
    assert got["edges"] == [nmb * n3 * n2 * n1]


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_ct_reads_inside_the_window(harness, case):
    dtype, shape, slots = case
    assert _run(harness, dtype, *shape, slots)["reads"] == [0] * 5


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_ct_shared_memory_fits(harness, dtype):
    smem, minb, nt, wc, nf = _run(harness, dtype, *SHAPES[0],
                                  SLOTS[0])["smem"]
    assert smem <= SMEM_BLOCK
    assert minb * (smem + SMEM_RESERVED) <= SMEM_SM
    assert max(wc, nf) <= nt and nt % 32 == 0


def _outflow_donors(nch, n3, n2, n1, ng):
    """numpy mirror of the outflow sweeps: for every element, the flat
    index of the element it ends with (itself for interior cells)."""
    idx = np.arange(nch * n3 * n2 * n1).reshape(nch, n3, n2, n1)
    k = np.clip(np.arange(n3), ng, n3 - ng - 1)
    j = np.clip(np.arange(n2), ng, n2 - ng - 1)
    i = np.clip(np.arange(n1), ng, n1 - ng - 1)
    return idx[:, k][:, :, j][:, :, :, i].ravel()


OUT_CASES = [(s, v) for s in OUTFLOW for v in (1, 2, 4) if s[3] % v == 0]


@pytest.mark.parametrize("case", OUT_CASES,
                         ids=[f"{'x'.join(map(str, s))}-vec{v}"
                              for s, v in OUT_CASES])
def test_outflow_numbering_every_ghost_once(harness, case):
    shape, vec = case
    nch, n3, n2, n1, ng = shape
    path = harness[2] / f"outflow_{'_'.join(map(str, shape))}_{vec}.bin"
    items, elems, misaligned = _run(harness, "o", *shape, vec, path)["items"]
    pairs = np.fromfile(path, dtype=np.int32).reshape(-1, 2)
    donor = _outflow_donors(*shape)
    ghost = donor != np.arange(donor.size)
    assert elems == pairs.shape[0] == int(ghost.sum())
    assert misaligned == 0
    dst, src = pairs[:, 0], pairs[:, 1]
    seen = np.bincount(dst, minlength=donor.size)
    assert np.array_equal(seen, ghost.astype(np.int64))   # ghosts once
    assert np.array_equal(src, donor[dst])
    assert not ghost[src].any()                           # donors interior
    # fewer items than ghost elements wherever rows take vectors or
    # sides take ng elements
    assert items < elems or (vec == 1 and ng == 1)


@pytest.mark.parametrize("n1,addr,nbytes,want", [
    (64, 4096, 4, 4), (70, 4096, 4, 2), (63, 4096, 4, 1), (64, 4104, 4, 2),
    (64, 4100, 4, 1), (64, 4096, 8, 2), (70, 4096, 8, 2), (69, 4096, 8, 1),
    (64, 4104, 8, 1)])
def test_outflow_item_width(harness, n1, addr, nbytes, want):
    assert _run(harness, "v", n1, addr, nbytes)["vec"] == [want]
