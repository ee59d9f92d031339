"""The index maps of kernels F and B, built for the host with g++, and the
dtmin expression kernel F's last block mirrors.

Kernel F (``csrc/fused_aux.cu``) numbers the cells flatly and strides
one wave of CUDA blocks over them (``csrc/aux_cells.cuh``).  The harness
below runs its loop over blocks and threads for a given grid and checks,
at turb1 (one 132^3 block, with the wrap), turb8 (8 x 68^3, without it),
the card tests' shapes and for several grid sizes:

  * every cell, ghosts included, is converted by exactly one thread;
  * with the wrap, the cell reads the interior cell it wraps to along
    every axis (``wrap_src`` of the first design), without it its own;
  * the offsets of u's source row and of the three face arrays' rows
    address that cell's faces, and the floor counts and maxima take the
    interior cells and no other.

Kernel B (``csrc/periodic_fill.cu``) numbers the ghosts alone with kernel
G's enumeration (``csrc/pool_fill.cuh``: ``pool_call`` and
``pool_self_item``), every block its own neighbour.  The harness
lists every item's destination and source, and the test checks at 1 x 5
x 128^3, 2 x 5 x 20^3 and a ragged 1 x 3 x 9 x 14 x 23, for the cell
array, each face array alone and all three together, with aligned and
misaligned pointers, that every ghost element is written exactly once,
no interior element at all, each from the element ``fill_plain`` copies
(read off the plain fill of an ``arange``), and that the kernel's
grid-stride loop covers every item once.

Both harnesses skip where no g++ is installed.  The last test pins, on
the CPU, that torch's ``dx / vmax`` is bitwise ``(1 / vmax) * T(dx)`` in
float32 and float64: the expression of ``ops/stage.py::_dtmin`` that the
kernel's last block computes (the card tests hold the kernel to the
plain version bitwise).
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from athenak_tpu_torch.ops import fill  # noqa: E402
from athenak_tpu_torch.ops.stage import _dtmin  # noqa: E402

CSRC = Path(__file__).resolve().parent.parent / "athenak_tpu_torch" / "csrc"
NG = 2
KTHREADS = 256                # csrc/common.cuh kThreads

AUX_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "aux_cells.cuh"
using namespace athenak;
// argv: out nmb n3 n2 n1 ng wrap grid threads.  Runs fused_aux.cu's
// loop; writes, for every cell in (m, k, j, i) order, int32 arrays: the
// threads that converted it, the in-block offsets of its source cell and
// of the source's x1f, x2f and x3f faces, and whether it is counted.
int main(int argc, char** argv) {
  const int nmb = atoi(argv[2]), n3 = atoi(argv[3]), n2 = atoi(argv[4]);
  const int n1 = atoi(argv[5]), ng = atoi(argv[6]);
  const bool wrap = atoi(argv[7]) != 0;
  const int grid = atoi(argv[8]), threads = atoi(argv[9]);
  const AuxGeom g = aux_geom(nmb, n3, n2, n1, ng);
  const long long n = static_cast<long long>(nmb) * g.ncell;
  std::vector<int> out[6];
  for (auto& v : out) v.assign(n, -1);
  for (long long c = 0; c < n; ++c) out[0][c] = 0;
  for (int b = 0; b < grid; ++b)
    for (int x = 0; x < threads; ++x)
      for (int t = b * threads + x; t < g.cells; t += grid * threads) {
        const AuxCell c = aux_cell(g, t, wrap);
        const long long d = static_cast<long long>(c.m) * g.ncell + c.dst;
        out[0][d] += 1;
        out[1][d] = c.src;
        out[2][d] = c.f1;
        out[3][d] = c.f2;
        out[4][d] = c.f3;
        out[5][d] = c.inner;
      }
  FILE* f = fopen(argv[1], "wb");
  for (auto& v : out) fwrite(v.data(), 4, v.size(), f);
  fclose(f);
  return 0;
}
"""

FILL_HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include "pool_fill.cuh"
using namespace athenak;
// argv: out nmb ng elem_bytes narr, then per array nc n3 n2 n1 nint3
// nint2 nint1 misaligned.  Writes [q, dst, src, vec] (int64) for every
// item in order.
int main(int argc, char** argv) {
  int a = 2;
  const int nmb = atoi(argv[a++]), ng = atoi(argv[a++]);
  const int elem = atoi(argv[a++]), narr = atoi(argv[a++]);
  int dims[8 * kPoolMaxArrays] = {};
  PoolPtrs ptrs{};
  for (int q = 0; q < narr; ++q) {
    for (int x = 0; x < 7; ++x) dims[8 * q + x] = atoi(argv[a++]);
    ptrs.ptr[q] = reinterpret_cast<void*>(
        4096ULL * (q + 1) + (atoi(argv[a++]) ? elem : 0));
  }
  const PoolCall p = pool_call(narr, dims, nmb, ng, ng, ng, ptrs, elem);
  FILE* f = fopen(argv[1], "wb");
  for (long long t = 0; t < p.total; ++t) {
    long long rec[4] = {0, 0, 0, 0};
    rec[0] = pool_self_item(p, static_cast<int>(t), rec[1], rec[2]);
    rec[3] = p.arr[rec[0]].vec;
    fwrite(rec, 8, 4, f);
  }
  fclose(f);
  return 0;
}
"""


def _build(tmp_path_factory, name, source):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel headers for the host")
    d = tmp_path_factory.mktemp(name)
    (d / "h.cpp").write_text(source)
    exe = d / "h"
    subprocess.run([gxx, "-std=c++17", "-O2", "-D__host__=", "-D__device__=",
                    "-I", str(CSRC), "-o", str(exe), str(d / "h.cpp")],
                   check=True)
    return exe, d


@pytest.fixture(scope="module")
def aux_harness(tmp_path_factory):
    return _build(tmp_path_factory, "aux_cells", AUX_HARNESS)


@pytest.fixture(scope="module")
def fill_harness(tmp_path_factory):
    return _build(tmp_path_factory, "periodic_fill", FILL_HARNESS)


# ---------------------------------------------------------------------------
# Kernel F

def _wrap_src(p, n):
    """The first design's ``wrap_src``: the interior index p wraps to."""
    nint = n - 2 * NG
    return np.where(p < NG, p + nint, np.where(p >= n - NG, p - nint, p))


# (nmb, n3, n2, n1, wrap) with ghosts: turb1, turb8, the card tests'
# 16^3 block and 2 x 16^3 pool, the ragged 3 x 17 x 23 x 29 and a 20^3
AUX_SHAPES = [(1, 132, 132, 132, True), (8, 68, 68, 68, False),
              (1, 16, 16, 16, True), (2, 16, 16, 16, False),
              (3, 17, 23, 29, True), (3, 17, 23, 29, False),
              (1, 20, 20, 20, True)]


@pytest.mark.parametrize("nmb,n3,n2,n1,wrap", AUX_SHAPES)
def test_aux_cells_convert_every_cell_once(aux_harness, nmb, n3, n2, n1,
                                           wrap):
    exe, d = aux_harness
    need = -(-nmb * n3 * n2 * n1 // KTHREADS)
    grids = sorted({min(need, 132 * r) for r in (1, 4)} | {1, 7})
    k, j, i = np.meshgrid(np.arange(n3), np.arange(n2), np.arange(n1),
                          indexing="ij")
    sk, sj, si = (_wrap_src(p, n) for p, n in ((k, n3), (j, n2), (i, n1))) \
        if wrap else (k, j, i)
    inner = ((k >= NG) & (k < n3 - NG) & (j >= NG) & (j < n2 - NG)
             & (i >= NG) & (i < n1 - NG))
    if wrap:
        assert inner[sk, sj, si].all()      # every source is interior
    want = {1: (sk * n2 + sj) * n1 + si,
            2: (sk * n2 + sj) * (n1 + 1) + si,
            3: (sk * (n2 + 1) + sj) * n1 + si,
            4: (sk * n2 + sj) * n1 + si,
            5: inner.astype(np.int32)}
    ncell = n3 * n2 * n1
    for grid in grids:
        out = d / "cells.bin"
        subprocess.run([str(exe), str(out), str(nmb), str(n3), str(n2),
                        str(n1), str(NG), str(int(wrap)), str(grid),
                        str(KTHREADS)], check=True)
        got = np.fromfile(out, dtype=np.int32).reshape(6, nmb, n3, n2, n1)
        assert (got[0] == 1).all(), f"grid {grid}: cells not converted once"
        for field, w in want.items():
            np.testing.assert_array_equal(
                got[field], np.broadcast_to(w, got[field].shape),
                err_msg=f"grid {grid}, field {field}")
        # the rows j + 1 of x2f and k + 1 of x3f the kernel reads next
        assert int(got[3].max()) + n1 < n3 * (n2 + 1) * n1
        assert int(got[4].max()) + n2 * n1 < (n3 + 1) * n2 * n1
        assert 5 * ncell < 2 ** 31


# ---------------------------------------------------------------------------
# Kernel B

_NORMAL = {"x1f": 3, "x2f": 2, "x3f": 1}      # axis in [nmb, n3, n2, n1]


def _face_shape(nmb, n3, n2, n1, comp):
    shape = [nmb, n3, n2, n1]
    shape[_NORMAL[comp]] += 1
    return tuple(shape)


def _ghost_mask(shape):
    n3, n2, n1 = shape[-3:]
    k, j, i = np.meshgrid(np.arange(n3), np.arange(n2), np.arange(n1),
                          indexing="ij")
    inner = ((k >= NG) & (k < n3 - NG) & (j >= NG) & (j < n2 - NG)
             & (i >= NG) & (i < n1 - NG))
    return np.broadcast_to(~inner, shape).ravel()


class _NoEntry:
    """Stands in for the kernel in ``fill._call``: the CPU has no build."""

    def entry(self, dtype):
        return None


# (nmb, C, n3, n2, n1) with ghosts: the blast deck's u, the card tests'
# two blocks of 20^3 and a ragged block
FILL_SHAPES = [(1, 5, 128, 128, 128), (2, 5, 20, 20, 20), (1, 3, 9, 14, 23)]
FILL_CALLS = [(None,), ("x1f", "x2f", "x3f"), ("x1f",), ("x2f",), ("x3f",)]


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
@pytest.mark.parametrize("comps", FILL_CALLS,
                         ids=["cc", "fc", "x1f", "x2f", "x3f"])
@pytest.mark.parametrize("nmb,nc,n3,n2,n1", FILL_SHAPES)
def test_periodic_fill_numbers_every_ghost_once(fill_harness, nmb, nc, n3,
                                                n2, n1, comps, misaligned):
    exe, d = fill_harness
    shapes = [(nmb, nc, n3, n2, n1) if c is None else
              _face_shape(nmb, n3, n2, n1, c) for c in comps]
    _, dims, _, nmb_call = fill._call(_NoEntry(), tuple(shapes), comps,
                                      torch.float32)
    assert nmb_call == nmb
    args = [str(nmb), str(NG), "4", str(len(comps))]
    for q in range(len(comps)):
        args += [str(v) for v in dims[8 * q:8 * q + 7]]
        args.append(str(int(misaligned)))
    out = d / "items.bin"
    subprocess.run([str(exe), str(out), *args], check=True)
    rec = np.fromfile(out, dtype=np.int64).reshape(-1, 4)
    total = len(rec)
    # the kernel's grid-stride loop (item t = block * 256 + thread, then
    # + grid * 256), with a wave smaller than the items, covers every
    # item once
    grid = min(-(-total // KTHREADS), 264)
    seen = np.concatenate([np.arange(b * KTHREADS + x, total,
                                     grid * KTHREADS)
                           for b in range(grid) for x in range(KTHREADS)])
    np.testing.assert_array_equal(np.sort(seen), np.arange(total))
    for q, (comp, shape) in enumerate(zip(comps, shapes)):
        mine = rec[rec[:, 0] == q]
        vec = int(mine[0, 3])
        even = shape[-1] % 2 == 0 and (shape[-1] - 2 * NG
                                       - (comp == "x1f")) % 2 == 0
        assert vec == (2 if even and not misaligned else 1), (comp, vec)
        dst = (mine[:, 1:2] + np.arange(vec)).ravel()
        src = (mine[:, 2:3] + np.arange(vec)).ravel()
        ghost = _ghost_mask(shape)
        # every ghost once, no interior element
        np.testing.assert_array_equal(np.sort(dst), np.flatnonzero(ghost),
                                      err_msg=str(comp))
        assert not ghost[src].any(), comp      # sources are interior
        idx = torch.arange(int(np.prod(shape)), dtype=torch.int64)
        filled = fill.fill_plain(idx.reshape(shape),
                                 fill.shifts(shape, comp)).ravel().numpy()
        np.testing.assert_array_equal(src, filled[dst], err_msg=str(comp))


# ---------------------------------------------------------------------------
# dtmin

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_dtmin_is_reciprocal_times_rounded_dx(dtype):
    """``dx / vmax`` (a Python float over a tensor) is ``vmax.reciprocal()
    * T(dx)`` bitwise, so kernel F's last block computes ``(T(1) / vmax)
    * T(dx)`` and takes the min over x1, x2, x3 in that order."""
    npt = np.float32 if dtype == torch.float32 else np.float64
    rng = np.random.default_rng(9)
    vmax = (10.0 ** rng.uniform(-3, 3, 20000)).astype(npt)
    t = torch.from_numpy(vmax)
    for dx in (1 / 128, 1 / 64, 0.9 / 124, 1.1 / 124, 1 / 3, 0.1):
        got = (dx / t).numpy()
        want = (npt(1) / vmax) * npt(dx)
        assert got.tobytes() == want.tobytes(), dx
    dxs = {"x1": 1 / 128, "x2": 0.9 / 128, "x3": 1.1 / 128}
    for row in vmax[:3000].reshape(-1, 3):
        got = _dtmin(dxs, torch.from_numpy(row))
        want = min((npt(1) / v) * npt(dxs[c])
                   for v, c in zip(row, ("x1", "x2", "x3")))
        assert got.dtype == dtype
        assert got.numpy().tobytes() == npt(want).tobytes()
