"""The tile geometry of kernel H (``csrc/z4c_tile.cuh``) and the stencil
reads of its derivative pass (``csrc/z4c_rhs.cuh``), built for the host
with g++.

Kernel H cuts the interior cells of a pool into boxes, one CUDA block a
box and one thread a cell, stages each channel's window (the box and
nghost cells around it) in shared memory, computes the inner first
derivatives of the mixed pairs once a point (``z4c_inner``) and each
cell's derivatives from the window (``z4c_derivs``).  This file compiles
those functions with g++ and runs them, for every box, with checking
pointers in place of the window and the two inner-derivative arrays,
at 60^3 nghost 2 (``Z4C_DECK``), 64^3 nghost 3 (the puncture deck), 2 x
32^3 nghost 4 (``chip_smoke.py``'s pool), a 46 x 38 x 42 nghost 5 block
and ragged shapes, float and double boxes:

  * every interior cell is written by exactly one CUDA block, and no
    ghost cell;
  * every stencil read (first, second, mixed, advective both ways,
    Kreiss-Oliger, the 2nd-order Sommerfeld first derivative) lies inside
    the staged window, and for a cell that is written it reads the
    array cell at the stencil's offset, with no clamping; every read of
    an inner derivative finds one that the inner pass wrote for the same
    channel, whose own stencil is unclamped for a written cell;
  * a block's shared memory fits the blocks an SM the design counts on.

The test skips where no g++ is installed.
"""

import shutil
import subprocess

import pytest

from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "athenak_tpu_torch" / "csrc"
SMEM_SM = 233472             # bytes of shared memory an SM holds
SMEM_RESERVED = 1024         # bytes the runtime keeps for each block
SMEM_BLOCK = 232448          # the most one block may take

# (nmb, n3, n2, n1, nghost): the decks' shapes with ghosts, then ragged
# ones (tests/test_torch_cuda.py's ragged interior among them); last,
# inputs/z4c/one_puncture_amr's flat tree (64 blocks of 8^3, nghost 4)
SHAPES = [(1, 64, 64, 64, 2), (1, 70, 70, 70, 3), (2, 40, 40, 40, 4),
          (1, 52, 48, 56, 5), (1, 15, 10, 13, 2), (2, 15, 13, 19, 3),
          (2, 19, 17, 21, 4), (1, 21, 19, 17, 5), (64, 16, 16, 16, 4)]

SHIM = r"""
#pragma once
#include <cmath>
using std::cbrt;
using std::pow;
using std::sqrt;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(x)
typedef void* cudaStream_t;
template <class T> inline T __ldg(const T* p) { return *p; }
"""

HARNESS = r"""
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <vector>
#include "z4c_rhs.cuh"
using namespace athenak;

struct Counts {
  long long bad_win = 0, clamped = 0, bad_d1 = 0, unwritten = 0;
};
static Counts K;
static const Z4cGeom* G;
static const Z4cBox* B;
static bool inside;  // the cell being differenced is written
static int stamp;    // the channel pass the inner arrays belong to

// (z, y, x) of flat index p of a [nz][ny][nx] array, and of a small
// displacement off (each component below half the extent)
static void decode(int p, int ny, int nx, int& z, int& y, int& x) {
  z = p / (ny * nx);
  y = p / nx % ny;
  x = p % nx;
}
static void decode_off(int off, int ny, int nx, int& dz, int& dy, int& dx) {
  dz = (int)std::lround((double)off / (ny * nx));
  const int rem = off - dz * ny * nx;
  dy = (int)std::lround((double)rem / nx);
  dx = rem - dy * nx;
}

// is array cell (box origin - NG + window coordinates) inside the array
template <class Sh>
static bool unclamped(int z, int y, int x) {
  const int k = B->k0 - Sh::NG + z, j = B->j0 - Sh::NG + y,
            i = B->i0 - Sh::NG + x;
  return k >= 0 && k < G->n3 && j >= 0 && j < G->n2 && i >= 0 && i < G->n1;
}

// a window read: the centre set by +, the displacement by []
template <class Sh>
struct Win {
  const double* base;
  int pos;
  Win operator+(int o) const { return Win{base, pos + o}; }
  double operator[](int off) const {
    int z, y, x, dz, dy, dx;
    decode(pos, Sh::WY, Sh::WX, z, y, x);
    decode_off(off, Sh::WY, Sh::WX, dz, dy, dx);
    z += dz;
    y += dy;
    x += dx;
    if (z < 0 || z >= Sh::WZ || y < 0 || y >= Sh::WY || x < 0 ||
        x >= Sh::WX) {
      ++K.bad_win;
      return 0.0;
    }
    if (inside && !unclamped<Sh>(z, y, x)) ++K.clamped;
    return base[pos + off];
  }
};

// d1x (d = 0, [DZ][DY][TX]) or d1y (d = 1, [DZ][TY][TX]): written by the
// inner pass, read by the cells
template <class Sh>
struct D1 {
  double* base;
  int* mark;
  int pos, d;
  bool writer;
  D1 operator+(int o) const { return D1{base, mark, pos + o, d, writer}; }
  double& operator[](int off) const {
    const int ny = d == 0 ? Sh::DY : Sh::TY;
    int z, y, x, dz = 0, dy = 0, dx = 0;
    // the inner pass writes at an index, the cells read at a displacement
    decode(writer ? pos + off : pos, ny, Sh::TX, z, y, x);
    if (!writer) decode_off(off, ny, Sh::TX, dz, dy, dx);
    z += dz;
    y += dy;
    x += dx;
    static double dummy;
    if (z < 0 || z >= Sh::DZ || y < 0 || y >= ny || x < 0 || x >= Sh::TX) {
      ++K.bad_d1;
      return dummy;
    }
    const int p = pos + off;
    if (writer) {
      mark[p] = stamp;
    } else {
      if (mark[p] != stamp) ++K.unwritten;
      // the inner derivative's own stencil, along x or y, NG-1 each way
      const int wz = z + 1, wy = d == 0 ? y + 1 : y + Sh::NG,
                wx = x + Sh::NG;
      if (inside)
        for (int q = -(Sh::NG - 1); q <= Sh::NG - 1; ++q)
          if (!(d == 0 ? unclamped<Sh>(wz, wy, wx + q)
                       : unclamped<Sh>(wz, wy + q, wx)))
            ++K.clamped;
    }
    return base[p];
  }
};

template <class T, int NG>
void run(int nmb, int n3, int n2, int n1) {
  using Sh = Z4cTile<T, NG>;
  const Z4cGeom g = z4c_geom(nmb, n3, n2, n1, NG, Sh::TX, Sh::TY, Sh::TZ);
  G = &g;
  printf("smem %zu %d\n", (size_t)Sh::SMEM * sizeof(T), Sh::MINB);
  std::vector<int> written((size_t)nmb * n3 * n2 * n1, 0);
  std::vector<double> win(Sh::WIN, 0.0), d1x(Sh::NXD), d1y(Sh::NYD),
      buf((size_t)kZ4cSlots * Sh::NC);
  std::vector<int> mx(Sh::NXD, -1), my(Sh::NYD, -1);
  double prm[P_COUNT] = {0};
  prm[P_DISS] = 0.5;  // Kreiss-Oliger on
  for (int d = 0; d < 3; ++d) prm[P_IDX1 + d] = prm[P_IDX1SQ + d] = 1.0;
  const Z4cPrm<double> P = make_z4c_prm<double>(prm);
  const Z4cSomm<double> sb{true, 1.0, {1.0, 1.0, 1.0}};
  const double gu[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  // one channel of each kind: mixed (g_xx, beta^x; each also sums its
  // second derivatives), first derivatives with a Sommerfeld row (Khat),
  // a Sommerfeld row only (A_xx)
  const int chans[4] = {1, 7, 8, 19};
  for (long long blk = 0; blk < g.blocks; ++blk) {
    const Z4cBox b = z4c_box(g, blk);
    B = &b;
    for (int c : chans) {
      ++stamp;
      inside = false;
      if (z4c_mixed(c))
        for (int p = 0; p < Sh::NP; ++p)
          z4c_inner<double, Sh>(p, Win<Sh>{win.data(), 0},
                                D1<Sh>{d1x.data(), mx.data(), 0, 0, true},
                                D1<Sh>{d1y.data(), my.data(), 0, 1, true}, P);
      for (int t = 0; t < Sh::NC; ++t) {
        const Z4cCellPos q = z4c_cell_pos<Sh>(t);
        inside = b.k0 + q.z < b.k1 && b.j0 + q.y < b.j1 && b.i0 + q.x < b.i1;
        for (double s : {-1.0, 1.0}) {  // both advective stencils
          const double beta[3] = {s, s, s};
          z4c_derivs<double, Sh>(c, Win<Sh>{win.data(), q.win},
                                 D1<Sh>{d1x.data(), mx.data(), q.dx, 0, false},
                                 D1<Sh>{d1y.data(), my.data(), q.dy, 1, false},
                                 P, beta, gu, sb, buf.data() + t);
        }
        if (inside && c == chans[0])
          ++written[(((size_t)b.m * n3 + b.k0 + q.z) * n2 + b.j0 + q.y) * n1 +
                    b.i0 + q.x];
      }
    }
  }
  long long once = 0, other = 0, ghost = 0;
  for (int m = 0; m < nmb; ++m)
    for (int k = 0; k < n3; ++k)
      for (int j = 0; j < n2; ++j)
        for (int i = 0; i < n1; ++i) {
          const int w = written[(((size_t)m * n3 + k) * n2 + j) * n1 + i];
          const bool in = k >= NG && k < n3 - NG && j >= NG && j < n2 - NG &&
                          i >= NG && i < n1 - NG;
          if (!in) ghost += w;
          else if (w == 1) ++once;
          else ++other;
        }
  printf("cells %lld %lld %lld\n", once, other, ghost);
  printf("reads %lld %lld %lld %lld\n", K.bad_win, K.clamped, K.bad_d1,
         K.unwritten);
}

template <class T>
void dispatch(int ng, int nmb, int n3, int n2, int n1) {
  switch (ng) {
    case 2: run<T, 2>(nmb, n3, n2, n1); break;
    case 3: run<T, 3>(nmb, n3, n2, n1); break;
    case 4: run<T, 4>(nmb, n3, n2, n1); break;
    case 5: run<T, 5>(nmb, n3, n2, n1); break;
  }
}

int main(int argc, char** argv) {
  const int ng = atoi(argv[2]), nmb = atoi(argv[3]), n3 = atoi(argv[4]),
            n2 = atoi(argv[5]), n1 = atoi(argv[6]);
  if (std::string(argv[1]) == "f32") dispatch<float>(ng, nmb, n3, n2, n1);
  else dispatch<double>(ng, nmb, n3, n2, n1);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the tile geometry for the host")
    d = tmp_path_factory.mktemp("z4c_tiles")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wno-unknown-pragmas",
                    f"-I{d}", f"-I{CSRC}", "-o", str(exe),
                    str(d / "harness.cpp")], check=True, capture_output=True,
                   timeout=300)
    return {}, exe


def _run(harness, dtype, shape):
    cache, exe = harness
    key = (dtype, shape)
    if key not in cache:
        nmb, n3, n2, n1, ng = shape
        out = subprocess.run([str(exe), dtype, str(ng), str(nmb), str(n3),
                              str(n2), str(n1)], check=True,
                             capture_output=True, text=True, timeout=300)
        cache[key] = {ln.split()[0]: [int(v) for v in ln.split()[1:]]
                      for ln in out.stdout.splitlines()}
    return cache[key]


def _id(s):
    return "x".join(map(str, s[:4])) + f"-ng{s[4]}"


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=[_id(s) for s in SHAPES])
def test_every_interior_cell_once(harness, dtype, shape):
    nmb, n3, n2, n1, ng = shape
    once, other, ghost = _run(harness, dtype, shape)["cells"]
    assert once == nmb * (n3 - 2 * ng) * (n2 - 2 * ng) * (n1 - 2 * ng)
    assert other == 0 and ghost == 0


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=[_id(s) for s in SHAPES])
def test_stencil_reads_inside_the_window(harness, dtype, shape):
    bad_win, clamped, bad_d1, unwritten = _run(harness, dtype,
                                               shape)["reads"]
    assert (bad_win, clamped, bad_d1, unwritten) == (0, 0, 0, 0)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("ng", [2, 3, 4, 5])
def test_shared_memory_fits(harness, dtype, ng):
    shape = next(s for s in SHAPES if s[4] == ng)
    smem, minb = _run(harness, dtype, shape)["smem"]
    assert smem <= SMEM_BLOCK
    assert minb * (smem + SMEM_RESERVED) <= SMEM_SM
