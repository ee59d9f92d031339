// Tile geometry of kernel H (z4c_rhs.cuh): how the interior cells of a
// pool are cut into CUDA blocks, which cells a block stages for each
// channel, where the first derivatives that the mixed derivatives share
// live, and its shared memory.  Plain C++ apart from the __host__
// __device__ qualifiers, so that the CPU tests build it with g++
// (tests/test_torch_z4c_tiles.py, tests/test_torch_z4c_host.py).
//
// A CUDA block owns a box of TX x TY x TZ interior cells (x fastest) of
// one MeshBlock, one thread a cell.  Channel by channel it stages the
// box's stencil window, the box and NG cells on every side (clamped into
// the array on a ragged box), into one of NSLOT slots, and computes the
// derivatives of that channel at its cells into a buffer of kZ4cSlots
// values a cell; the algebra of the stage then runs from the buffer.
// For the 11 channels whose mixed second derivatives the RHS takes, the
// inner first derivative is computed once a point of the window into
// two small arrays and read by every cell whose mixed stencils reach
// it:
//   d1x: the x derivative on planes z = -(NG-1) .. TZ+NG-2 and rows
//        y = -(NG-1) .. TY+NG-2 of the box (x in the box): the cross of
//        the rows of the box's planes and the planes of its rows;
//   d1y: the y derivative on planes -(NG-1) .. TZ+NG-2, rows and columns
//        of the box.
// (z, y, x) below are coordinates in the box; the window starts at
// (-NG, -NG, -NG), the d1 arrays at (-(NG-1), -(NG-1), 0) and
// (-(NG-1), 0, 0).
#pragma once

namespace athenak {

// The per-cell buffer: [slot][cell of the box], slot-major.  The
// centred values are not in it (the algebra reads them from u), and the
// second derivatives of the metric and the shift only as the sums the
// algebra takes of them, formed as each channel is differenced.
constexpr int kZ4cLadv = 0;      // the advective derivatives (fd.ladv); on
                                 // the Sommerfeld mask, for the channels
                                 // with a Sommerfeld row, that row
constexpr int kZ4cKo = 22;       // the Kreiss-Oliger sums (fd.ko)
constexpr int kZ4cD1 = 44;       // first derivatives, [16 channels][3]
constexpr int kZ4cDDChi = 92;    // second derivatives of chi, [6]
constexpr int kZ4cDDAlpha = 98;  // and of alpha, [6]
constexpr int kZ4cDDg = 104;     // the Ricci's sum over gu DDg of each
                                 // metric component, [6]
constexpr int kZ4cDDbd = 110;    // (1/3) sum_b D_a D_b beta^b, [3]
constexpr int kZ4cDDbs = 113;    // gu^bc D_b D_c beta^a, [3]
constexpr int kZ4cSlots = 116;

// A channel's row among those with first derivatives (chi, the metric,
// Khat, Gamma, Theta, alpha, beta; -1 where it has none), whether it has
// second derivatives (chi, the metric, alpha, beta) and whether it has a
// Sommerfeld row (Khat, A, Gamma, Theta).
__host__ __device__ constexpr int z4c_d1_row(int c) {
  return c <= 7 ? c : (c >= 14 ? c - 6 : -1);
}
__host__ __device__ constexpr bool z4c_mixed(int c) {
  return c <= 6 || c >= 18;
}
__host__ __device__ constexpr bool z4c_somm(int c) {
  return c >= 7 && c <= 17;
}

// The box's derived sizes, in cells; NSLOT window slots, so that
// NSLOT - 1 channels are in flight while one is differenced.
template <int TX_, int TY_, int TZ_, int NG_, int NSLOT_>
struct Z4cShape {
  static constexpr int TX = TX_, TY = TY_, TZ = TZ_, NG = NG_;
  static constexpr int NSLOT = NSLOT_;
  static constexpr int NC = TX * TY * TZ;            // threads, cells
  static constexpr int WX = TX + 2 * NG, WY = TY + 2 * NG, WZ = TZ + 2 * NG;
  static constexpr int WIN = WX * WY * WZ;           // window cells
  static constexpr int DY = TY + 2 * (NG - 1), DZ = TZ + 2 * (NG - 1);
  static constexpr int NXD = DZ * DY * TX;           // d1x array
  static constexpr int NYD = DZ * TY * TX;           // d1y array
  // the inner pass's points: d1x on the box's planes (NA), d1x on the
  // planes beyond them in the box's rows (NB), d1y (NYD)
  static constexpr int NA = TZ * DY * TX, NB = 2 * (NG - 1) * TY * TX;
  static constexpr int NP = NA + NB + NYD;
  // shared memory in elements: buffer, window slots, d1x, d1y
  static constexpr int SMEM = kZ4cSlots * NC + NSLOT * WIN + NXD + NYD;
};

// Box shapes by type and nghost, the window slots and the blocks an SM
// they are sized for (233,472 bytes of shared memory an SM, 1,024 of
// them kept for each block): float 8 x 4 x 4 at nghost 2 (three slots)
// and 3 (two), the decks' nghost, three blocks an SM in 69-72 KB each;
// 8 x 4 x 2 at 4 and 5; double 4 x 4 x 4 at 2, 4 x 4 x 2 above.  60
// (z4c) and 64 (puncture) are cut by 4 without a ragged box along y and
// z; 60 along x leaves one box of 4.
template <typename T, int NG>
struct Z4cTile;
template <>
struct Z4cTile<float, 2> : Z4cShape<8, 4, 4, 2, 3> {
  static constexpr int MINB = 3;
};
template <>
struct Z4cTile<float, 3> : Z4cShape<8, 4, 4, 3, 2> {
  static constexpr int MINB = 3;
};
template <>
struct Z4cTile<float, 4> : Z4cShape<8, 4, 2, 4, 3> {
  static constexpr int MINB = 4;
};
template <>
struct Z4cTile<float, 5> : Z4cShape<8, 4, 2, 5, 3> {
  static constexpr int MINB = 3;
};
template <>
struct Z4cTile<double, 2> : Z4cShape<4, 4, 4, 2, 4> {
  static constexpr int MINB = 2;
};
template <>
struct Z4cTile<double, 3> : Z4cShape<4, 4, 2, 3, 3> {
  static constexpr int MINB = 4;
};
template <>
struct Z4cTile<double, 4> : Z4cShape<4, 4, 2, 4, 3> {
  static constexpr int MINB = 3;
};
template <>
struct Z4cTile<double, 5> : Z4cShape<4, 4, 2, 5, 3> {
  static constexpr int MINB = 2;
};

// How a call is cut: nmb blocks of n3 x n2 x n1 cells with ng ghosts,
// ntx x nty x ntz boxes of tx x ty x tz interior cells a MeshBlock;
// CUDA's grid is one-dimensional, x fastest, then y, z, MeshBlock.
struct Z4cGeom {
  int nmb, n3, n2, n1, ng, tx, ty, tz, ntx, nty, ntz;
  long long blocks;
};

// The cells of one CUDA block: MeshBlock m, interior planes [k0, k1),
// rows [j0, j1), columns [i0, i1); (k0, j0, i0) is the box's first cell,
// and a ragged box holds fewer than tz x ty x tx interior cells.
struct Z4cBox {
  int m, k0, k1, j0, j1, i0, i1;
};

__host__ __device__ inline int z4c_ceil(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline Z4cGeom z4c_geom(int nmb, int n3, int n2, int n1,
                                            int ng, int tx, int ty,
                                            int tz) {
  Z4cGeom g{};
  g.nmb = nmb;
  g.n3 = n3;
  g.n2 = n2;
  g.n1 = n1;
  g.ng = ng;
  g.tx = tx;
  g.ty = ty;
  g.tz = tz;
  g.ntx = z4c_ceil(n1 - 2 * ng, tx);
  g.nty = z4c_ceil(n2 - 2 * ng, ty);
  g.ntz = z4c_ceil(n3 - 2 * ng, tz);
  g.blocks = static_cast<long long>(nmb) * g.ntz * g.nty * g.ntx;
  return g;
}

__host__ __device__ inline Z4cBox z4c_box(const Z4cGeom& g, long long b) {
  Z4cBox o;
  const int bx = static_cast<int>(b % g.ntx);
  b /= g.ntx;
  const int by = static_cast<int>(b % g.nty);
  b /= g.nty;
  const int bz = static_cast<int>(b % g.ntz);
  o.m = static_cast<int>(b / g.ntz);
  o.k0 = g.ng + bz * g.tz;
  o.k1 = o.k0 + g.tz < g.n3 - g.ng ? o.k0 + g.tz : g.n3 - g.ng;
  o.j0 = g.ng + by * g.ty;
  o.j1 = o.j0 + g.ty < g.n2 - g.ng ? o.j0 + g.ty : g.n2 - g.ng;
  o.i0 = g.ng + bx * g.tx;
  o.i1 = o.i0 + g.tx < g.n1 - g.ng ? o.i0 + g.tx : g.n1 - g.ng;
  return o;
}

__host__ __device__ inline int z4c_clamp(int p, int hi) {
  return p < 0 ? 0 : (p > hi ? hi : p);
}

// The offset in a channel of MeshBlock box.m of window cell h: the box's
// cell (z, y, x) = (h / (WY WX) - NG, h / WX % WY - NG, h % WX - NG),
// clamped into the array (a ragged box reads beyond the interior; those
// values reach only cells that are not written).
template <class Sh>
__host__ __device__ inline int z4c_src(const Z4cGeom& g, const Z4cBox& b,
                                       int h) {
  const int k = z4c_clamp(b.k0 - Sh::NG + h / (Sh::WY * Sh::WX), g.n3 - 1);
  const int j = z4c_clamp(b.j0 - Sh::NG + h / Sh::WX % Sh::WY, g.n2 - 1);
  const int i = z4c_clamp(b.i0 - Sh::NG + h % Sh::WX, g.n1 - 1);
  return (k * g.n2 + j) * g.n1 + i;
}

// The point of the inner pass p: which array (0 d1x, 1 d1y) and its
// index there, and the window cell at which the derivative is taken.
struct Z4cInner {
  int d, dst, win;
};
template <class Sh>
__host__ __device__ inline Z4cInner z4c_inner_point(int p) {
  constexpr int TX = Sh::TX, TY = Sh::TY, TZ = Sh::TZ, NG = Sh::NG;
  int zb, yb, x;  // in the d1 array's coordinates
  Z4cInner o;
  if (p < Sh::NA + Sh::NB) {
    if (p < Sh::NA) {
      zb = NG - 1 + p / (Sh::DY * TX);
      yb = p / TX % Sh::DY;
    } else {
      const int q = p - Sh::NA, zz = q / (TY * TX);
      zb = zz < NG - 1 ? zz : zz + TZ;
      yb = NG - 1 + q / TX % TY;
    }
    x = p % TX;
    o.d = 0;
    o.dst = (zb * Sh::DY + yb) * TX + x;
    o.win = ((zb + 1) * Sh::WY + yb + 1) * Sh::WX + x + NG;
  } else {
    const int q = p - Sh::NA - Sh::NB;
    zb = q / (TY * TX);
    yb = q / TX % TY;
    x = q % TX;
    o.d = 1;
    o.dst = (zb * TY + yb) * TX + x;
    o.win = ((zb + 1) * Sh::WY + yb + NG) * Sh::WX + x + NG;
  }
  return o;
}

// Cell t of the box: its window cell, and its places in d1x and d1y.
struct Z4cCellPos {
  int z, y, x, win, dx, dy;
};
template <class Sh>
__host__ __device__ inline Z4cCellPos z4c_cell_pos(int t) {
  Z4cCellPos o;
  o.x = t % Sh::TX;
  o.y = t / Sh::TX % Sh::TY;
  o.z = t / (Sh::TX * Sh::TY);
  o.win = ((o.z + Sh::NG) * Sh::WY + o.y + Sh::NG) * Sh::WX + o.x + Sh::NG;
  o.dx = ((o.z + Sh::NG - 1) * Sh::DY + o.y + Sh::NG - 1) * Sh::TX + o.x;
  o.dy = ((o.z + Sh::NG - 1) * Sh::TY + o.y) * Sh::TX + o.x;
  return o;
}

}  // namespace athenak
