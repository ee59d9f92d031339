// Tile geometry of kernel J (flux_dir.cu): how the cells of a pool are
// cut into CUDA blocks for the fluxes of one direction, which cells each
// block stages in shared memory, and its shared memory.  Plain C++ apart
// from the __host__ __device__ qualifiers, so that the CPU tests build
// it with g++ (tests/test_torch_flux_tiles.py).
//
// A CUDA block owns a tile of TJ x TI columns (j, i) of one MeshBlock,
// ghosts included, and a segment of planes [k0, k1) along k, and computes
// the lower face along DIR of every cell of the tile, one thread a
// column, marching through its planes.  For each plane it stages the
// stencil window of the seven channels the face states need (w 0-4 and
// the two transverse channels of bcc) and the normal field of its
// faces:
//   x1: rows j0 .. j0+TJ-1, columns i0-2 .. i0+TI, one plane;
//   x2: rows j0-2 .. j0+TJ, columns i0 .. i0+TI-1, one plane;
//   x3: rows j0 .. j0+TJ-1, columns i0 .. i0+TI-1, planes k-2 .. k+1, a
//       ring of planes the march shifts by one a step.
// Along the stencil's axis an index wraps into [0, n) (the plain
// version's torch.roll); positions of a ragged tile beyond the block are
// clamped to n first and read values nobody uses.  Across it, the rows
// and columns of a ragged tile beyond the block are clamped to the last.
#pragma once

namespace athenak {

// Tile shapes: 6 x 36 columns, 216 threads (the smr deck's 36^2 planes
// in six tiles, the 1028^2 Orszag-Tang plane in 172 x 29); in float32,
// at most 96 registers a thread keep three blocks on an SM.
template <typename T>
struct FluxTile;
template <>
struct FluxTile<float> {
  static constexpr int TJ = 6, TI = 36, MINB = 3;
};
template <>
struct FluxTile<double> {
  static constexpr int TJ = 6, TI = 36, MINB = 1;
};

// The staged window of a plane, as offsets from the tile's first cell
// (j0, i0): rows j0 + j_lo .. j0 + j_lo + nj - 1, columns i0 + i_lo ..
// i0 + i_lo + ni - 1; planes k + k_lo .. k + k_hi for the faces of
// plane k.
struct FluxWin {
  int j_lo, nj, i_lo, ni, k_lo, k_hi;
};
__host__ __device__ constexpr FluxWin flux_window(int dir, int tj, int ti) {
  return dir == 0   ? FluxWin{0, tj, -2, ti + 3, 0, 0}
         : dir == 1 ? FluxWin{-2, tj + 3, 0, ti, 0, 0}
                    : FluxWin{0, tj, 0, ti, -2, 1};
}
// planes in the ring: the window's and the one in flight
__host__ __device__ constexpr int flux_ring(int dir) {
  return dir == 2 ? 5 : 2;
}
// shared memory, in elements: [ring][7 channels][window], then the
// normal field [ring][tj * ti]
__host__ __device__ constexpr int flux_smem(int dir, int tj, int ti) {
  return flux_ring(dir) *
         (7 * flux_window(dir, tj, ti).nj * flux_window(dir, tj, ti).ni +
          tj * ti);
}

// How a call is cut: nmb blocks of n3 x n2 x n1 cells, ntj x nti tiles
// of tj x ti columns, nseg segments of seg planes; CUDA's grid is
// (ntj * nti, nseg, nmb).
struct FluxGeom {
  int nmb, n3, n2, n1, dir;
  int tj, ti, ntj, nti;
  int nseg, seg;
  long long blocks;
};

// The cells of one CUDA block: MeshBlock m, planes [k0, k1), rows
// [j0, j1), columns [i0, i1).
struct FluxBox {
  int m, k0, k1, j0, j1, i0, i1;
};

__host__ __device__ inline int flux_ceil(int a, int b) {
  return (a + b - 1) / b;
}

// Chooses the number of k segments for `slots` blocks resident on the
// card at once: the fewest waves of blocks, each as short as it can be,
// by the cost model waves * (planes + h), where h counts the planes a
// segment stages or steps through beyond its own.
__host__ __device__ inline FluxGeom flux_cut(int nmb, int n3, int n2, int n1,
                                             int tj, int ti, int h,
                                             long long slots) {
  FluxGeom g{};
  g.nmb = nmb;
  g.n3 = n3;
  g.n2 = n2;
  g.n1 = n1;
  g.tj = tj;
  g.ti = ti;
  g.ntj = flux_ceil(n2, tj);
  g.nti = flux_ceil(n1, ti);
  const long long cols = static_cast<long long>(nmb) * g.ntj * g.nti;
  long long best = -1;
  for (int nseg = 1; nseg <= n3; ++nseg) {
    const int seg = flux_ceil(n3, nseg);
    if (flux_ceil(n3, seg) != nseg) continue;  // the same cut as fewer
    const long long waves = (cols * nseg + slots - 1) / slots;
    const long long cost = waves * (seg + h);
    if (best < 0 || cost < best) {
      best = cost;
      g.nseg = nseg;
      g.seg = seg;
    }
  }
  g.blocks = cols * g.nseg;
  return g;
}

// Kernel J's cut of direction dir: h is the planes a segment stages
// beyond its own (3 for x3) plus one for the first copy.
__host__ __device__ inline FluxGeom flux_geom(int nmb, int n3, int n2,
                                              int n1, int dir, int tj,
                                              int ti, long long slots) {
  FluxGeom g = flux_cut(nmb, n3, n2, n1, tj, ti, dir == 2 ? 4 : 1, slots);
  g.dir = dir;
  return g;
}

__host__ __device__ inline FluxBox flux_box(const FluxGeom& g, int tile,
                                            int s, int m) {
  FluxBox b;
  b.m = m;
  b.k0 = s * g.seg;
  b.k1 = b.k0 + g.seg < g.n3 ? b.k0 + g.seg : g.n3;
  b.j0 = (tile / g.nti) * g.tj;
  b.j1 = b.j0 + g.tj < g.n2 ? b.j0 + g.tj : g.n2;
  b.i0 = (tile % g.nti) * g.ti;
  b.i1 = b.i0 + g.ti < g.n1 ? b.i0 + g.ti : g.n1;
  return b;
}

// The cell index of staged position p (a row, a column or a plane) on an
// axis of n cells: wrapped into [0, n) along the stencil's axis, after
// clamping a ragged tile's positions beyond the block to n; clamped to
// n - 1 across it.
__host__ __device__ inline int flux_cell(int p, int n, bool stencil) {
  if (!stencil) return p < n ? p : n - 1;
  p = p < n ? p : n;
  return p < 0 ? p + n : (p >= n ? p - n : p);
}

}  // namespace athenak
