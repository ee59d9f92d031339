// Tile geometry of kernel C (fused_stage.cu): how the cells of a pool,
// ghosts included, are cut into CUDA blocks, which faces each block
// computes in a plane, which cells it stages, and its shared memory.
// Plain C++ apart from the __host__ __device__ qualifiers, so that the
// CPU tests build it with g++ (tests/test_torch_split_tiles.py).
//
// A CUDA block owns a tile of TJ x TI columns (j, i) of one MeshBlock,
// ghosts included, and a segment of planes [k0, k1) (kernel J's cut,
// flux_tile.cuh's flux_geom with the x3 halo), and marches through its
// planes.  At plane k it computes one work list of faces:
//   x1: rows 0 .. TJ-1 of the tile, faces 0 .. TI (the lower faces of its
//       columns and the upper face of its last);
//   x2: face rows 0 .. TJ, columns 0 .. TI-1;
//   x3: the upper faces (face k+1) of the tile's cells;
// and from these fluxes and the x3 faces of plane k, which the step
// before computed, the register of the tile's cells of plane k.  Each
// face of the work list takes its four stencil cells from a window of
// the eight channels (w 0-4, bcc 0-2) staged for every plane: rows
// j0-2 .. j0+TJ+1, columns i0-2 .. i0+TI+1, each index wrapped into the
// block as the plain version's torch.roll wraps it; x3 reads planes
// k-1 .. k+2 of a ring of five.  The normal field of each face is staged
// with its plane in the work list's order.  A tile's faces on its upper
// sides are its neighbours' lower faces: both compute them, from the
// same inputs; only the owner writes the mass flux and face EMFs.
#pragma once

#include "flux_tile.cuh"

namespace athenak {

// Tile shapes: float 8 x 32 columns (128^3 in 16 x 4 tiles), 288
// threads for the 808 faces of a plane (three rounds), two blocks an SM
// in 104 KB of shared memory each; double 4 x 32 and 160 threads for 420
// faces, one block an SM.
template <typename T>
struct SplitTile;
template <>
struct SplitTile<float> {
  static constexpr int TJ = 8, TI = 32, NT = 288, MINB = 2;
};
template <>
struct SplitTile<double> {
  static constexpr int TJ = 4, TI = 32, NT = 160, MINB = 1;
};

// The window of a plane (rows j0-2 .. j0+tj+1, columns i0-2 .. i0+ti+1:
// the stencils of the faces 0 .. tj and 0 .. ti) and the work list: n1 x1
// faces, n2 x2 faces, n3 x3 faces.
struct SplitShape {
  int wj, wi, wc, n1, n2, n3, nit;
};
__host__ __device__ constexpr SplitShape split_shape(int tj, int ti) {
  return SplitShape{tj + 4,
                    ti + 4,
                    (tj + 4) * (ti + 4),
                    tj * (ti + 1),
                    (tj + 1) * ti,
                    tj * ti,
                    tj * (ti + 1) + (tj + 1) * ti + tj * ti};
}
constexpr int kSplitRing = 5;  // planes k-2 .. k+2, one of them in flight

// Shared memory in elements: the window ring [5][8][wc], the normal
// field ring [5][nit] (the work list's order), the x1 and x2 fluxes
// [5][n1], [5][n2] and the x3 fluxes of two face planes [2][5][n3].
__host__ __device__ constexpr int split_smem(int tj, int ti) {
  return kSplitRing * 8 * split_shape(tj, ti).wc +
         kSplitRing * split_shape(tj, ti).nit + 5 * split_shape(tj, ti).n1 +
         5 * split_shape(tj, ti).n2 + 2 * 5 * split_shape(tj, ti).n3;
}

// p wrapped into [0, n): torch.roll's wrap, for any p
__host__ __device__ inline int split_cell(int p, int n) {
  const int r = p % n;
  return r < 0 ? r + n : r;
}

// Item it of the work list: its direction, the face's row and column in
// the tile (a face carries the index of the cell above it), and the
// window cell (row, column) of its first stencil cell; the four stencil
// cells follow along the direction (x3: in planes k-1 .. k+2).
struct SplitItem {
  int dir, r, c, wr, wcol;
};
__host__ __device__ inline SplitItem split_item(int it, int tj, int ti) {
  SplitItem o;
  const int n1 = tj * (ti + 1), n2 = (tj + 1) * ti;
  if (it < n1) {
    o.dir = 0;
    o.r = it / (ti + 1);
    o.c = it % (ti + 1);
    o.wr = o.r + 2;
    o.wcol = o.c;
  } else if (it < n1 + n2) {
    o.dir = 1;
    o.r = (it - n1) / ti;
    o.c = (it - n1) % ti;
    o.wr = o.r;
    o.wcol = o.c + 2;
  } else {
    o.dir = 2;
    o.r = (it - n1 - n2) / ti;
    o.c = (it - n1 - n2) % ti;
    o.wr = o.r + 2;
    o.wcol = o.c + 2;
  }
  return o;
}

// The in-plane offset of window cell h of a tile whose first cell is
// (j0, i0): row j0-2 + h / wi, column i0-2 + h % wi, each wrapped.
__host__ __device__ inline int split_win(int h, int wi, int j0, int i0,
                                         int n2, int n1) {
  return split_cell(j0 - 2 + h / wi, n2) * n1 + split_cell(i0 - 2 + h % wi, n1);
}

// The in-plane offset, in its face array, of the normal field of item q
// of a tile whose first cell is (j0, i0): x1f [n2][n1+1], x2f [n2+1][n1]
// and x3f [n2][n1] at the lower face of the wrapped cell, the face the
// plain version's stencil uses.
__host__ __device__ inline int split_nf(const SplitItem& q, int j0, int i0,
                                        int n2, int n1) {
  const int j = split_cell(j0 + q.r, n2), i = split_cell(i0 + q.c, n1);
  return q.dir == 0 ? j * (n1 + 1) + i : j * n1 + i;
}

// Whether the block of box b writes the mass flux and face EMFs of item
// q at face plane kf: the lower face of one of its own cells.
__host__ __device__ inline bool split_owns(const SplitItem& q,
                                          const FluxBox& b, int kf) {
  return b.j0 + q.r < b.j1 && b.i0 + q.c < b.i1 && kf >= b.k0 && kf < b.k1;
}

}  // namespace athenak
