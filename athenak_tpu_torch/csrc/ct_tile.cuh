// Tile geometry of kernel D (fused_ct.cu): how the faces of a pool are cut
// into CUDA blocks, which cells each block stages in a plane, which edges
// it forms and which faces it writes, and its shared memory.  Plain C++
// apart from the __host__ __device__ qualifiers, so that the CPU tests
// build it with g++ (tests/test_torch_ct_tiles.py).
//
// A CUDA block owns a tile of TJ x TI columns (j, i) of one MeshBlock,
// ghosts included, and a segment of planes [k0, k1) (kernel J's cut,
// flux_cut), and marches through the planes p = k0-1 .. k1.  One plane
// ahead it stages the window of the 15 input channels (CtChannel) over
// rows j0-1 .. j0+TJ and columns i0-1 .. i0+TI, each index wrapped into
// the block as the plain version's torch.roll wraps it, and the face
// fields of the plane its faces will update; at plane p it forms:
//   * the cell EMFs of every window cell, once a cell;
//   * (p >= k0) the corner EMFs e1, e2, e3 of the edges (j, i) = (j0+er,
//     i0+ec), er = 0 .. TJ, ec = 0 .. TI, at window cell (er+1, ec+1):
//     each reads its window cell and the cells one row and one column
//     below, in planes p and p-1;
//   * (p > k0) the new face fields of plane p-1 from the edges of planes
//     p-1 and p: the work list of each face array (ct_face), each face
//     its block's own (ct_owns).
// Index wraps of the plain version fall out of the window: edge row TJ of
// the last tile is row 0 (the extra x2 face j = n2 reads it), edge column
// TI of the last tile column 0 (the extra x1 face), and the edges of
// plane k1 = n3 are those of plane 0 (the extra x3 face k = n3, which the
// last segment writes after its march).
#pragma once

#include "split_tile.cuh"

namespace athenak {

// Tile shapes: float 8 x 32 columns, 352 threads (one a window cell, 340
// of them), two blocks an SM in 87 KB of shared memory each; double
// 4 x 32, 224 threads (204 window cells), two blocks an SM in 102 KB.
template <typename T>
struct CtTile;
template <>
struct CtTile<float> {
  static constexpr int TJ = 8, TI = 32, NT = 352, MINB = 2;
};
template <>
struct CtTile<double> {
  static constexpr int TJ = 4, TI = 32, NT = 224, MINB = 2;
};

// The staged channels of a plane, in this order: the three velocities
// (w 1-3), bcc 0-2, the mass fluxes of x1, x2, x3 and the six face EMFs.
enum CtChannel {
  CT_V1, CT_V2, CT_V3, CT_B1, CT_B2, CT_B3, CT_FD1, CT_FD2, CT_FD3,
  CT_E3X1, CT_E2X1, CT_E1X2, CT_E3X2, CT_E2X3, CT_E1X3, CT_NCH
};
constexpr int kCtRing = 3;  // planes p-1 and p, and p+1 in flight

// The window (wj x wi cells), the edges (ej x ei) and the work lists of
// faces of a plane: nf1 x1 faces (tj rows of ti+1), nf2 x2 faces (tj+1
// rows of ti), nf3 x3 faces (tj rows of ti), nf in all.
struct CtShape {
  int wj, wi, wc, ej, ei, ec, nf1, nf2, nf3, nf;
};
__host__ __device__ constexpr CtShape ct_shape(int tj, int ti) {
  return CtShape{tj + 2,
                 ti + 2,
                 (tj + 2) * (ti + 2),
                 tj + 1,
                 ti + 1,
                 (tj + 1) * (ti + 1),
                 tj * (ti + 1),
                 (tj + 1) * ti,
                 tj * ti,
                 tj * (ti + 1) + (tj + 1) * ti + tj * ti};
}

// Shared memory in elements: the window ring [3][15][wc], the faces'
// fields [2 planes][b, b_old][nf], the cell EMFs [2][3][wc] and the
// edges [2][3][ec].
__host__ __device__ constexpr int ct_smem(int tj, int ti) {
  return (kCtRing * CT_NCH + 6) * ct_shape(tj, ti).wc +
         4 * ct_shape(tj, ti).nf + 6 * ct_shape(tj, ti).ec;
}

// The cut: kernel J's, a segment stepping through two planes beyond its
// own (k0-1 and k1).
__host__ __device__ inline FluxGeom ct_geom(int nmb, int n3, int n2, int n1,
                                            int tj, int ti, long long slots) {
  return flux_cut(nmb, n3, n2, n1, tj, ti, 2, slots);
}

// The in-plane offset of window cell h of a tile whose first cell is
// (j0, i0): row j0-1 + h / wi, column i0-1 + h % wi, each wrapped.
__host__ __device__ inline int ct_win(int h, int wi, int j0, int i0, int n2,
                                      int n1) {
  return split_cell(j0 - 1 + h / wi, n2) * n1 +
         split_cell(i0 - 1 + h % wi, n1);
}

// Item e of face array q's work list (0: x1f, 1: x2f, 2: x3f): its row
// and column in the tile.
struct CtFace {
  int arr, r, c;
};
__host__ __device__ inline CtFace ct_face(int q, int e, int ti) {
  const int cols = q == 0 ? ti + 1 : ti;
  return CtFace{q, e / cols, e % cols};
}

// Whether the block of box b writes face f (in its planes): a face of its
// own cells, and on the last tile of an axis the extra face of that
// axis's face array (x1f i = n1, x2f j = n2).
__host__ __device__ inline bool ct_owns(const CtFace& f, const FluxBox& b,
                                        int n2, int n1) {
  const int jl = f.arr == 1 && b.j1 == n2 ? n2 + 1 : b.j1;
  const int il = f.arr == 0 && b.i1 == n1 ? n1 + 1 : b.i1;
  return b.j0 + f.r < jl && b.i0 + f.c < il;
}

// The in-plane offset of face f in its array: x1f [n2][n1+1], x2f
// [n2+1][n1], x3f [n2][n1].
__host__ __device__ inline int ct_face_off(const CtFace& f, int j0, int i0,
                                           int n1) {
  return (j0 + f.r) * (f.arr == 0 ? n1 + 1 : n1) + i0 + f.c;
}

// An edge a face reads: its component (0: e1, 1: e2, 2: e3), its index in
// the edge window and its plane, the face's plane + dk.
struct CtEdge {
  int comp, idx, dk;
};

// The four edges face f reads, the upper and lower edge of its first
// difference and then of its second, as the first design's face kernel
// differences them: x1f e3 (j+1, j) / dx2, e2 (k+1, k) / dx3; x2f e3
// (i+1, i) / dx1, e1 (k+1, k) / dx3; x3f e2 (i+1, i) / dx1, e1 (j+1, j)
// / dx2.
__host__ __device__ inline void ct_face_edges(const CtFace& f, int ei,
                                              CtEdge e[4]) {
  const int o = f.r * ei + f.c;
  if (f.arr == 0) {
    e[0] = CtEdge{2, o + ei, 0};
    e[1] = CtEdge{2, o, 0};
    e[2] = CtEdge{1, o, 1};
    e[3] = CtEdge{1, o, 0};
  } else if (f.arr == 1) {
    e[0] = CtEdge{2, o + 1, 0};
    e[1] = CtEdge{2, o, 0};
    e[2] = CtEdge{0, o, 1};
    e[3] = CtEdge{0, o, 0};
  } else {
    e[0] = CtEdge{1, o + 1, 0};
    e[1] = CtEdge{1, o, 0};
    e[2] = CtEdge{0, o + ei, 0};
    e[3] = CtEdge{0, o, 0};
  }
}

}  // namespace athenak
