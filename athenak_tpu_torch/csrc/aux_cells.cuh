// Kernel F's map of threads to cells (fused_aux.cu).
//
// Plain C++ apart from the __host__ __device__ qualifiers, so that the
// CPU tests build it with g++ (tests/test_torch_aux_fill_tiles.py) and
// check that every cell is converted by one thread, from the source the
// plain version reads.
//
// The cells of a call, ghosts included, are numbered flatly in
// (m, k, j, i) order; thread x of CUDA block b in a grid of G blocks of
// kThreads converts cells b kThreads + x, then every G kThreads further.
// Neighbouring threads take neighbouring cells of a row, so the reads of
// b1[i] and b1[i+1], of rows j and j+1 of b2 and of planes k and k+1 of
// b3 are coalesced.  All index arithmetic is 32-bit (the wrapper keeps
// the call's cells, with room for the grid's stride, and the 5 n3 n2 n1
// values of a block's u below 2^31); a block's base is added in 64 bits.
// With the wrap (a single fully periodic block) the cell reads the
// interior cell (sk, sj, si) it wraps to along every axis.
#pragma once

namespace athenak {

struct AuxGeom {
  int nmb, n3, n2, n1, ng;
  int nint3, nint2, nint1;  // interior extents: the wrap distances
  int ncell;                // cells of one channel of one block
  int cells;                // cells of the call: nmb ncell
};

__host__ __device__ inline AuxGeom aux_geom(int nmb, int n3, int n2,
                                            int n1, int ng) {
  AuxGeom g;
  g.nmb = nmb;
  g.n3 = n3;
  g.n2 = n2;
  g.n1 = n1;
  g.ng = ng;
  g.nint3 = n3 - 2 * ng;
  g.nint2 = n2 - 2 * ng;
  g.nint1 = n1 - 2 * ng;
  g.ncell = n3 * n2 * n1;
  g.cells = nmb * g.ncell;
  return g;
}

// p, or the interior index it wraps to along an axis of n with ng ghosts
__host__ __device__ inline int aux_wrap(int p, int n, int nint, int ng) {
  return p < ng ? p + nint : (p >= n - ng ? p - nint : p);
}

// Cell t: its block m, the in-block offsets (elements, channel 0) of the
// output cell (k, j, i) of a cell array, of its source cell (sk, sj, si)
// in a cell array, and of the source's faces in x1f ([n3, n2, n1 + 1];
// face i + 1 is next), x2f ([n3, n2 + 1, n1]; row j + 1 is n1 further)
// and x3f ([n3 + 1, n2, n1]; plane k + 1 is n2 n1 further); and whether
// the cell is interior (its floor hits and speeds count).
struct AuxCell {
  int m, dst, src, f1, f2, f3;
  bool inner;
};

__host__ __device__ inline AuxCell aux_cell(const AuxGeom& g, int t,
                                            bool wrap) {
  const int i = t % g.n1;
  const int r = t / g.n1;
  const int j = r % g.n2;
  const int r2 = r / g.n2;
  const int k = r2 % g.n3;
  const int si = wrap ? aux_wrap(i, g.n1, g.nint1, g.ng) : i;
  const int sj = wrap ? aux_wrap(j, g.n2, g.nint2, g.ng) : j;
  const int sk = wrap ? aux_wrap(k, g.n3, g.nint3, g.ng) : k;
  AuxCell c;
  c.m = r2 / g.n3;
  c.dst = (k * g.n2 + j) * g.n1 + i;
  c.src = (sk * g.n2 + sj) * g.n1 + si;
  c.f1 = (sk * g.n2 + sj) * (g.n1 + 1) + si;
  c.f2 = (sk * (g.n2 + 1) + sj) * g.n1 + si;
  c.f3 = c.src;
  c.inner = k >= g.ng && k < g.n3 - g.ng && j >= g.ng && j < g.n2 - g.ng &&
            i >= g.ng && i < g.n1 - g.ng;
  return c;
}

}  // namespace athenak
