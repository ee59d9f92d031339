// Kernel G's flat enumeration of the ghost copies of one pool fill, and
// kernel B's (periodic_fill.cu), in which every block is its own
// neighbour on every side (pool_self_item).
//
// Plain C++ apart from the __host__ __device__ qualifiers, so that the
// CPU tests build it with g++ (tests/test_torch_pool_fill.py,
// tests/test_torch_aux_fill_tiles.py) and hold it against a numpy mirror
// and the plain fill.
//
// One call fills up to three arrays of nmb blocks (the three face arrays,
// or one cell array).  Its ghost elements are cut into items of vec
// elements (vec 2 where the array's rows, ghost widths and wrap distance
// along x1 are even and the pointer is aligned: every run of ghosts along
// x1 then starts at an even offset on both sides, so a pair never mixes
// two donors; else vec 1).  Items are numbered block by block (m
// outermost, so a range of items touches few rows of the donor table),
// then array, channel, plane k, row j and i:
//   a ghost plane (k < ng3 or k >= n3 - ng3) contributes every row whole;
//   an interior plane contributes its ng2 ghost rows at either end whole
//   and, for each interior row, its ng1 ghost columns at either end.
// On a same-level periodic pool the ghost (k, j, i) copies the interior
// element (k - d3 nint3, j - d2 nint2, i - d1 nint1) of the neighbour
// block nbr27[m][9 (d3+1) + 3 (d2+1) + (d1+1)], where d_a is -1 below
// the interior, +1 above it and 0 inside along axis a.
#pragma once

namespace athenak {

constexpr int kPoolMaxArrays = 3;

// Division of a non-negative int by a divisor fixed for the call, by a
// multiply-high and two shifts (Granlund and Montgomery 1994, fig. 4.1):
// exact for every n < 2^32 and d >= 1.  A 32-bit integer division costs
// some 20 instructions; the item numbering takes five a copy.
struct DivBy {
  unsigned int d, m, s1, s2;
};

__host__ __device__ inline DivBy div_by(int d) {
  unsigned int l = 0;
  while ((1ULL << l) < static_cast<unsigned long long>(d)) ++l;
  DivBy r;
  r.d = static_cast<unsigned int>(d);
  r.m = static_cast<unsigned int>(
      ((1ULL << 32) * ((1ULL << l) - d)) / static_cast<unsigned long long>(d)
      + 1);
  r.s1 = l < 1 ? l : 1;
  r.s2 = l < 1 ? 0 : l - 1;
  return r;
}

__host__ __device__ inline int operator/(int n, const DivBy& b) {
  const unsigned int u = static_cast<unsigned int>(n);
  const unsigned int t =
      static_cast<unsigned int>((static_cast<unsigned long long>(b.m) * u) >>
                                32);
  return static_cast<int>((t + ((u - t) >> b.s1)) >> b.s2);
}

__host__ __device__ inline int operator%(int n, const DivBy& b) {
  return n - (n / b) * static_cast<int>(b.d);
}

struct PoolArray {
  int nc;                    // channels per block (1 for a face array)
  int n3, n2, n1;            // extents with ghosts
  int nint3, nint2, nint1;   // wrap distance per axis
  int vec;                   // elements per item: 1 or 2
  int row;                   // items of a whole row: n1 / vec
  int side;                  // items of one side's ghost columns: ng1 / vec
  int ghost_plane;           // items of a ghost plane
  int int_plane;             // items of an interior plane
  int volume;                // items of one channel of one block
  int items;                 // items of one block: nc * volume
  DivBy by_row, by_cols, by_ghost_plane, by_int_plane, by_volume;
};

struct PoolCall {
  PoolArray arr[kPoolMaxArrays];
  int narr, nmb;
  int ng3, ng2, ng1;         // ghost width per axis (0 when inactive)
  int per_block;             // items of one block over all arrays
  DivBy by_per_block;
  long long total;           // nmb * per_block (the kernel takes < 2^31)
};

// Where item t copies to: array q, block m, channel c, element (k, j, i)
// (the first of vec), and the direction (d3, d2, d1) of its donor.  The
// arithmetic is 32-bit and divides by DivBy: the kernel's instructions
// are mostly this numbering.
struct GhostItem {
  int q, m, c, k, j, i;
  int d3, d2, d1;
};

__host__ __device__ inline int pool_side(int p, int n, int ng) {
  return p < ng ? -1 : (p >= n - ng ? 1 : 0);
}

// Fills in the item counts of arr from its extents and vec.
__host__ __device__ inline void pool_count(PoolArray& a, int ng3, int ng2,
                                           int ng1) {
  a.row = a.n1 / a.vec;
  a.side = ng1 / a.vec;
  a.ghost_plane = a.n2 * a.row;
  a.int_plane = 2 * ng2 * a.row + (a.n2 - 2 * ng2) * 2 * a.side;
  a.volume = 2 * ng3 * a.ghost_plane + (a.n3 - 2 * ng3) * a.int_plane;
  a.items = a.nc * a.volume;
  a.by_row = div_by(a.row);
  a.by_cols = div_by(a.side > 0 ? 2 * a.side : 1);
  a.by_ghost_plane = div_by(a.ghost_plane);
  a.by_int_plane = div_by(a.int_plane > 0 ? a.int_plane : 1);
  a.by_volume = div_by(a.volume);
}

// vec of an array: 2 where pairs stay inside one run of ghosts on both
// sides and the pointer is aligned to a pair, else 1.
__host__ __device__ inline int pool_vec(int n1, int ng1, int nint1,
                                        unsigned long long addr,
                                        int elem_bytes) {
  const bool even = n1 % 2 == 0 && ng1 % 2 == 0 && nint1 % 2 == 0;
  return even && addr % (2ULL * elem_bytes) == 0 ? 2 : 1;
}

__host__ __device__ inline void pool_finish(PoolCall& p) {
  p.per_block = 0;
  for (int q = 0; q < p.narr; ++q) {
    pool_count(p.arr[q], p.ng3, p.ng2, p.ng1);
    p.per_block += p.arr[q].items;
  }
  p.total = static_cast<long long>(p.nmb) * p.per_block;
  p.by_per_block = div_by(p.per_block > 0 ? p.per_block : 1);
}

// The arrays of a call, as the C entry points take them.
struct PoolPtrs {
  void* ptr[kPoolMaxArrays];
};

// The description of one fill of narr arrays of nmb blocks, with ghost
// widths ng3, ng2, ng1: array q at ptrs.ptr[q], dims[8 q .. 8 q + 7] =
// nc, n3, n2, n1, nint3, nint2, nint1, unused (nint the wrap distance
// along each axis: the interior extent, or nx on the normal axis of a
// face array).
inline PoolCall pool_call(int narr, const int* dims, int nmb, int ng3,
                          int ng2, int ng1, const PoolPtrs& ptrs,
                          int elem_bytes) {
  PoolCall p{};
  p.narr = narr;
  p.nmb = nmb;
  p.ng3 = ng3;
  p.ng2 = ng2;
  p.ng1 = ng1;
  for (int q = 0; q < narr; ++q) {
    const int* d = dims + 8 * q;
    PoolArray& a = p.arr[q];
    a.nc = d[0];
    a.n3 = d[1];
    a.n2 = d[2];
    a.n1 = d[3];
    a.nint3 = d[4];
    a.nint2 = d[5];
    a.nint1 = d[6];
    a.vec = pool_vec(a.n1, ng1, a.nint1,
                     reinterpret_cast<unsigned long long>(ptrs.ptr[q]),
                     elem_bytes);
  }
  pool_finish(p);
  return p;
}

__host__ __device__ inline GhostItem pool_locate(const PoolCall& p,
                                                 int t) {
  GhostItem g;
  g.m = t / p.by_per_block;
  int r = t - g.m * p.per_block;
  g.q = 0;
  while (g.q + 1 < p.narr && r >= p.arr[g.q].items) {
    r -= p.arr[g.q].items;
    ++g.q;
  }
  const PoolArray& a = p.arr[g.q];
  g.c = r / a.by_volume;
  r -= g.c * a.volume;
  const int lo = p.ng3 * a.ghost_plane;
  const int mid = (a.n3 - 2 * p.ng3) * a.int_plane;
  if (r < lo || r >= lo + mid) {  // a ghost plane: whole rows
    const int rr = r < lo ? r : r - lo - mid;
    const int k0 = r < lo ? 0 : a.n3 - p.ng3;
    g.k = k0 + rr / a.by_ghost_plane;
    const int e = rr % a.by_ghost_plane;
    g.j = e / a.by_row;
    g.i = (e % a.by_row) * a.vec;
  } else {
    const int rr = r - lo;
    g.k = p.ng3 + rr / a.by_int_plane;
    const int e = rr % a.by_int_plane;
    const int rows = p.ng2 * a.row;           // one end's ghost rows
    const int cols = (a.n2 - 2 * p.ng2) * 2 * a.side;
    if (e < rows || e >= rows + cols) {
      const int ee = e < rows ? e : e - rows - cols;
      g.j = (e < rows ? 0 : a.n2 - p.ng2) + ee / a.by_row;
      g.i = (ee % a.by_row) * a.vec;
    } else {
      const int ee = e - rows;
      g.j = p.ng2 + ee / a.by_cols;
      const int col = (ee % a.by_cols) * a.vec;
      g.i = col < p.ng1 ? col : a.n1 - 2 * p.ng1 + col;
    }
  }
  g.d3 = pool_side(g.k, a.n3, p.ng3);
  g.d2 = pool_side(g.j, a.n2, p.ng2);
  g.d1 = pool_side(g.i, a.n1, p.ng1);
  return g;
}

__host__ __device__ inline int pool_dir(const GhostItem& g) {
  return 9 * (g.d3 + 1) + 3 * (g.d2 + 1) + (g.d1 + 1);
}

// Element offsets of the item's destination and of its donor's element.
__host__ __device__ inline void pool_offsets(const PoolCall& p,
                                             const GhostItem& g, int donor,
                                             long long& dst, long long& src) {
  const PoolArray& a = p.arr[g.q];
  const long long plane = static_cast<long long>(a.n2) * a.n1;
  dst = ((static_cast<long long>(g.m) * a.nc + g.c) * a.n3 + g.k) * plane +
        static_cast<long long>(g.j) * a.n1 + g.i;
  src = ((static_cast<long long>(donor) * a.nc + g.c) * a.n3 +
         (g.k - g.d3 * a.nint3)) * plane +
        static_cast<long long>(g.j - g.d2 * a.nint2) * a.n1 +
        (g.i - g.d1 * a.nint1);
}

// Item t of a fill in which every block is its own neighbour on every
// side (kernel B: single fully periodic blocks): its array, and the
// element offsets of its destination and of the interior element it
// copies.
__host__ __device__ inline int pool_self_item(const PoolCall& p, int t,
                                              long long& dst,
                                              long long& src) {
  const GhostItem g = pool_locate(p, t);
  pool_offsets(p, g, g.m, dst, src);
  return g.q;
}

}  // namespace athenak
