// Kernel I's numbering of the ghosts of one block whose six faces are
// outflow (z4c_stage.cu).  Plain C++ apart from the __host__ __device__
// qualifiers, so that the CPU tests build it with g++
// (tests/test_torch_ct_tiles.py) and hold it against a numpy mirror.
//
// The x1 -> x2 -> x3 outflow sweeps give the ghost (k, j, i) of every
// channel the value of the interior cell (clamp(k), clamp(j), clamp(i)),
// each index clamped into [ng, n - ng).  A call numbers the ghosts of nch
// channels of n3 x n2 x n1 cells as items, channel by channel:
//   * row items: every row (k, j) with k or j a ghost index is ghost
//     whole, cut into items of vec elements (its donor row is the
//     clamped one, each element's column clamped too);
//   * side items: every interior row (k, j) has ng ghost columns at
//     either end, one item a side, which takes one donor value.
// Rows come first, in (k, j) order, then the sides, (k, j, low/high).
// Offsets are 32-bit: a call takes fewer than 2^31 elements.
#pragma once

namespace athenak {

struct OutflowCall {
  int nch, n3, n2, n1, ng;
  int vec;         // elements of a row item: 1, 2 or 4 (at most 16 bytes)
  int row_items;   // items of a whole ghost row: n1 / vec
  int rows;        // ghost rows of a channel
  int sides;       // side items of a channel: 2 (n3 - 2 ng) (n2 - 2 ng)
  int per_ch;      // items of a channel: rows * row_items + sides
  long long total;  // nch * per_ch
};

// vec of a call: the widest of 4, 2, 1 elements (16 bytes at most) that
// divides a row and to which the array is aligned, so that every row
// item is one aligned access.
__host__ __device__ inline int outflow_vec(int n1, unsigned long long addr,
                                           int elem_bytes) {
  for (int v = 16 / elem_bytes; v > 1; v /= 2)
    if (n1 % v == 0 && addr % (static_cast<unsigned long long>(v) *
                               elem_bytes) == 0)
      return v;
  return 1;
}

__host__ __device__ inline OutflowCall outflow_call(int nch, int n3, int n2,
                                                    int n1, int ng, int vec) {
  OutflowCall p;
  p.nch = nch;
  p.n3 = n3;
  p.n2 = n2;
  p.n1 = n1;
  p.ng = ng;
  p.vec = vec;
  p.row_items = n1 / vec;
  p.rows = n3 * n2 - (n3 - 2 * ng) * (n2 - 2 * ng);
  p.sides = 2 * (n3 - 2 * ng) * (n2 - 2 * ng);
  p.per_ch = p.rows * p.row_items + p.sides;
  p.total = static_cast<long long>(nch) * p.per_ch;
  return p;
}

__host__ __device__ inline int outflow_clamp(int p, int lo, int hi) {
  return p < lo ? lo : (p > hi ? hi : p);
}

// Item t: side 0 for a row item (vec elements from column i), 1 or 2 for
// the low or high side of an interior row (ng elements from column i);
// dst the element offset of its first element, row the offset of its
// donor row's first element.
struct OutflowItem {
  int side, i, dst, row;
};

__host__ __device__ inline OutflowItem outflow_item(const OutflowCall& p,
                                                    int t) {
  const int ng = p.ng;
  const int c = t / p.per_ch;
  const int r = t - c * p.per_ch;
  const int nrow = p.rows * p.row_items;
  OutflowItem o;
  int k, j;
  if (r < nrow) {
    const int row = r / p.row_items;
    o.side = 0;
    o.i = (r - row * p.row_items) * p.vec;
    // ng ghost planes whole, then the 2 ng ghost rows of each interior
    // plane, then ng ghost planes whole
    const int lo = ng * p.n2, mid = (p.n3 - 2 * ng) * 2 * ng;
    if (row < lo || row >= lo + mid) {
      const int rr = row < lo ? row : row - lo - mid;
      k = (row < lo ? 0 : p.n3 - ng) + rr / p.n2;
      j = rr % p.n2;
    } else {
      const int rr = row - lo;
      k = ng + rr / (2 * ng);
      const int jj = rr % (2 * ng);
      j = jj < ng ? jj : p.n2 - 2 * ng + jj;
    }
  } else {
    const int s = (r - nrow) >> 1, nj = p.n2 - 2 * ng;
    k = ng + s / nj;
    j = ng + s % nj;
    o.side = 1 + ((r - nrow) & 1);
    o.i = o.side == 1 ? 0 : p.n1 - ng;
  }
  const int plane = p.n2 * p.n1, chan = p.n3 * plane;
  o.dst = c * chan + k * plane + j * p.n1 + o.i;
  o.row = c * chan + outflow_clamp(k, ng, p.n3 - ng - 1) * plane +
          outflow_clamp(j, ng, p.n2 - ng - 1) * p.n1;
  return o;
}

}  // namespace athenak
