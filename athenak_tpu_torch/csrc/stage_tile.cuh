// Tile geometry of the fused Newtonian stage kernels (kernel A,
// mega_stage_v2.cu, and kernel E, mega_stage_v1.cu): how the interior
// cells of a pool are cut into CUDA blocks, what each block computes
// around its cells, and its shared memory.  Plain C++ apart from the
// __host__ __device__ qualifiers, so that the CPU tests build it with
// g++ (tests/test_torch_stage_tiles.py).
//
// A CUDA block owns a tile of interior columns, tj x ti cells in (j, i),
// of one MeshBlock and a segment of interior planes [k0, k1) along k, and
// marches through k with a ring of planes in shared memory.  Around its
// cells it computes (TileRange and KRange below; the tile's own faces
// and edges plus what the corner EMFs reach):
//   primitives and cell-centred B: rows j0-2 .. j0+tj+1, columns
//       i0-2 .. i0+ti+1, planes k0-2 .. k1+1;
//   x1 fluxes: rows j0-1 .. j0+tj, faces i0 .. i0+ti, planes k0-1 .. k1;
//   x2 fluxes: rows j0 .. j0+tj, columns i0-1 .. i0+ti, planes k0-1 .. k1;
//   x3 fluxes: rows j0-1 .. j0+tj, columns i0-1 .. i0+ti, faces k0 .. k1;
//   corner EMFs: e1 on edges j0 .. j0+tj, i0 .. i0+ti-1, k0 .. k1;
//                e2 on j0 .. j0+tj-1, i0 .. i0+ti, k0 .. k1;
//                e3 on j0 .. j0+tj, i0 .. i0+ti, k0 .. k1-1.
// A tile at the upper end of a block's interior may be ragged (124 and 62
// are not multiples of the tile); its cells beyond the interior are
// computed from clamped reads and never written.  Faces and edges on a
// tile's sides are computed by both neighbouring tiles.
#pragma once

namespace athenak {

// Tile shapes: f32 8 x 16 columns and 256 threads (two blocks an SM in
// some 105 KB of shared memory each); f64 8 x 8 and 128 threads.
template <typename T>
struct StageTile;
template <>
struct StageTile<float> {
  static constexpr int TJ = 8, TI = 16, NT = 256, MINB = 2;
};
template <>
struct StageTile<double> {
  static constexpr int TJ = 8, TI = 8, NT = 128, MINB = 1;
};

// What a CUDA block computes in a plane, as offsets from its tile's first
// interior cell (j0, i0): rows j0 + j_lo .. j0 + j_lo + nj - 1 and
// columns i0 + i_lo .. i0 + i_lo + ni - 1 (a face or edge carries the
// index of the cell above it).
struct TileRange {
  int j_lo, nj, i_lo, ni;
};
__host__ __device__ constexpr TileRange prim_range(int tj, int ti) {
  return TileRange{-2, tj + 4, -2, ti + 4};
}
// dir 0, 1, 2: x1, x2, x3 faces
__host__ __device__ constexpr TileRange flux_range(int dir, int tj, int ti) {
  return dir == 0   ? TileRange{-1, tj + 2, 0, ti + 1}
         : dir == 1 ? TileRange{0, tj + 1, -1, ti + 2}
                    : TileRange{-1, tj + 2, -1, ti + 2};
}
// dir 0, 1, 2: the corner EMFs e1, e2, e3
__host__ __device__ constexpr TileRange edge_range(int dir, int tj, int ti) {
  return dir == 0   ? TileRange{0, tj + 1, 0, ti}
         : dir == 1 ? TileRange{0, tj, 0, ti + 1}
                    : TileRange{0, tj + 1, 0, ti + 1};
}
// Along k, for a segment of planes [k0, k1): planes (or faces, or edges)
// k0 + lo .. k1 - 1 + hi.
struct KRange {
  int lo, hi;
};
constexpr KRange kPrimK{-2, 2};    // w, bcc and the floored u
constexpr KRange kFluxK12{-1, 1};  // x1 and x2 fluxes
constexpr KRange kFluxK3{0, 1};    // x3 fluxes
constexpr KRange kEdgeK12{0, 1};   // e1, e2
constexpr KRange kEdgeK3{0, 0};    // e3

__host__ __device__ constexpr int range_size(TileRange r) {
  return r.nj * r.ni;
}

// Shared-memory layout of one CUDA block, in elements of the working
// type.  The rings hold the last planes the march still reads:
//   prim  [4 planes][8: w 0-4, bcc 5-7][prim_range]
//   u0    [4 planes][5][tj * ti]            the floored input state
//   f1    [2 planes][7: flux 0-4, ey, ez][flux_range(0)]
//   f2    [2 planes][7][flux_range(1)]
//   f3    [2 faces][7][flux_range(2)]
//   e1    [2 edge planes][edge_range(0)]
//   e2    [2 edge planes][edge_range(1)]
//   e3    [edge_range(2)]
//   stage [3 planes][u 5 * hj * hi, b1 hj * (hi + 1), b2 (hj + 1) * hi,
//                    b3 2 * hj * hi]         raw inputs, loaded with
//                                            cp.async steps ahead of use
//   rk    [u1 5 * tj * ti, then b and the RK register b_old of the
//          tile's faces: b1, b1o tj * (ti + 1), b2, b2o (tj + 1) * ti,
//          b3, b3o 2 * tj * ti]              what the update of a plane
//                                            reads besides the fluxes
//                                            and EMFs, loaded a step or
//                                            a phase ahead
// where hj x hi is the prim range.
struct StageSmem {
  int prim, u0, f1, f2, f3, e1, e2, e3, stage, stage_slot, rk, total;
};

__host__ __device__ constexpr StageSmem stage_smem(int tj, int ti) {
  const TileRange pr = prim_range(tj, ti);
  const int hc = range_size(pr);
  StageSmem s{};
  s.prim = 0;
  s.u0 = s.prim + 4 * 8 * hc;
  s.f1 = s.u0 + 4 * 5 * tj * ti;
  s.f2 = s.f1 + 2 * 7 * range_size(flux_range(0, tj, ti));
  s.f3 = s.f2 + 2 * 7 * range_size(flux_range(1, tj, ti));
  s.e1 = s.f3 + 2 * 7 * range_size(flux_range(2, tj, ti));
  s.e2 = s.e1 + 2 * range_size(edge_range(0, tj, ti));
  s.e3 = s.e2 + 2 * range_size(edge_range(1, tj, ti));
  s.stage = s.e3 + range_size(edge_range(2, tj, ti));
  s.stage_slot = 5 * hc + pr.nj * (pr.ni + 1) + (pr.nj + 1) * pr.ni + 2 * hc;
  s.rk = s.stage + 3 * s.stage_slot;
  s.total = s.rk + 5 * tj * ti +
            2 * (tj * (ti + 1) + (tj + 1) * ti + 2 * tj * ti);
  return s;
}

// Shared-memory layout of one CUDA block of kernel E, which reads the
// primitives and bcc instead of computing them, in elements of the
// working type:
//   prim  [5 planes][8: w 0-4, bcc 5-7][prim_range]   copied with
//                                     cp.async three planes ahead of use
//   nf    [3 planes][b1 flux_range(0), b2 flux_range(1),
//                    b3 flux_range(2)]  the normal field of each face
//   f1, f2, f3, e1, e2, e3              as in stage_smem
//   u0    [2 planes][5][tj * ti]        the RK base u0, then the update
//   u1    [5][tj * ti]                  the RK register u1
//   rk    [b1, b1o tj * (ti + 1), b2, b2o (tj + 1) * ti,
//          b3, b3o 2 * tj * ti]         b and b_old of the tile's faces
// and, in static shared memory, `tables` ints: the offsets in a plane of
// what the copies read (the prim range, the normal field, the tile's
// cells, the rk slot's faces).
struct StageV1Smem {
  int prim, nf, nf_slot, f1, f2, f3, e1, e2, e3, u0, u1, rk, total, tables;
};

__host__ __device__ constexpr StageV1Smem stage_v1_smem(int tj, int ti) {
  const int hc = range_size(prim_range(tj, ti));
  const int n1f = range_size(flux_range(0, tj, ti));
  const int n2f = range_size(flux_range(1, tj, ti));
  const int n3f = range_size(flux_range(2, tj, ti));
  StageV1Smem s{};
  s.prim = 0;
  s.nf = s.prim + 5 * 8 * hc;
  s.nf_slot = n1f + n2f + n3f;
  s.f1 = s.nf + 3 * s.nf_slot;
  s.f2 = s.f1 + 2 * 7 * n1f;
  s.f3 = s.f2 + 2 * 7 * n2f;
  s.e1 = s.f3 + 2 * 7 * n3f;
  s.e2 = s.e1 + 2 * range_size(edge_range(0, tj, ti));
  s.e3 = s.e2 + 2 * range_size(edge_range(1, tj, ti));
  s.u0 = s.e3 + range_size(edge_range(2, tj, ti));
  s.u1 = s.u0 + 2 * 5 * tj * ti;
  s.rk = s.u1 + 5 * tj * ti;
  s.total = s.rk + 2 * (tj * (ti + 1) + (tj + 1) * ti + 2 * tj * ti);
  s.tables = hc + s.nf_slot + tj * ti +
             (tj * (ti + 1) + (tj + 1) * ti + 2 * tj * ti);
  return s;
}

// How a call is cut: nmb blocks of n3 x n2 x n1 cells with ng ghosts,
// ntj x nti tiles of tj x ti columns, nseg segments of seg planes.
struct TileGeom {
  int nmb, n3, n2, n1, ng;
  int tj, ti;
  int ntj, nti;
  int nseg, seg;
  long long blocks;
};

// The cells of one CUDA block: MeshBlock m, planes [k0, k1), rows
// [j0, j1) and columns [i0, i1); (j0, i0) is the tile's first cell and
// j1 - j0 <= tj, i1 - i0 <= ti (less on a ragged tile).
struct TileBox {
  int m, k0, k1, j0, j1, i0, i1;
};

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Chooses the number of k segments for `slots` blocks resident on the
// card at once: the fewest waves of blocks, each as short as it can be,
// by the cost model waves * (planes + 3) (a segment of s planes marches
// s + 4 steps, the first of which compute only primitives).
__host__ __device__ inline TileGeom tile_geom(int nmb, int n3, int n2,
                                              int n1, int ng, int tj, int ti,
                                              long long slots) {
  TileGeom g{};
  g.nmb = nmb;
  g.n3 = n3;
  g.n2 = n2;
  g.n1 = n1;
  g.ng = ng;
  g.tj = tj;
  g.ti = ti;
  g.ntj = ceil_div(n2 - 2 * ng, tj);
  g.nti = ceil_div(n1 - 2 * ng, ti);
  const int nx3 = n3 - 2 * ng;
  const long long cols = static_cast<long long>(nmb) * g.ntj * g.nti;
  long long best = -1;
  for (int nseg = 1; nseg <= nx3; ++nseg) {
    const int seg = ceil_div(nx3, nseg);
    if (ceil_div(nx3, seg) != nseg) continue;   // the same cut as fewer
    const long long blocks = cols * nseg;
    const long long waves = (blocks + slots - 1) / slots;
    const long long cost = waves * (seg + 3);
    if (best < 0 || cost < best) {
      best = cost;
      g.nseg = nseg;
      g.seg = seg;
    }
  }
  g.blocks = cols * g.nseg;
  return g;
}

__host__ __device__ inline TileBox tile_box(const TileGeom& g, long long b) {
  TileBox t;
  const int ti = static_cast<int>(b % g.nti);
  b /= g.nti;
  const int tj = static_cast<int>(b % g.ntj);
  b /= g.ntj;
  const int s = static_cast<int>(b % g.nseg);
  t.m = static_cast<int>(b / g.nseg);
  t.k0 = g.ng + s * g.seg;
  t.k1 = t.k0 + g.seg < g.n3 - g.ng ? t.k0 + g.seg : g.n3 - g.ng;
  t.j0 = g.ng + tj * g.tj;
  t.j1 = t.j0 + g.tj < g.n2 - g.ng ? t.j0 + g.tj : g.n2 - g.ng;
  t.i0 = g.ng + ti * g.ti;
  t.i1 = t.i0 + g.ti < g.n1 - g.ng ? t.i0 + g.ti : g.n1 - g.ng;
  return t;
}

}  // namespace athenak
