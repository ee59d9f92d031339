// Kernel D: Gardiner-Stone 2007 corner EMFs and the constrained-transport
// update of the three face fields.
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_ct3d.  From the cell
// velocities and field (w, bcc), the mass fluxes of the three directions
// (upwind selectors) and the six face EMFs it forms the corner EMFs e1,
// e2, e3 at the lower corner edges of every cell; under SR the cell
// velocities u^i are first divided by the Lorentz factor sqrt(1 + u^2)
// (reference: mhd_corner_e.cpp:136-143).  Then
// b' = gam0*b + gam1*b_old -/+ beta_dt * curl(e) on every face.  Plain
// version: ops/stage_split.py::fused_ct3d_plain (physics/mhd.py corner_e
// + ct_update).  Shifts wrap circularly as the plain version's torch.roll
// does, and the extra face of each normal axis takes the edge difference
// of index 0, as ct_update's _to_face does; those are ghosts, refilled by
// the fill.  Fresh outputs remove the TPU kernel's overlap hazard on b3
// (its plane windows overlap and it cannot alias b3,
// pallas_stage.py:520-525).
//
// What bounds it on the H100: the function must read three velocity
// channels of w, bcc, the three mass fluxes, the six face EMFs and the
// two sets of face fields (21 values a cell) and write the new face
// fields (3): 24 x 4 bytes a cell, 0.06 ms at 128^3 in float32 against
// 3.35 TB/s; its arithmetic (about 100 operations a cell) is far below
// the float32 peak, so memory binds.
//
// The first design took two launches, a thread an edge and then a thread
// a face, over flat 64-bit indices: the edges went through an edge
// scratch in device memory (3 values a cell written and read again), and
// each edge thread recomputed the cell EMFs of its four neighbouring
// cells, each with a square root and three divisions under SR (0.26 ms a
// call on the SR blast, PERF.md).  This design is one launch over a grid
// of tiles (ct_tile.cuh): a CUDA block owns a tile of TJ x TI columns of
// one MeshBlock and a segment of planes, and marches through them.  For
// every plane it copies the window of the 15 input channels (the tile
// and a halo of one cell below in j and i, wrapped) by cp.async into a
// ring of three planes, one plane ahead, with the face fields of the
// plane its faces will update; forms the cell EMFs of each window cell
// once, into a two-plane ring; then the edges of the plane into a second
// two-plane ring, from the cell EMFs, mass fluxes and face EMFs of this
// plane and the one below; then the new faces of the plane below, one
// face array at a time.  Every expression is the first design's,
// evaluated in the same order (built with --fmad=false), so every output
// is bitwise equal to it.  Offsets inside a MeshBlock are 32-bit, each
// thread's in-plane offsets computed once.
//
// Most dividends are zero (the EMFs and their differences vanish where
// the gas is at rest), and a zero dividend sends the division to its slow
// path: div_nz divides a nonzero stand-in instead (PERF.md).

#include "async_copy.cuh"
#include "common.cuh"
#include "ct_tile.cuh"
#include "stencil.cuh"

namespace athenak {
namespace {

template <typename T>
struct CtArgs {
  const T *w, *bcc;
  const T* f[9];  // mass fluxes x1, x2, x3; e3x1, e2x1, e1x2, e3x2, e2x3, e1x3
  const T* b[3];  // face fields x1f, x2f, x3f
  const T* bo[3];
  T* nb[3];
};

// The update's scalars and the cell sizes, each converted once to the
// working type as the first design converted them; the step is read
// from device memory (a 0-d tensor), once a thread.
template <typename T>
struct CtCoef {
  T gam0, gam1;
  const T* bdt;
  T dx1, dx2, dx3;
};

// a / b, bitwise, without the slow path of a zero dividend: for a = +-0
// the quotient is a * (1 / b), the signed zero (or the NaN) a / b gives.
template <typename T>
__device__ __forceinline__ T div_nz(T a, T b) {
  const T q = (a != T(0) ? a : T(1)) / b;
  return a != T(0) ? q : a * q;
}

// a face array as a type, for the face lambdas
template <int Q>
struct Arr {
  static constexpr int value = Q;
};

template <typename T, bool kSr, int TJ, int TI, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    fused_ct_kernel(CtArgs<T> a, FluxGeom geo, CtCoef<T> cf) {
  constexpr CtShape H = ct_shape(TJ, TI);
  constexpr int WI = H.wi, WC = H.wc, EI = H.ei, EC = H.ec, NF = H.nf;
  constexpr int RAW = CT_NCH * WC;  // one plane of the window ring
  static_assert(WC <= NT && H.nf1 <= NT && H.nf2 <= NT && H.nf3 <= NT,
                "one thread a window cell and a face of each array");
  const T bdt = __ldg(cf.bdt);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const raw = reinterpret_cast<T*>(smem_raw);  // [3][15][WC]
  T* const fst = raw + kCtRing * RAW;             // [2][2][NF]
  T* const ecc = fst + 4 * NF;                    // [2][3][WC]
  T* const edge = ecc + 6 * WC;                   // [2][3][EC]

  const FluxBox box = flux_box(geo, blockIdx.x, blockIdx.y, blockIdx.z);
  const int n3 = geo.n3, n2 = geo.n2, n1 = geo.n1;
  const int m = box.m, k0 = box.k0, k1 = box.k1, j0 = box.j0, i0 = box.i0;
  const int tid = threadIdx.x;
  const int plane = n2 * n1, ncell = n3 * plane;

  // this thread's window cell and, below the tile's last row and column
  // of it, its edge
  const bool win = tid < WC;
  const int wr = tid / WI, wc = tid % WI;
  const bool has_edge = win && wr >= 1 && wc >= 1;
  const int eidx = (wr - 1) * EI + (wc - 1);
  const int woff = ct_win(win ? tid : 0, WI, j0, i0, n2, n1);
  const T* const wm = a.w + static_cast<long long>(m) * 5 * ncell;
  const T* const bm = a.bcc + static_cast<long long>(m) * 3 * ncell;
  const long long mc = static_cast<long long>(m) * ncell;

  // face array Q: its work list's length and place in the staged fields,
  // its plane (x1f [n2][n1+1], x2f [n2+1][n1], x3f [n2][n1]) and the
  // offset of block m; this thread's face of it (item tid) and whether
  // the block writes that face
  constexpr int NF1 = H.nf1, NF2 = H.nf2, NF3 = H.nf3;
  auto nfq = [&](auto q) {
    constexpr int Q = decltype(q)::value;
    return Q == 0 ? NF1 : (Q == 1 ? NF2 : NF3);
  };
  auto baseq = [&](auto q) {
    constexpr int Q = decltype(q)::value;
    return Q == 0 ? 0 : (Q == 1 ? NF1 : NF1 + NF2);
  };
  auto fplane = [&](auto q) {
    constexpr int Q = decltype(q)::value;
    return Q == 0 ? n2 * (n1 + 1) : (Q == 1 ? (n2 + 1) * n1 : plane);
  };
  auto fblock = [&](auto q) {
    constexpr int Q = decltype(q)::value;
    return m * (static_cast<long long>(Q == 2 ? n3 + 1 : n3) * fplane(q));
  };
  auto mine = [&](auto q) {
    constexpr int Q = decltype(q)::value;
    return ct_face(Q, tid < nfq(q) ? tid : 0, TI);
  };
  auto owns = [&](auto q) {
    return tid < nfq(q) && ct_owns(mine(q), box, n2, n1);
  };
  const bool own[3] = {owns(Arr<0>()), owns(Arr<1>()), owns(Arr<2>())};
  const int foff[3] = {ct_face_off(mine(Arr<0>()), j0, i0, n1),
                       ct_face_off(mine(Arr<1>()), j0, i0, n1),
                       ct_face_off(mine(Arr<2>()), j0, i0, n1)};

  auto rslot = [&](int p) { return (p - k0 + 1) % kCtRing; };
  // the window of plane p (wrapped) into its ring slot
  auto load_raw = [&](int p) {
    if (!win) return;
    T* const dst = raw + rslot(p) * RAW + tid;
    const int off = split_cell(p, n3) * plane + woff;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cp_async<sizeof(T)>(dst + (CT_V1 + c) * WC, wm + (c + 1) * ncell + off);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      cp_async<sizeof(T)>(dst + (CT_B1 + c) * WC, bm + c * ncell + off);
#pragma unroll
    for (int c = 0; c < 9; ++c)
      cp_async<sizeof(T)>(dst + (CT_FD1 + c) * WC, a.f[c] + mc + off);
  };
  // b and b_old of this thread's face of each array in plane k
  auto load_faces = [&](int k) {
    T* const dst = fst + (k & 1) * 2 * NF + tid;
    auto one = [&](auto q) {
      constexpr int Q = decltype(q)::value;
      if (!own[Q]) return;
      const long long o = fblock(q) + k * fplane(q) + foff[Q];
      cp_async<sizeof(T)>(dst + baseq(q), a.b[Q] + o);
      cp_async<sizeof(T)>(dst + NF + baseq(q), a.bo[Q] + o);
    };
    one(Arr<0>());
    one(Arr<1>());
    one(Arr<2>());
  };
  // the new field of this thread's face of array Q in plane k, from b,
  // b_old and the edges of planes k and k+1 (slots by parity)
  auto face = [&](auto q, int k, T b, T bo) {
    constexpr int Q = decltype(q)::value;
    CtEdge rd[4];
    ct_face_edges(mine(q), EI, rd);
    auto E = [&](int s) {
      return edge[((k + rd[s].dk) & 1) * 3 * EC + rd[s].comp * EC +
                  rd[s].idx];
    };
    T v = cf.gam0 * b + cf.gam1 * bo;
    if constexpr (Q == 0) {
      v = v - bdt * div_nz(E(0) - E(1), cf.dx2);
      v = v + bdt * div_nz(E(2) - E(3), cf.dx3);
    } else if constexpr (Q == 1) {
      v = v + bdt * div_nz(E(0) - E(1), cf.dx1);
      v = v - bdt * div_nz(E(2) - E(3), cf.dx3);
    } else {
      v = v - bdt * div_nz(E(0) - E(1), cf.dx1);
      v = v + bdt * div_nz(E(2) - E(3), cf.dx2);
    }
    a.nb[Q][fblock(q) + k * fplane(q) + foff[Q]] = v;
  };
  auto faces = [&](auto q, int k) {
    constexpr int Q = decltype(q)::value;
    if (!own[Q]) return;
    const T* const fs = fst + (k & 1) * 2 * NF + baseq(q) + tid;
    face(q, k, fs[0], fs[NF]);
  };

  load_raw(k0 - 1);
  cp_async_commit();
  for (int p = k0 - 1; p <= k1; ++p) {
    // plane p and the faces of plane p-1 are in; every thread is done
    // with plane p-2's window and faces, so their slots take plane p+1
    // and the faces of plane p
    cp_async_wait<0>();
    __syncthreads();
    if (p + 1 <= k1) load_raw(p + 1);
    if (p >= k0 && p < k1) load_faces(p);
    cp_async_commit();
    if (win) {  // the cell EMFs E = -v x B of this window cell
      const T* const rw = raw + rslot(p) * RAW + tid;
      T vx = rw[CT_V1 * WC], vy = rw[CT_V2 * WC], vz = rw[CT_V3 * WC];
      if constexpr (kSr) {
        const T lor = sqrt(T(1) + vx * vx + vy * vy + vz * vz);
        vx = div_nz(vx, lor);
        vy = div_nz(vy, lor);
        vz = div_nz(vz, lor);
      }
      const T bx = rw[CT_B1 * WC], by = rw[CT_B2 * WC], bz = rw[CT_B3 * WC];
      T* const ce = ecc + (p & 1) * 3 * WC + tid;
      ce[0] = vz * by - vy * bz;
      ce[WC] = vx * bz - vz * bx;
      ce[2 * WC] = vy * bx - vx * by;
    }
    __syncthreads();
    if (p >= k0 && has_edge) {
      // window cell h, one row below (hj), one column below (hi), both
      const int h = tid, hj = h - WI, hi = h - 1, hji = h - WI - 1;
      const T* const r0 = raw + rslot(p) * RAW;
      const T* const r1 = raw + rslot(p - 1) * RAW;
      const T* const c0 = ecc + (p & 1) * 3 * WC;
      const T* const c1 = ecc + ((p - 1) & 1) * 3 * WC;
      auto R0 = [&](int ch, int x) { return r0[ch * WC + x]; };
      auto R1 = [&](int ch, int x) { return r1[ch * WC + x]; };
      // E1 along x1: a = x2 (e1x2), b = x3 (e1x3)
      const T e1 = gs07(c0[h], c0[hj], c1[h], c1[hj], R0(CT_E1X2, h),
                        R1(CT_E1X2, h), R0(CT_E1X3, h), R0(CT_E1X3, hj),
                        R0(CT_FD2, h), R1(CT_FD2, h), R0(CT_FD3, h),
                        R0(CT_FD3, hj));
      // E2 along x2: a = x3 (e2x3), b = x1 (e2x1)
      const T e2 = gs07(c0[WC + h], c1[WC + h], c0[WC + hi], c1[WC + hi],
                        R0(CT_E2X3, h), R0(CT_E2X3, hi), R0(CT_E2X1, h),
                        R1(CT_E2X1, h), R0(CT_FD3, h), R0(CT_FD3, hi),
                        R0(CT_FD1, h), R1(CT_FD1, h));
      // E3 along x3: a = x1 (e3x1), b = x2 (e3x2)
      const T e3 = gs07(c0[2 * WC + h], c0[2 * WC + hi], c0[2 * WC + hj],
                        c0[2 * WC + hji], R0(CT_E3X1, h), R0(CT_E3X1, hj),
                        R0(CT_E3X2, h), R0(CT_E3X2, hi), R0(CT_FD1, h),
                        R0(CT_FD1, hj), R0(CT_FD2, h), R0(CT_FD2, hi));
      T* const ed = edge + (p & 1) * 3 * EC + eidx;
      ed[0] = e1;
      ed[EC] = e2;
      ed[2 * EC] = e3;
    }
    __syncthreads();
    if (p > k0) {  // the faces of plane p-1
      faces(Arr<0>(), p - 1);
      faces(Arr<1>(), p - 1);
      faces(Arr<2>(), p - 1);
      // the extra x3 face k = n3 takes the edges of plane n3, plane 0's
      if (p == n3 && own[2]) {
        const long long o = fblock(Arr<2>()) + n3 * plane + foff[2];
        face(Arr<2>(), n3, __ldg(a.b[2] + o), __ldg(a.bo[2] + o));
      }
    }
  }
}

template <typename T, bool kSr>
int launch_kind(const CtArgs<T>& a, int nmb, int n3, int n2, int n1,
                const CtCoef<T>& cf, cudaStream_t s) {
  using S = CtTile<T>;
  auto kernel = fused_ct_kernel<T, kSr, S::TJ, S::TI, S::NT, S::MINB>;
  const size_t smem = static_cast<size_t>(ct_smem(S::TJ, S::TI)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // the blocks resident at once, for the cut of the planes into segments
  const long long tiles = static_cast<long long>(nmb) *
                          flux_ceil(n2, S::TJ) * flux_ceil(n1, S::TI);
  unsigned int slots = 0;
  err = wave_grid(kernel, S::NT, smem, tiles * n3, slots);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FluxGeom geo = ct_geom(nmb, n3, n2, n1, S::TJ, S::TI, slots);
  const dim3 grid(geo.ntj * geo.nti, geo.nseg, nmb);
  kernel<<<grid, S::NT, smem, s>>>(a, geo, cf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const CtArgs<T>& a, int nmb, int n3, int n2, int n1, bool is_sr,
           double gam0, double gam1, const T* beta_dt, double dx1, double dx2,
           double dx3, cudaStream_t s) {
  // offsets inside a MeshBlock's channel or face array are 32-bit
  if (static_cast<long long>(n3 + 1) * (n2 + 1) * (n1 + 1) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const CtCoef<T> cf{static_cast<T>(gam0), static_cast<T>(gam1),
                     beta_dt, static_cast<T>(dx1),
                     static_cast<T>(dx2), static_cast<T>(dx3)};
  return is_sr ? launch_kind<T, true>(a, nmb, n3, n2, n1, cf, s)
               : launch_kind<T, false>(a, nmb, n3, n2, n1, cf, s);
}

}  // namespace
}  // namespace athenak

#define ATHENAK_FUSED_CT_ENTRY(NAME, T)                                       \
  extern "C" int NAME(                                                        \
      const void* w, const void* bcc, const void* fd1, const void* fd2,       \
      const void* fd3, const void* e3x1, const void* e2x1, const void* e1x2,  \
      const void* e3x2, const void* e2x3, const void* e1x3, const void* b1,   \
      const void* b2, const void* b3, const void* b1o, const void* b2o,       \
      const void* b3o, void* nb1, void* nb2, void* nb3, int nmb, int n3,      \
      int n2, int n1, int is_sr, double gam0, double gam1,                    \
      const void* beta_dt,                                                    \
      double dx1, double dx2, double dx3, void* stream) {                     \
    using namespace athenak;                                                  \
    const CtArgs<T> a{                                                        \
        static_cast<const T*>(w),                                             \
        static_cast<const T*>(bcc),                                           \
        {static_cast<const T*>(fd1), static_cast<const T*>(fd2),              \
         static_cast<const T*>(fd3), static_cast<const T*>(e3x1),             \
         static_cast<const T*>(e2x1), static_cast<const T*>(e1x2),            \
         static_cast<const T*>(e3x2), static_cast<const T*>(e2x3),            \
         static_cast<const T*>(e1x3)},                                        \
        {static_cast<const T*>(b1), static_cast<const T*>(b2),                \
         static_cast<const T*>(b3)},                                          \
        {static_cast<const T*>(b1o), static_cast<const T*>(b2o),              \
         static_cast<const T*>(b3o)},                                         \
        {static_cast<T*>(nb1), static_cast<T*>(nb2), static_cast<T*>(nb3)}};  \
    return launch<T>(a, nmb, n3, n2, n1, is_sr != 0, gam0, gam1,              \
                     static_cast<const T*>(beta_dt),                          \
                     dx1, dx2, dx3, static_cast<cudaStream_t>(stream));       \
  }

ATHENAK_FUSED_CT_ENTRY(athenak_fused_ct_f32, float)
ATHENAK_FUSED_CT_ENTRY(athenak_fused_ct_f64, double)
