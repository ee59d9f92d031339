// Kernel H: one Z4c RK stage, u' = AlgConstr(gam0 u + gam1 u1 + bdt RHS(u)).
//
// Replaces athenak_tpu/ops/pallas_z4c.py::fused_z4c_stage (the Pallas
// call at pallas_z4c.py:588).  RHS is z4c/rhs_core.py (reference:
// Z4c::CalcRHS, z4c_calcrhs.cpp:180-590): first, second, mixed,
// advective and Kreiss-Oliger finite differences, Christoffels, the
// conformal Ricci, the conformal-factor and lapse pieces, gauge,
// constraint damping and the Sommerfeld rows on the outermost active
// layer of outflow faces; AlgConstr (z4c.py:279-295) projects to
// det(conformal g) = 1 and tr A = 0 and applies the chi floor.
//
// With the matter source (the instances with MAT, the branch of
// pallas_z4c.py:384 that takes tmunu, stacked at :432-436): the ten
// stress-energy channels (E, S_d, S_dd; undensitised, cell-centred, as
// DynGRMHD.set_tmunu returns them) are read pointwise at the cell, one
// load each in the algebra, and their terms (rhs_core.py:274-298) are
// added to Khat, Theta, Gam^a and A_ab after the gauge and before the
// Sommerfeld rows and the Kreiss-Oliger term, in rhs_core's order.  They
// need no stencil, so the derivative pass, the window and the shared
// memory are the vacuum kernel's; the vacuum instances read no matter.
//
// What bounds it on the H100: operations and memory alike.
// tests/test_torch_z4c_host.py counts 5,563 operations a cell at
// nghost 2 and 7,471 at nghost 3 (chip_smoke.py Z4C_OPS): at 60^3,
// 0.018 ms at the float32 peak of 67 TFLOP/s; u with its stencils'
// ghost slabs, u1, u' and the Sommerfeld geometry, some 72 values a
// cell, take 0.0185 ms against 3.35 TB/s (chip_smoke.py z4c_bound).
// With --fmad=false no multiply and add fuse, so the card reaches half
// the peak at best.
//
// The first design, one thread a cell reading some 900 stencil values
// through L1 with 64-bit addresses, ran at 255 registers with spills and
// 8 warps an SM: 0.27 ms at 60^3 nghost 2 and 0.49 at 64^3 nghost 3 on
// an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).  This design takes the
// derivatives apart from the algebra (z4c_tile.cuh: the box, the window,
// the buffer):
//   1. a CUDA block owns a box of interior cells, one thread a cell, and
//      walks the 22 channels; each channel's window (the box and NG
//      cells around it) is copied by cp.async into one of NSLOT slots
//      of shared memory while the channels before it are differenced,
//      each thread copying from offsets it computed once;
//   2. every stencil read then comes from shared memory at an offset
//      fixed at compile time; for the 11 channels with mixed second
//      derivatives the inner first derivative is computed once a point
//      (z4c_inner) and serves every mixed pair and every cell;
//   3. each thread writes its cell's derivatives of the channel to its
//      own column of a buffer in shared memory (z4c_derivs); the second
//      derivatives of the metric and the shift go in as the sums the
//      algebra takes of them, which cuts the buffer from 191 values a
//      cell to 116 and lets three blocks share an SM in float32;
//   4. the pointwise algebra (z4c_rhs, the RK combine, AlgConstr) runs
//      from that column, the centred values from u, with no stencil
//      loads among its arithmetic.
// In float32 the instances take 161 registers and no local memory (the
// sym_idx helper S is written without recursion: nvcc left the
// recursive form as a loop and indexed the arrays it fed in local
// memory).
//
// Every sum keeps rhs_core's order, term by term, and every Python float
// meets the tensor as the working type (the scalars of Z4cPrm), so with
// --fmad=false the kernel rounds as the plain torch version does; only
// pow and cbrt (for which torch has x ** (1/3)) may differ by an ulp.
// Each derivative and each sum is the same expression on the same
// values as in the first design, so the results are bitwise equal to
// it.  Ghost cells of
// the output are not written; the ghost fill that follows every stage
// fills them.
#pragma once

#include "z4c_stage.cuh"
#include "z4c_tile.cuh"
#ifdef __CUDACC__
#include "async_copy.cuh"
#endif

namespace athenak {

// Channel indices (z4c.py, reference: z4c.hpp:46-56)
constexpr int I_CHI = 0, I_GXX = 1, I_KHAT = 7, I_AXX = 8, I_GAMX = 14,
              I_THETA = 17, I_ALPHA = 18, I_BETAX = 19;

// sym_idx: the position of (a, b) among xx, xy, xz, yy, yz, zz.  Not
// recursive: nvcc left the recursive form as a loop, and the arrays it
// indexed in local memory.
__host__ __device__ constexpr int S(int a, int b) {
  return a <= b ? (a == 0 ? b : (a == 1 ? 2 + b : 5))
                : (b == 0 ? a : (b == 1 ? 2 + a : 5));
}

// Stencil tables of z4c/fd.py, one row per nghost 2..5 (tests hold the
// two equal).  Offsets follow from the row: D1 takes -(ng-1)..-1,
// 1..ng-1; D2 -(ng-1)..ng-1; ADV_L -ng..ng-2 (ADV_R is term q of ADV_L
// with offset and coefficient negated); DISS -ng..ng.
#define Z4C_D1_TAB                                                        \
  {-1.0 / 2.0, 1.0 / 2.0},                                                \
      {1.0 / 12.0, -2.0 / 3.0, 2.0 / 3.0, -1.0 / 12.0},                   \
      {-1.0 / 60.0, 3.0 / 20.0, -3.0 / 4.0, 3.0 / 4.0, -3.0 / 20.0,       \
       1.0 / 60.0},                                                       \
      {1.0 / 280.0, -4.0 / 105.0, 1.0 / 5.0, -4.0 / 5.0, 4.0 / 5.0,       \
       -1.0 / 5.0, 4.0 / 105.0, -1.0 / 280.0}
#define Z4C_D2_TAB                                                        \
  {1.0, -2.0, 1.0},                                                       \
      {-1.0 / 12.0, 4.0 / 3.0, -5.0 / 2.0, 4.0 / 3.0, -1.0 / 12.0},       \
      {1.0 / 90.0, -3.0 / 20.0, 3.0 / 2.0, -49.0 / 18.0, 3.0 / 2.0,       \
       -3.0 / 20.0, 1.0 / 90.0},                                          \
      {-1.0 / 560.0, 8.0 / 315.0, -1.0 / 5.0, 8.0 / 5.0, -205.0 / 72.0,   \
       8.0 / 5.0, -1.0 / 5.0, 8.0 / 315.0, -1.0 / 560.0}
#define Z4C_ADV_TAB                                                       \
  {0.5, -2.0, 1.5},                                                       \
      {-1.0 / 12.0, 6.0 / 12.0, -18.0 / 12.0, 10.0 / 12.0, 3.0 / 12.0},   \
      {1.0 / 60.0, -2.0 / 15.0, 1.0 / 2.0, -4.0 / 3.0, 7.0 / 12.0,        \
       2.0 / 5.0, -1.0 / 30.0},                                           \
      {-1.0 / 280.0, 1.0 / 28.0, -1.0 / 6.0, 1.0 / 2.0, -5.0 / 4.0,       \
       9.0 / 20.0, 1.0 / 2.0, -1.0 / 14.0, 1.0 / 168.0}
#define Z4C_DISS_TAB                                                      \
  {1.0, -4.0, 6.0, -4.0, 1.0}, {1.0, -6.0, 15.0, -20.0, 15.0, -6.0, 1.0}, \
      {1.0, -8.0, 28.0, -56.0, 70.0, -56.0, 28.0, -8.0, 1.0},             \
      {1.0, -10.0, 45.0, -120.0, 210.0, -252.0, 210.0, -120.0, 45.0,      \
       -10.0, 1.0}

// Each table in float and in double: a coefficient is a constant-bank
// operand of the multiply, rounded once to the working type.  Internal
// linkage: every instance file holds its own copy.
namespace {
__constant__ float kD1f[4][8] = {Z4C_D1_TAB};
__constant__ double kD1d[4][8] = {Z4C_D1_TAB};
__constant__ float kD2f[4][9] = {Z4C_D2_TAB};
__constant__ double kD2d[4][9] = {Z4C_D2_TAB};
__constant__ float kAdvf[4][9] = {Z4C_ADV_TAB};
__constant__ double kAdvd[4][9] = {Z4C_ADV_TAB};
__constant__ float kDissf[4][11] = {Z4C_DISS_TAB};
__constant__ double kDissd[4][11] = {Z4C_DISS_TAB};
}  // namespace

__device__ __forceinline__ float cD1(float, int ng, int q) {
  return kD1f[ng - 2][q];
}
__device__ __forceinline__ double cD1(double, int ng, int q) {
  return kD1d[ng - 2][q];
}
__device__ __forceinline__ float cD2(float, int ng, int q) {
  return kD2f[ng - 2][q];
}
__device__ __forceinline__ double cD2(double, int ng, int q) {
  return kD2d[ng - 2][q];
}
__device__ __forceinline__ float cAdv(float, int ng, int q) {
  return kAdvf[ng - 2][q];
}
__device__ __forceinline__ double cAdv(double, int ng, int q) {
  return kAdvd[ng - 2][q];
}
__device__ __forceinline__ float cDiss(float, int ng, int q) {
  return kDissf[ng - 2][q];
}
__device__ __forceinline__ double cDiss(double, int ng, int q) {
  return kDissd[ng - 2][q];
}

__host__ __device__ constexpr int d1_off(int ng, int q) {
  return q < ng - 1 ? q - (ng - 1) : q - (ng - 1) + 1;
}

// Finite differences along one axis at one point: fd.py's _apply, term
// by term in table order, then the 1/dx factor.  p points at the point;
// st is the axis's stride.  P is a pointer (or, in the CPU tests, a type
// that checks each read).
template <typename T, int NG, class P>
__device__ __forceinline__ T d1_line(const P& p, int st, T id) {
  T o = cD1(T(), NG, 0) * p[d1_off(NG, 0) * st];
#pragma unroll
  for (int q = 1; q < 2 * NG - 2; ++q)
    o = o + cD1(T(), NG, q) * p[d1_off(NG, q) * st];
  return o * id;
}

template <typename T, int NG, class P>
__device__ __forceinline__ T d2_line(const P& p, int st, T id2) {
  T o = cD2(T(), NG, 0) * p[(0 - (NG - 1)) * st];
#pragma unroll
  for (int q = 1; q < 2 * NG - 1; ++q)
    o = o + cD2(T(), NG, q) * p[(q - (NG - 1)) * st];
  return o * id2;
}

// fd.adv: b * dl where b < 0, else b * dr
template <typename T, int NG, class P>
__device__ __forceinline__ T adv_line(const P& p, int st, T id, T b) {
  if (b < T(0)) {
    T o = cAdv(T(), NG, 0) * p[(0 - NG) * st];
#pragma unroll
    for (int q = 1; q < 2 * NG - 1; ++q)
      o = o + cAdv(T(), NG, q) * p[(q - NG) * st];
    return b * (o * id);
  }
  T o = -cAdv(T(), NG, 0) * p[NG * st];
#pragma unroll
  for (int q = 1; q < 2 * NG - 1; ++q)
    o = o + -cAdv(T(), NG, q) * p[(NG - q) * st];
  return b * (o * id);
}

template <typename T, int NG, class P>
__device__ __forceinline__ T ko_line(const P& p, int st, T id) {
  T o = cDiss(T(), NG, 0) * p[(0 - NG) * st];
#pragma unroll
  for (int q = 1; q < 2 * NG + 1; ++q)
    o = o + cDiss(T(), NG, q) * p[(q - NG) * st];
  return o * id;
}

// fd.d1(f, d, idx, 2): the 2nd-order first derivative (Sommerfeld)
template <typename T, class P>
__device__ __forceinline__ T d1o2_line(const P& p, int st, T id) {
  T o = T(-1.0 / 2.0) * p[-st];
  o = o + T(1.0 / 2.0) * p[st];
  return o * id;
}

// The Sommerfeld geometry of a cell of the mask: 1/r's r and the unit
// radial vector (sbc channels 1-4); `on` is false off the mask.
template <typename T>
struct Z4cSomm {
  bool on;
  T rad, s_u[3];
};

// Point p of the inner pass of a channel with mixed derivatives: the x
// (d1x) or y (d1y) first derivative at a window cell, the inner
// derivative of fd.d1d1.
template <typename T, class Sh, class P, class Q>
__device__ __forceinline__ void z4c_inner(int p, const P& win, Q d1x, Q d1y,
                                          const Z4cPrm<T>& Pm) {
  const Z4cInner q = z4c_inner_point<Sh>(p);
  if (q.d == 0)
    d1x[q.dst] = d1_line<T, Sh::NG>(win + q.win, 1, Pm.idx[0]);
  else
    d1y[q.dst] = d1_line<T, Sh::NG>(win + q.win, Sh::WX, Pm.idx[1]);
}

template <typename T>
__device__ __forceinline__ T spatial_det(const T g[3][3]) {
  return (g[0][0] * (g[1][1] * g[2][2] - g[1][2] * g[1][2]) -
          g[0][1] * (g[0][1] * g[2][2] - g[0][2] * g[1][2])) +
         g[0][2] * (g[0][1] * g[1][2] - g[0][2] * g[1][1]);
}

// z4c.py spatial_inv without the factor 1/detg (the caller multiplies,
// or detg is 1 and the factor exact)
template <typename T>
__device__ __forceinline__ void adjugate(const T g[3][3], T gu[3][3]) {
  gu[0][0] = g[1][1] * g[2][2] - g[1][2] * g[1][2];
  gu[0][1] = g[0][2] * g[1][2] - g[0][1] * g[2][2];
  gu[0][2] = g[0][1] * g[1][2] - g[0][2] * g[1][1];
  gu[1][1] = g[0][0] * g[2][2] - g[0][2] * g[0][2];
  gu[1][2] = g[0][1] * g[0][2] - g[0][0] * g[1][2];
  gu[2][2] = g[0][0] * g[1][1] - g[0][1] * g[0][1];
  gu[1][0] = gu[0][1];
  gu[2][0] = gu[0][2];
  gu[2][1] = gu[1][2];
}

// The inverse conformal metric (z4c.py spatial_inv) from the metric at
// the cell, computed once for the derivative sums and the algebra.
template <typename T>
__device__ __forceinline__ void z4c_inverse_metric(const T g[3][3],
                                                   T gu[3][3]) {
  const T detg = spatial_det(g);
  const T i = T(1) / detg;
  adjugate(g, gu);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      gu[a][b] = gu[a][b] * i;
      gu[b][a] = gu[a][b];
    }
}

// The derivatives of channel c at one cell into its buffer column b
// (stride Sh::NC): w is the window at the cell, dx and dy the inner
// pass's d1x and d1y at the cell (read for the channels with mixed
// derivatives only), beta the shift and gu the inverse metric at the
// cell.  The second derivatives of the metric and the shift go into the
// sums the algebra takes of them, each the algebra's expression in its
// order; the shift's channels come in the order of those sums' terms.
template <typename T, class Sh, class P, class Q>
__device__ __forceinline__ void z4c_derivs(int c, const P& w, const Q& dx,
                                           const Q& dy, const Z4cPrm<T>& Pm,
                                           const T beta[3], const T gu[3][3],
                                           const Z4cSomm<T>& sb, T* b) {
  constexpr int NG = Sh::NG, NC = Sh::NC;
  constexpr int SY = Sh::WX, SZ = Sh::WX * Sh::WY;
  const int r1 = z4c_d1_row(c);
  if (z4c_mixed(c)) {
    // along x and y the inner pass's values, the same expression
    T* d1 = b + (kZ4cD1 + 3 * r1) * NC;
    d1[0] = dx[0];
    d1[NC] = dy[0];
    d1[2 * NC] = d1_line<T, NG>(w, SZ, Pm.idx[2]);
    // fd.d1d1 with the inner derivative along the lower direction
    T dd[6];
    dd[S(0, 0)] = d2_line<T, NG>(w, 1, Pm.idx2[0]);
    dd[S(0, 1)] = d1_line<T, NG>(dx, Sh::TX, Pm.idx[1]);
    dd[S(0, 2)] = d1_line<T, NG>(dx, Sh::DY * Sh::TX, Pm.idx[2]);
    dd[S(1, 1)] = d2_line<T, NG>(w, SY, Pm.idx2[1]);
    dd[S(1, 2)] = d1_line<T, NG>(dy, Sh::TY * Sh::TX, Pm.idx[2]);
    dd[S(2, 2)] = d2_line<T, NG>(w, SZ, Pm.idx2[2]);
    if (c == I_CHI || c == I_ALPHA) {
      T* const o = b + (c == I_CHI ? kZ4cDDChi : kZ4cDDAlpha) * NC;
#pragma unroll
      for (int q = 0; q < 6; ++q) o[q * NC] = dd[q];
    } else if (c < I_KHAT) {
      // the conformal Ricci's 0.5 gu^cd DDg_ab,cd for g_ab, ab = c - 1
      T s = T(0);
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const T t = (T(0.5) * gu[q / 3][q % 3]) * dd[S(q / 3, q % 3)];
        s = q == 0 ? t : s + t;
      }
      b[(kZ4cDDg + c - I_GXX) * NC] = s;
    } else {
      // beta^e: its term of (1/3) D_a D_b beta^b for each a, and
      // gu^bc D_b D_c beta^e
      const int e = c - I_BETAX;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const T t = T(1.0 / 3.0) * (e == 0   ? dd[S(a, 0)]
                                    : e == 1 ? dd[S(a, 1)]
                                             : dd[S(a, 2)]);
        T* const o = b + (kZ4cDDbd + a) * NC;
        *o = e == 0 ? t : *o + t;
      }
      T s = T(0);
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const T t = gu[q / 3][q % 3] * dd[S(q / 3, q % 3)];
        s = q == 0 ? t : s + t;
      }
      b[(kZ4cDDbs + e) * NC] = s;
    }
  } else if (r1 >= 0) {
    T* d1 = b + (kZ4cD1 + 3 * r1) * NC;
    d1[0] = d1_line<T, NG>(w, 1, Pm.idx[0]);
    d1[NC] = d1_line<T, NG>(w, SY, Pm.idx[1]);
    d1[2 * NC] = d1_line<T, NG>(w, SZ, Pm.idx[2]);
  }
  // fd.ladv
  T o = adv_line<T, NG>(w, 1, Pm.idx[0], beta[0]);
  o = o + adv_line<T, NG>(w, SY, Pm.idx[1], beta[1]);
  o = o + adv_line<T, NG>(w, SZ, Pm.idx[2], beta[2]);
  // fd.ko
  if (Pm.have_ko) {
    T k = ko_line<T, NG>(w, 1, Pm.idx[0]);
    k = k + ko_line<T, NG>(w, SY, Pm.idx[1]);
    k = k + ko_line<T, NG>(w, SZ, Pm.idx[2]);
    b[(kZ4cKo + c) * NC] = k;
  }
  // the Sommerfeld radiative RHS (reference: Z4cSommerfeld,
  // z4c_Sbc.cpp:25-122; 2nd-order derivatives), Khat at speed sqrt(2).
  // It replaces the channel's RHS on the mask, so it takes the slot of
  // the advective term, which only that RHS reads.
  if (z4c_somm(c) && sb.on) {
    const T speed = c == I_KHAT ? T(1.4142135623730951) : T(1);
    T s = (-speed * w[0]) / sb.rad;
    s = s - (speed * sb.s_u[0]) * d1o2_line<T>(w, 1, Pm.idx[0]);
    s = s - (speed * sb.s_u[1]) * d1o2_line<T>(w, SY, Pm.idx[1]);
    s = s - (speed * sb.s_u[2]) * d1o2_line<T>(w, SZ, Pm.idx[2]);
    o = s;
  }
  b[(kZ4cLadv + c) * NC] = o;
}

// A cell's buffer column and its centred values in u, read by the
// algebra.
template <typename T, int NC>
struct Z4cCell {
  const T* b;
  const T* __restrict__ u;  // u at the cell, channel 0
  long long cs;             // u's channel stride
  bool somm;                // the cell is on the Sommerfeld mask
  // the stress-energy at the cell, channel 0 (channel stride cs); read
  // only by the instances with the matter source
  const T* __restrict__ m = nullptr;

  __device__ __forceinline__ T v(int c) const { return __ldg(u + c * cs); }
  __device__ __forceinline__ T mat(int c) const {
    return __ldg(m + c * cs);
  }
  __device__ __forceinline__ T d1(int c, int d) const {
    return b[(kZ4cD1 + 3 * z4c_d1_row(c) + d) * NC];
  }
  // the backend's d2(f, a, b) of chi and alpha: centred on one axis,
  // else nested
  __device__ __forceinline__ T dd(int c, int a, int d) const {
    return b[((c == I_CHI ? kZ4cDDChi : kZ4cDDAlpha) + S(a, d)) * NC];
  }
  __device__ __forceinline__ T ricci_dd(int a, int d) const {
    return b[(kZ4cDDg + S(a, d)) * NC];
  }
  __device__ __forceinline__ T ddbeta_d(int a) const {
    return b[(kZ4cDDbd + a) * NC];
  }
  __device__ __forceinline__ T ddbeta_s(int a) const {
    return b[(kZ4cDDbs + a) * NC];
  }
  __device__ __forceinline__ T ladv(int c) const {
    return b[(kZ4cLadv + c) * NC];
  }
  __device__ __forceinline__ T ko(int c) const { return b[(kZ4cKo + c) * NC]; }
  __device__ __forceinline__ T somm_rhs(int c) const { return ladv(c); }
};

// rhs_core.rhs_core at one cell from its buffer column and the inverse
// metric gu, into r[22]; MAT adds the matter source (F.mat)
template <typename T, bool MAT, class D>
__device__ __forceinline__ void z4c_rhs(const D& F, const Z4cPrm<T>& P,
                                        const T gu[3][3], T r[kNZ4C]) {
  // centred values
  const T chi = F.v(I_CHI), khat = F.v(I_KHAT);
  const T theta = F.v(I_THETA), alpha = F.v(I_ALPHA);
  T g[3][3], A[3][3], gam[3], beta[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    gam[a] = F.v(I_GAMX + a);
    beta[a] = F.v(I_BETAX + a);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      g[a][b] = F.v(I_GXX + S(a, b));
      A[a][b] = F.v(I_AXX + S(a, b));
    }
  }

  // first derivatives ([d][a]: direction first)
  T dalpha[3], dchi[3], dkhat[3], dtheta[3], dbeta[3][3], dgam[3][3];
  T dg[3][3][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    dalpha[d] = F.d1(I_ALPHA, d);
    dchi[d] = F.d1(I_CHI, d);
    dkhat[d] = F.d1(I_KHAT, d);
    dtheta[d] = F.d1(I_THETA, d);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dbeta[d][a] = F.d1(I_BETAX + a, d);
      dgam[d][a] = F.d1(I_GAMX + a, d);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b) {
        dg[d][a][b] = F.d1(I_GXX + S(a, b), d);
        dg[d][b][a] = dg[d][a][b];
      }
  }

  const T K = khat + T(2) * theta;

  // Christoffels of the conformal metric: Gddd[c][a][b], Gudd[c][a][b]
  T Gddd[3][3][3], Gudd[3][3][3], gam_c[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b)
        Gddd[c][a][b] =
            T(0.5) * ((dg[a][b][c] + dg[b][a][c]) - dg[c][a][b]);
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        T s = gu[c][0] * Gddd[0][a][b];
        s = s + gu[c][1] * Gddd[1][a][b];
        s = s + gu[c][2] * Gddd[2][a][b];
        Gudd[c][a][b] = s;
      }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T s = gu[0][0] * Gudd[a][0][0];
#pragma unroll
    for (int q = 1; q < 9; ++q) s = s + gu[q / 3][q % 3] * Gudd[a][q / 3][q % 3];
    gam_c[a] = s;
  }

  // conformal Ricci (reference: z4c_calcrhs.cpp:305-328)
  T Rdd[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      T rr = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T t = T(0.5) * ((g[c][a] * dgam[b][c] + g[c][b] * dgam[a][c]) +
                              gam_c[c] * (Gddd[a][b][c] + Gddd[b][a][c]));
        rr = c == 0 ? t : rr + t;
      }
      // 0.5 gu^cd DDg_ab,cd, formed by z4c_derivs
      rr = rr - F.ricci_dd(a, b);
      T s = T(0);
#pragma unroll
      for (int q = 0; q < 27; ++q) {
        const int c = q / 9, d = (q / 3) % 3, e = q % 3;
        const T t = gu[c][d] * ((Gudd[e][c][a] * Gddd[b][e][d] +
                                 Gudd[e][c][b] * Gddd[a][e][d]) +
                                Gudd[e][a][d] * Gddd[e][c][b]);
        s = q == 0 ? t : s + t;
      }
      rr = rr + s;
      Rdd[a][b] = rr;
      Rdd[b][a] = rr;
    }

  // conformal-factor pieces (reference: z4c_calcrhs.cpp:329-356)
  const T chi_g = tmax(chi, P.chi_div_floor);
  const T oopsi4 = P.one_pow ? chi_g : tpow(chi_g, P.oopsi4_pow);
  const T npow = P.npow;
  T dphi[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) dphi[a] = dchi[a] / (chi_g * npow);
  T Ddphi[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      T s = Gudd[0][a][b] * dphi[0];
      s = s + Gudd[1][a][b] * dphi[1];
      s = s + Gudd[2][a][b] * dphi[2];
      const T v = (F.dd(I_CHI, a, b) / (chi_g * npow) -
                   (npow * dphi[a]) * dphi[b]) -
                  s;
      Ddphi[a][b] = v;
      Ddphi[b][a] = v;
    }
  T trDdphi = T(0);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int c = q / 3, d = q % 3;
    const T t = gu[c][d] * (Ddphi[c][d] + (T(2) * dphi[c]) * dphi[d]);
    trDdphi = q == 0 ? t : trDdphi + t;
  }
  T Rphi[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      const T v = ((T(4) * dphi[a]) * dphi[b] - T(2) * Ddphi[a][b]) -
                  (T(2) * g[a][b]) * trDdphi;
      Rphi[a][b] = v;
      Rphi[b][a] = v;
    }

  // second covariant derivative of the lapse
  // (reference: z4c_calcrhs.cpp:370-388)
  T dphidalpha = T(0);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int c = q / 3, d = q % 3;
    const T t = (gu[c][d] * dphi[c]) * dalpha[d];
    dphidalpha = q == 0 ? t : dphidalpha + t;
  }
  T Ddalpha_dd[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      T s = Gudd[0][a][b] * dalpha[0];
      s = s + Gudd[1][a][b] * dalpha[1];
      s = s + Gudd[2][a][b] * dalpha[2];
      const T v = ((F.dd(I_ALPHA, a, b) -
                    T(2) * (dphi[a] * dalpha[b] + dphi[b] * dalpha[a])) -
                   s) +
                  (T(2) * g[a][b]) * dphidalpha;
      Ddalpha_dd[a][b] = v;
      Ddalpha_dd[b][a] = v;
    }
  T Ddalpha = T(0);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int a = q / 3, b = q % 3;
    const T t = (oopsi4 * gu[a][b]) * Ddalpha_dd[a][b];
    Ddalpha = q == 0 ? t : Ddalpha + t;
  }

  // A contractions (reference: z4c_calcrhs.cpp:392-420)
  T AA_dd[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      T s = T(0);
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int c = q / 3, d = q % 3;
        const T t = (gu[c][d] * A[a][c]) * A[d][b];
        s = q == 0 ? t : s + t;
      }
      AA_dd[a][b] = s;
      AA_dd[b][a] = s;
    }
  T AA = T(0);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const T t = gu[q / 3][q % 3] * AA_dd[q / 3][q % 3];
    AA = q == 0 ? t : AA + t;
  }
  T Auu[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      T s = T(0);
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int c = q / 3, d = q % 3;
        const T t = (gu[a][c] * gu[b][d]) * A[c][d];
        s = q == 0 ? t : s + t;
      }
      Auu[a][b] = s;
    }
  T DA_u[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T v = T(0);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const T t = ((T(-1.5) * Auu[a][b]) * dchi[b]) / chi_g -
                  (T(1.0 / 3.0) * gu[a][b]) * (T(2) * dkhat[b] + dtheta[b]);
      v = b == 0 ? t : v + t;
    }
    T s = T(0);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int b = q / 3, c = q % 3;
      const T t = Gudd[a][b][c] * Auu[b][c];
      s = q == 0 ? t : s + t;
    }
    DA_u[a] = v + s;
  }

  // Ricci scalar + Hamiltonian (vacuum)
  T R = T(0);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const int a = q / 3, b = q % 3;
    const T t = (oopsi4 * gu[a][b]) * (Rdd[a][b] + Rphi[a][b]);
    R = q == 0 ? t : R + t;
  }
  const T Ht = (R + (T(2.0 / 3.0) * K) * K) - AA;

  // shift contractions (reference: z4c_calcrhs.cpp:438-480)
  const T divbeta = (dbeta[0][0] + dbeta[1][1]) + dbeta[2][2];
  // (1/3) D_a D_b beta^b, formed by z4c_derivs
  T ddbeta_d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) ddbeta_d[a] = F.ddbeta_d(a);

  const T Lchi = F.ladv(I_CHI) + (P.c6n * chi_g) * divbeta;

  // ------------------------------------------------------------ assemble
  r[I_KHAT] = ((-Ddalpha + alpha * (AA + (T(1.0 / 3.0) * K) * K)) +
               F.ladv(I_KHAT)) +
              (P.k1f * alpha) * theta;
  r[I_CHI] = Lchi - ((P.c6n * chi_g) * alpha) * K;
  r[I_THETA] = P.use_z4c * (F.ladv(I_THETA) +
                            alpha * (T(0.5) * Ht - P.k2f * theta));

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T s1 = T(0);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const T t = gu[a][b] * ddbeta_d[b] - gam_c[b] * dbeta[b][a];
      s1 = b == 0 ? t : s1 + t;
    }
    const T s2 = F.ddbeta_s(a);  // gu^bc D_b D_c beta^a, z4c_derivs'
    const T Lgam = ((F.ladv(I_GAMX + a) +
                     (T(2.0 / 3.0) * gam_c[a]) * divbeta) +
                    s1) +
                   s2;
    T s3 = T(0);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const T t = (T(2) * Auu[a][b]) * dalpha[b];
      s3 = b == 0 ? t : s3 + t;
    }
    r[I_GAMX + a] = (((T(2) * alpha) * DA_u[a] + Lgam) -
                     ((T(2) * alpha) * P.k1) * (gam[a] - gam_c[a])) -
                    s3;
  }

#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      T sg = T(0), sa = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T tg = dbeta[a][c] * g[b][c] + dbeta[b][c] * g[a][c];
        const T ta = dbeta[b][c] * A[a][c] + dbeta[a][c] * A[b][c];
        sg = c == 0 ? tg : sg + tg;
        sa = c == 0 ? ta : sa + ta;
      }
      const T Lg = (F.ladv(I_GXX + S(a, b)) -
                    (T(2.0 / 3.0) * g[a][b]) * divbeta) +
                   sg;
      const T LA = (F.ladv(I_AXX + S(a, b)) -
                    (T(2.0 / 3.0) * A[a][b]) * divbeta) +
                   sa;
      r[I_GXX + S(a, b)] = (T(-2) * alpha) * A[a][b] + Lg;
      r[I_AXX + S(a, b)] =
          ((oopsi4 * (-Ddalpha_dd[a][b] + alpha * (Rdd[a][b] + Rphi[a][b])) -
            (T(1.0 / 3.0) * g[a][b]) * (-Ddalpha + alpha * R)) +
           alpha * (K * A[a][b] - T(2) * AA_dd[a][b])) +
          LA;
    }

  // gauge (reference: z4c_calcrhs.cpp:536-567)
  const T f = P.f0 + P.lapse_harmonic * alpha;
  r[I_ALPHA] = P.lapse_advect * F.ladv(I_ALPHA) - (f * alpha) * khat;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T v = ((P.shift_ggamma * gam[a] +
            P.shift_advect * F.ladv(I_BETAX + a)) -
           P.shift_eta * beta[a]) +
          ((P.shift_alpha2ggamma * alpha) * alpha) * gam[a];
    if (P.have_hh) {
      T s = T(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T t = (((P.shift_hh * alpha) * chi_g) *
                     ((T(0.5) * alpha) * dchi[b] - dalpha[b])) *
                    gu[a][b];
        s = b == 0 ? t : s + t;
      }
      v = v + s;
    }
    r[I_BETAX + a] = v;
  }

  // matter coupling (reference: z4c_calcrhs.cpp:364, 490-532): each
  // term as rhs_core writes it, 4 pi as the double 4.0 * math.pi and its
  // multiples (2.0 * fourpi, 4.0 * fourpi: exact) met in the working
  // type
  if constexpr (MAT) {
    const T fourpi = T(12.566370614359172);
    const T eightpi = T(25.132741228718345);
    const T sixteenpi = T(50.26548245743669);
    const T E = F.mat(0);
    T Sd[3], Sdd[6];
#pragma unroll
    for (int a = 0; a < 3; ++a) Sd[a] = F.mat(1 + a);
#pragma unroll
    for (int q = 0; q < 6; ++q) Sdd[q] = F.mat(4 + q);
    T Sm = T(0);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const T t = gu[q / 3][q % 3] * Sdd[S(q / 3, q % 3)];
      Sm = q == 0 ? t : Sm + t;
    }
    Sm = oopsi4 * Sm;
    r[I_KHAT] = r[I_KHAT] + (fourpi * alpha) * (Sm + E);
    r[I_THETA] = r[I_THETA] - ((eightpi * alpha) * E) * P.use_z4c;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T s = T(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const T t = gu[a][b] * Sd[b];
        s = b == 0 ? t : s + t;
      }
      r[I_GAMX + a] = r[I_GAMX + a] - (sixteenpi * alpha) * s;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = a; b < 3; ++b) {
        const int c = I_AXX + S(a, b);
        r[c] = r[c] - (eightpi * alpha) *
                          (oopsi4 * Sdd[S(a, b)] -
                           (T(1.0 / 3.0) * Sm) * g[a][b]);
      }
  }

  // Sommerfeld radiative RHS on the outer active layer, from z4c_derivs
  if (F.somm) {
    r[I_KHAT] = F.somm_rhs(I_KHAT);
    r[I_THETA] = F.somm_rhs(I_THETA);
#pragma unroll
    for (int a = 0; a < 3; ++a) r[I_GAMX + a] = F.somm_rhs(I_GAMX + a);
#pragma unroll
    for (int q = 0; q < 6; ++q) r[I_AXX + q] = F.somm_rhs(I_AXX + q);
  }

  // Kreiss-Oliger dissipation on every channel
  if (P.have_ko) {
#pragma unroll
    for (int c = 0; c < kNZ4C; ++c) r[c] = r[c] + P.diss * F.ko(c);
  }
}

// The RK combine and AlgConstr of one cell from its buffer column and
// the inverse metric: writes u' of the cell through o (channel stride
// cs); u1 at the cell.  MAT: with the matter source.
template <typename T, bool MAT = false, class D>
__device__ __forceinline__ void z4c_update(const D& F, const Z4cPrm<T>& P,
                                           const T ginv[3][3],
                                           const T* __restrict__ u1,
                                           long long cs, T* __restrict__ o) {
  T r[kNZ4C];
  z4c_rhs<T, MAT>(F, P, ginv, r);

  // RK combine: (gam0 u + gam1 u1) + bdt rhs
  T un[kNZ4C];
#pragma unroll
  for (int c = 0; c < kNZ4C; ++c)
    un[c] = (P.gam0 * F.v(c) + P.gam1 * __ldg(u1 + c * cs)) + P.bdt * r[c];

  // AlgConstr (reference: Z4c::AlgConstr, z4c.cpp:258-310): pointwise,
  // so it commutes with the ghost fill that follows
  T g[3][3], A[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      g[a][b] = un[I_GXX + S(a, b)];
      A[a][b] = un[I_AXX + S(a, b)];
    }
  T detg = spatial_det(g);
  detg = detg > T(0) ? detg : T(1);
  const T oopsi4 = cbrt(T(1) / detg);
  T gs[3][3], gu[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) gs[a][b] = g[a][b] * oopsi4;
  adjugate(gs, gu);
  T trA = gu[0][0] * A[0][0];
#pragma unroll
  for (int q = 1; q < 9; ++q) trA = trA + gu[q / 3][q % 3] * A[q / 3][q % 3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b) {
      un[I_GXX + S(a, b)] = gs[a][b];
      un[I_AXX + S(a, b)] = A[a][b] - (T(1.0 / 3.0) * gs[a][b]) * trA;
    }
  un[I_CHI] = tmax(un[I_CHI], P.chi_min_floor);

#pragma unroll
  for (int c = 0; c < kNZ4C; ++c) o[c * cs] = un[c];
}

// The kernel and its launch are CUDA only: a host compiler (the CPU
// tests that build the code above with g++, tests/test_torch_z4c_host.py
// and tests/test_torch_z4c_tiles.py) stops here.
#ifdef __CUDACC__
template <typename T, int NG, bool MAT>
__global__ void __launch_bounds__(Z4cTile<T, NG>::NC, Z4cTile<T, NG>::MINB)
    z4c_tile_kernel(const T* __restrict__ u, const T* __restrict__ u1,
                    const T* __restrict__ sbc, const T* __restrict__ mat,
                    T* __restrict__ out, Z4cGeom geo, Z4cPrm<T> P,
                    const T* __restrict__ bdt) {
  P.bdt = __ldg(bdt);
  using Sh = Z4cTile<T, NG>;
  constexpr int NC = Sh::NC, WIN = Sh::WIN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const buf = reinterpret_cast<T*>(smem_raw);  // [kZ4cSlots][NC]
  T* const win = buf + kZ4cSlots * NC;              // [NSLOT][WIN]
  T* const d1x = win + Sh::NSLOT * WIN;             // [NXD]
  T* const d1y = d1x + Sh::NXD;                     // [NYD]

  const Z4cBox box = z4c_box(geo, blockIdx.x);
  const int t = threadIdx.x;
  const Z4cCellPos pos = z4c_cell_pos<Sh>(t);
  const long long cs =
      static_cast<long long>(geo.n3) * geo.n2 * geo.n1;
  const long long mb = static_cast<long long>(box.m) * kNZ4C * cs;
  const T* const um = u + mb;

  // the window cells this thread copies, tid + r NC, as offsets in a
  // channel, computed once
  constexpr int NR = (WIN + NC - 1) / NC;
  int woff[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r)
    woff[r] = z4c_src<Sh>(geo, box, t + r * NC < WIN ? t + r * NC : WIN - 1);
  auto copy = [&](int c) {
    T* const dst = win + c % Sh::NSLOT * WIN;
    const T* const src = um + c * cs;
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (r < NR - 1 || t + r * NC < WIN)
        cp_async<sizeof(T)>(dst + t + r * NC, src + woff[r]);
  };
  for (int c = 0; c < Sh::NSLOT - 1; ++c) {
    copy(c);
    cp_async_commit();
  }

  // this thread's cell, clamped into the array on a ragged box
  const int k = min(box.k0 + pos.z, geo.n3 - 1);
  const int j = min(box.j0 + pos.y, geo.n2 - 1);
  const int i = min(box.i0 + pos.x, geo.n1 - 1);
  const long long cell = (static_cast<long long>(k) * geo.n2 + j) * geo.n1 + i;
  T beta[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) beta[d] = __ldg(um + (I_BETAX + d) * cs + cell);
  Z4cSomm<T> sb{false, T(0), {T(0), T(0), T(0)}};
  if (sbc != nullptr) {
    const T* const s = sbc + static_cast<long long>(box.m) * 5 * cs + cell;
    sb.on = __ldg(s) != T(0);
    if (sb.on) {
      sb.rad = __ldg(s + cs);
#pragma unroll
      for (int d = 0; d < 3; ++d) sb.s_u[d] = __ldg(s + (2 + d) * cs);
    }
  }

  T gu[3][3];
  {
    T g[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int d = 0; d < 3; ++d)
        g[a][d] = __ldg(um + (I_GXX + S(a, d)) * cs + cell);
    z4c_inverse_metric(g, gu);
  }

  T* const b = buf + t;
#pragma unroll 1
  for (int c = 0; c < kNZ4C; ++c) {
    // channel c's window is in (the next NSLOT - 2 may be in flight);
    // every thread is done with channel c - 1, so its slot takes channel
    // c + NSLOT - 1
    cp_async_wait<Sh::NSLOT - 2>();
    __syncthreads();
    if (c + Sh::NSLOT - 1 < kNZ4C) copy(c + Sh::NSLOT - 1);
    cp_async_commit();
    const T* const w = win + c % Sh::NSLOT * WIN;
    if (z4c_mixed(c)) {
      for (int p = t; p < Sh::NP; p += NC)
        z4c_inner<T, Sh>(p, w, d1x, d1y, P);
      __syncthreads();
    }
    z4c_derivs<T, Sh>(c, w + pos.win, d1x + pos.dx, d1y + pos.dy, P, beta,
                      gu, sb, b);
  }
  // the buffer column is this thread's own: no barrier before the algebra
  if (box.k0 + pos.z >= box.k1 || box.j0 + pos.y >= box.j1 ||
      box.i0 + pos.x >= box.i1)
    return;
  const T* const mc =
      MAT ? mat + static_cast<long long>(box.m) * kNMat * cs + cell : nullptr;
  z4c_update<T, MAT>(Z4cCell<T, NC>{b, um + cell, cs, sb.on, mc}, P, gu,
                     u1 + mb + cell, cs, out + mb + cell);
}

template <typename T, int NG, bool MAT>
int z4c_stage_launch(const Z4cArgs& a) {
  if (MAT != (a.mat != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  using Sh = Z4cTile<T, NG>;
  auto kernel = z4c_tile_kernel<T, NG, MAT>;
  const size_t smem = static_cast<size_t>(Sh::SMEM) * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Z4cGeom geo = z4c_geom(a.nmb, a.n3, a.n2, a.n1, NG, Sh::TX, Sh::TY,
                               Sh::TZ);
  kernel<<<static_cast<unsigned int>(geo.blocks), Sh::NC, smem, a.stream>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.u1),
      static_cast<const T*>(a.sbc), static_cast<const T*>(a.mat),
      static_cast<T*>(a.out), geo, make_z4c_prm<T>(a.prm),
      static_cast<const T*>(a.bdt));
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__

}  // namespace athenak
