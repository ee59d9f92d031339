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
// One thread per interior cell, over every block.  A thread reads its
// stencils straight from device memory (L1 and L2 catch the reuse
// between neighbours) and writes the 22 channels of its cell to a fresh
// buffer: neighbours read u's stencil, so nothing is written in place.
// Ghost cells of the output are not written; the ghost fill that follows
// every stage fills them.
//
// Every sum keeps rhs_core's order, term by term, and every Python float
// meets the tensor as the working type (the scalars of Z4cPrm), so with
// --fmad=false the kernel rounds as the plain torch version does; only
// pow and cbrt (for which torch has x ** (1/3)) may differ by an ulp.
//
// What bounds it on the H100: operations.  Some 18,000 flops a cell
// against 71 values moved (u and u1 read, the geometry read, u'
// written): at 60^3 about 4e9 flops, 0.06 ms at the float32 peak, and
// 0.02 ms of memory traffic.  The design is the simple one: hundreds of
// live values a cell spill to local memory, and the stencil reads are
// not staged in shared memory.  Tiling the 22-channel window in shared
// memory and splitting the Ricci block is later work.
#pragma once

#include "z4c_stage.cuh"

namespace athenak {

constexpr int kZ4cThreads = 128;

// Channel indices (z4c.py, reference: z4c.hpp:46-56)
constexpr int I_CHI = 0, I_GXX = 1, I_KHAT = 7, I_AXX = 8, I_GAMX = 14,
              I_THETA = 17, I_ALPHA = 18, I_BETAX = 19;

// sym_idx: the position of (a, b) among xx, xy, xz, yy, yz, zz
__host__ __device__ constexpr int S(int a, int b) {
  return a > b ? S(b, a) : (a == 0 ? b : (a == 1 ? 2 + b : 5));
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

// Finite differences at one cell: fd.py's _apply, term by term in table
// order, then the 1/dx factor.  ``st`` are the x1, x2, x3 strides.
template <typename T, int NG>
struct Fd {
  const T* __restrict__ p;  // u at the cell, channel 0
  long long cs;             // channel stride n3 * n2 * n1
  long long st[3];
  T idx[3], idx2[3];

  __device__ __forceinline__ T v(int c, long long off) const {
    return __ldg(p + c * cs + off);
  }

  __device__ __forceinline__ T d1_at(int c, int d, long long base) const {
    T o = cD1(T(), NG, 0) * v(c, base + d1_off(NG, 0) * st[d]);
#pragma unroll
    for (int q = 1; q < 2 * NG - 2; ++q)
      o = o + cD1(T(), NG, q) * v(c, base + d1_off(NG, q) * st[d]);
    return o * idx[d];
  }
  __device__ __forceinline__ T d1(int c, int d) const { return d1_at(c, d, 0); }

  __device__ __forceinline__ T d2(int c, int d) const {
    T o = cD2(T(), NG, 0) * v(c, (0 - (NG - 1)) * st[d]);
#pragma unroll
    for (int q = 1; q < 2 * NG - 1; ++q)
      o = o + cD2(T(), NG, q) * v(c, (q - (NG - 1)) * st[d]);
    return o * idx2[d];
  }

  // fd.d1d1(f, da, db): the first derivative along da, then along db
  __device__ __forceinline__ T d1d1(int c, int da, int db) const {
    T o = cD1(T(), NG, 0) * d1_at(c, da, d1_off(NG, 0) * st[db]);
#pragma unroll
    for (int q = 1; q < 2 * NG - 2; ++q)
      o = o + cD1(T(), NG, q) * d1_at(c, da, d1_off(NG, q) * st[db]);
    return o * idx[db];
  }

  // the backend's d2(f, a, b): centred on one axis, else nested with the
  // inner derivative along the lower direction
  __device__ __forceinline__ T dd(int c, int a, int b) const {
    return a == b ? d2(c, a) : (a < b ? d1d1(c, a, b) : d1d1(c, b, a));
  }

  // fd.adv: beta * dl where beta < 0, else beta * dr
  __device__ __forceinline__ T adv(int c, int d, T b) const {
    if (b < T(0)) {
      T o = cAdv(T(), NG, 0) * v(c, (0 - NG) * st[d]);
#pragma unroll
      for (int q = 1; q < 2 * NG - 1; ++q)
        o = o + cAdv(T(), NG, q) * v(c, (q - NG) * st[d]);
      return b * (o * idx[d]);
    }
    T o = -cAdv(T(), NG, 0) * v(c, NG * st[d]);
#pragma unroll
    for (int q = 1; q < 2 * NG - 1; ++q)
      o = o + -cAdv(T(), NG, q) * v(c, (NG - q) * st[d]);
    return b * (o * idx[d]);
  }

  __device__ __forceinline__ T ladv(int c, const T beta[3]) const {
    T o = adv(c, 0, beta[0]);
    o = o + adv(c, 1, beta[1]);
    o = o + adv(c, 2, beta[2]);
    return o;
  }

  __device__ __forceinline__ T ko_dir(int c, int d) const {
    T o = cDiss(T(), NG, 0) * v(c, (0 - NG) * st[d]);
#pragma unroll
    for (int q = 1; q < 2 * NG + 1; ++q)
      o = o + cDiss(T(), NG, q) * v(c, (q - NG) * st[d]);
    return o * idx[d];
  }
  __device__ __forceinline__ T ko(int c) const {
    T o = ko_dir(c, 0);
    o = o + ko_dir(c, 1);
    o = o + ko_dir(c, 2);
    return o;
  }

  // fd.d1(f, d, idx, 2): the 2nd-order first derivative (Sommerfeld)
  __device__ __forceinline__ T d1o2(int c, int d) const {
    T o = T(-1.0 / 2.0) * v(c, -st[d]);
    o = o + T(1.0 / 2.0) * v(c, st[d]);
    return o * idx[d];
  }
};

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

// rhs_core.rhs_core at one cell, into r[22]
template <typename T, int NG>
__device__ __forceinline__ void z4c_rhs(const Fd<T, NG>& F,
                                        const Z4cPrm<T>& P, const T* sbc,
                                        long long sbc_cs, T r[kNZ4C]) {
  // centred values
  const T chi = F.v(I_CHI, 0), khat = F.v(I_KHAT, 0);
  const T theta = F.v(I_THETA, 0), alpha = F.v(I_ALPHA, 0);
  T g[3][3], A[3][3], gam[3], beta[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    gam[a] = F.v(I_GAMX + a, 0);
    beta[a] = F.v(I_BETAX + a, 0);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      g[a][b] = F.v(I_GXX + S(a, b), 0);
      A[a][b] = F.v(I_AXX + S(a, b), 0);
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
  const T detg = spatial_det(g);
  T gu[3][3];
  {
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
      T ddg[6];  // DDg(c, d, a, b) for the six (c, d)
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int d = c; d < 3; ++d) ddg[S(c, d)] = F.dd(I_GXX + S(a, b), c, d);
      T rr = T(0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const T t = T(0.5) * ((g[c][a] * dgam[b][c] + g[c][b] * dgam[a][c]) +
                              gam_c[c] * (Gddd[a][b][c] + Gddd[b][a][c]));
        rr = c == 0 ? t : rr + t;
      }
      T s = T(0);
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int c = q / 3, d = q % 3;
        const T t = (T(0.5) * gu[c][d]) * ddg[S(c, d)];
        s = q == 0 ? t : s + t;
      }
      rr = rr - s;
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
  T ddbeta[3][3][3];  // [a][b][c] = D2(beta^c, a, b)
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = a; b < 3; ++b)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ddbeta[a][b][c] = F.dd(I_BETAX + c, a, b);
        ddbeta[b][a][c] = ddbeta[a][b][c];
      }
  T ddbeta_d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T s = T(1.0 / 3.0) * ddbeta[a][0][0];
    s = s + T(1.0 / 3.0) * ddbeta[a][1][1];
    s = s + T(1.0 / 3.0) * ddbeta[a][2][2];
    ddbeta_d[a] = s;
  }

  const T Lchi = F.ladv(I_CHI, beta) + (P.c6n * chi_g) * divbeta;

  // ------------------------------------------------------------ assemble
  r[I_KHAT] = ((-Ddalpha + alpha * (AA + (T(1.0 / 3.0) * K) * K)) +
               F.ladv(I_KHAT, beta)) +
              (P.k1f * alpha) * theta;
  r[I_CHI] = Lchi - ((P.c6n * chi_g) * alpha) * K;
  r[I_THETA] = P.use_z4c * (F.ladv(I_THETA, beta) +
                            alpha * (T(0.5) * Ht - P.k2f * theta));

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T s1 = T(0);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const T t = gu[a][b] * ddbeta_d[b] - gam_c[b] * dbeta[b][a];
      s1 = b == 0 ? t : s1 + t;
    }
    T s2 = T(0);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      const int b = q / 3, c = q % 3;
      const T t = gu[b][c] * ddbeta[b][c][a];
      s2 = q == 0 ? t : s2 + t;
    }
    const T Lgam = ((F.ladv(I_GAMX + a, beta) +
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
      const T Lg = (F.ladv(I_GXX + S(a, b), beta) -
                    (T(2.0 / 3.0) * g[a][b]) * divbeta) +
                   sg;
      const T LA = (F.ladv(I_AXX + S(a, b), beta) -
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
  r[I_ALPHA] = P.lapse_advect * F.ladv(I_ALPHA, beta) - (f * alpha) * khat;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T v = ((P.shift_ggamma * gam[a] +
            P.shift_advect * F.ladv(I_BETAX + a, beta)) -
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

  // Sommerfeld radiative RHS on the outer active layer (reference:
  // Z4cSommerfeld, z4c_Sbc.cpp:25-122; 2nd-order derivatives)
  if (sbc != nullptr && sbc[0] != T(0)) {
    const T rad = sbc[sbc_cs];
    const T s_u[3] = {sbc[2 * sbc_cs], sbc[3 * sbc_cs], sbc[4 * sbc_cs]};
    auto somm = [&](int c, T speed) {
      T o = (-speed * F.v(c, 0)) / rad;
#pragma unroll
      for (int d = 0; d < 3; ++d) o = o - (speed * s_u[d]) * F.d1o2(c, d);
      return o;
    };
    r[I_KHAT] = somm(I_KHAT, T(1.4142135623730951));
    r[I_THETA] = somm(I_THETA, T(1));
#pragma unroll
    for (int a = 0; a < 3; ++a) r[I_GAMX + a] = somm(I_GAMX + a, T(1));
#pragma unroll
    for (int q = 0; q < 6; ++q) r[I_AXX + q] = somm(I_AXX + q, T(1));
  }

  // Kreiss-Oliger dissipation on every channel
  if (P.have_ko) {
#pragma unroll
    for (int c = 0; c < kNZ4C; ++c) r[c] = r[c] + P.diss * F.ko(c);
  }
}

template <typename T, int NG>
__global__ void __launch_bounds__(kZ4cThreads)
    z4c_stage_kernel(const T* __restrict__ u, const T* __restrict__ u1,
                     const T* __restrict__ sbc, T* __restrict__ out, int nmb,
                     int n3, int n2, int n1, Z4cPrm<T> P) {
  const int nx1 = n1 - 2 * NG, nx2 = n2 - 2 * NG, nx3 = n3 - 2 * NG;
  long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (t >= static_cast<long long>(nmb) * nx3 * nx2 * nx1) return;
  const int i = NG + static_cast<int>(t % nx1);
  t /= nx1;
  const int j = NG + static_cast<int>(t % nx2);
  t /= nx2;
  const int k = NG + static_cast<int>(t % nx3);
  const long long m = t / nx3;
  const long long cs = static_cast<long long>(n3) * n2 * n1;
  const long long cell = (static_cast<long long>(k) * n2 + j) * n1 + i;
  const long long base = m * kNZ4C * cs + cell;

  Fd<T, NG> F;
  F.p = u + base;
  F.cs = cs;
  F.st[0] = 1;
  F.st[1] = n1;
  F.st[2] = static_cast<long long>(n2) * n1;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    F.idx[d] = P.idx[d];
    F.idx2[d] = P.idx2[d];
  }
  const T* sb = sbc != nullptr ? sbc + m * 5 * cs + cell : nullptr;

  T r[kNZ4C];
  z4c_rhs<T, NG>(F, P, sb, cs, r);

  // RK combine: (gam0 u + gam1 u1) + bdt rhs
  T un[kNZ4C];
#pragma unroll
  for (int c = 0; c < kNZ4C; ++c)
    un[c] = (P.gam0 * F.v(c, 0) + P.gam1 * __ldg(u1 + base + c * cs)) +
            P.bdt * r[c];

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

  T* o = out + base;
#pragma unroll
  for (int c = 0; c < kNZ4C; ++c) o[c * cs] = un[c];
}

// The launch is CUDA only: a host compiler (the CPU test that builds the
// device code above with g++, tests/test_torch_z4c_host.py) stops here.
#ifdef __CUDACC__
template <typename T, int NG>
int z4c_stage_launch(const Z4cArgs& a) {
  const long long total = static_cast<long long>(a.nmb) * (a.n3 - 2 * NG) *
                          (a.n2 - 2 * NG) * (a.n1 - 2 * NG);
  const unsigned int grid =
      static_cast<unsigned int>((total + kZ4cThreads - 1) / kZ4cThreads);
  z4c_stage_kernel<T, NG><<<grid, kZ4cThreads, 0, a.stream>>>(
      static_cast<const T*>(a.u), static_cast<const T*>(a.u1),
      static_cast<const T*>(a.sbc), static_cast<T*>(a.out), a.nmb, a.n3,
      a.n2, a.n1, make_z4c_prm<T>(a.prm));
  return static_cast<int>(cudaGetLastError());
}
#endif  // __CUDACC__

}  // namespace athenak
