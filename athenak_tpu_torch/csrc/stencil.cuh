// Index arithmetic and stencils shared by the stage and CT kernels
// (mega_stage_v2.cu, fused_stage.cu, fused_ct.cu).
#pragma once

#include "common.cuh"

namespace athenak {

struct Dims {
  int nmb, n3, n2, n1, ng;
  long long ncell;  // n3 * n2 * n1
};

// cell arrays [nmb, nc, n3, n2, n1]
__device__ __forceinline__ long long cidx(const Dims& g, int m, int c, int nc,
                                          int k, int j, int i) {
  return ((static_cast<long long>(m) * nc + c) * g.n3 + k) * g.n2 * g.n1 +
         static_cast<long long>(j) * g.n1 + i;
}
// face arrays
__device__ __forceinline__ long long f1idx(const Dims& g, int m, int k, int j,
                                           int i) {
  return ((static_cast<long long>(m) * g.n3 + k) * g.n2 + j) * (g.n1 + 1) + i;
}
__device__ __forceinline__ long long f2idx(const Dims& g, int m, int k, int j,
                                           int i) {
  return ((static_cast<long long>(m) * g.n3 + k) * (g.n2 + 1) + j) * g.n1 + i;
}
__device__ __forceinline__ long long f3idx(const Dims& g, int m, int k, int j,
                                           int i) {
  return ((static_cast<long long>(m) * (g.n3 + 1) + k) * g.n2 + j) * g.n1 + i;
}

// p wrapped into [0, n): the circular shifts (torch.roll) of the plain
// versions, one step beyond either end
__device__ __forceinline__ int wrapi(int p, int n) {
  return p < 0 ? p + n : (p >= n ? p - n : p);
}

// PLM (van Leer) left state at face f from cell f-1, right state from f
template <typename T>
__device__ __forceinline__ void plm_face(T qm2, T qm1, T q0, T qp1, T& ql,
                                         T& qr) {
  T dql = qm1 - qm2, dqr = q0 - qm1, dq2 = dql * dqr;
  const T dqm_l = dq2 <= T(0) ? T(0) : dq2 / (dql + dqr);
  ql = qm1 + dqm_l;
  dql = q0 - qm1;
  dqr = qp1 - q0;
  dq2 = dql * dqr;
  const T dqm_r = dq2 <= T(0) ? T(0) : dq2 / (dql + dqr);
  qr = q0 - dqm_r;
}

// Gardiner & Stone (2005/07) corner value, mirrors physics/mhd.py _gs07
template <typename T>
__device__ __forceinline__ T gs07(T e_cc, T cc_am, T cc_bm, T cc_mm, T e_a,
                                  T e_a_m, T e_b, T e_b_m, T f_a, T f_a_m,
                                  T f_b, T f_b_m) {
  const T l_b = f_a_m >= T(0) ? e_b_m - cc_mm : e_b - cc_bm;
  const T r_b = f_a >= T(0) ? e_b_m - cc_am : e_b - e_cc;
  const T l_a = f_b_m >= T(0) ? e_a_m - cc_mm : e_a - cc_am;
  const T r_a = f_b >= T(0) ? e_a_m - cc_bm : e_a - e_cc;
  return T(0.25) * (l_b + r_b + l_a + r_a + e_b_m + e_b + e_a_m + e_a);
}

}  // namespace athenak
