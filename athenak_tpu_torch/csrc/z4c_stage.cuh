// Declarations shared by the Z4c stage kernel's entry points
// (z4c_stage.cu) and its instances (z4c_stage_ng{2,3,4,5}_f{32,64}.cu in
// vacuum, z4c_matter_ng{2,3,4,5}_f{32,64}.cu with the matter source).
//
// The stage kernel is one template per (float type, nghost, matter).
// Its definition (z4c_rhs.cuh) is large, so each instance is compiled in
// a file of its own and the parallel build compiles the sixteen at once;
// the entry points see only the declaration below.
#pragma once

#include "common.cuh"

namespace athenak {

constexpr int kNZ4C = 22;
// The stress-energy channels of the matter source, undensitised and
// cell-centred (DynGRMHD.set_tmunu): E, S_d (3), S_dd (xx xy xz yy yz zz)
constexpr int kNMat = 10;

// The stage's scalars, in the order of ops/z4c_stage.py _PRM_NAMES: the
// host passes them as doubles, already combined where the Python code
// combines Python floats before it meets a tensor (e.g. k1 * (1 - k2)).
// The step is not among them: the kernel reads it from device memory
// (Z4cArgs::bdt), so that a CUDA graph replays the launch on whatever
// step the tensor holds.
enum Z4cPrmIndex {
  P_GAM0, P_GAM1,
  P_IDX1, P_IDX2, P_IDX3,
  P_IDX1SQ, P_IDX2SQ, P_IDX3SQ,
  P_DISS, P_CHI_DIV_FLOOR, P_CHI_MIN_FLOOR,
  P_NPOW, P_OOPSI4_POW, P_C6N,
  P_K1, P_K1F, P_K2F, P_USE_Z4C,
  P_F0, P_LAPSE_HARMONIC, P_LAPSE_ADVECT,
  P_SHIFT_GGAMMA, P_SHIFT_ADVECT, P_SHIFT_ETA, P_SHIFT_ALPHA2GGAMMA,
  P_SHIFT_HH,
  P_COUNT
};

// The scalars in the working type, each converted once from its double,
// as torch converts a Python float to the tensor's dtype; bdt is the step
// as the kernel read it from device memory (make_z4c_prm leaves it 0).
template <typename T>
struct Z4cPrm {
  T gam0, gam1, bdt;
  T idx[3], idx2[3];
  T diss, chi_div_floor, chi_min_floor, npow, oopsi4_pow, c6n;
  T k1, k1f, k2f, use_z4c, f0, lapse_harmonic, lapse_advect;
  T shift_ggamma, shift_advect, shift_eta, shift_alpha2ggamma, shift_hh;
  int one_pow;  // chi^1: torch copies, pow is not called
  int have_ko;  // diss != 0
  int have_hh;  // shift_H != 0
};

template <typename T>
inline Z4cPrm<T> make_z4c_prm(const double* p) {
  Z4cPrm<T> q;
  q.gam0 = static_cast<T>(p[P_GAM0]);
  q.gam1 = static_cast<T>(p[P_GAM1]);
  q.bdt = T(0);
  for (int d = 0; d < 3; ++d) {
    q.idx[d] = static_cast<T>(p[P_IDX1 + d]);
    q.idx2[d] = static_cast<T>(p[P_IDX1SQ + d]);
  }
  q.diss = static_cast<T>(p[P_DISS]);
  q.chi_div_floor = static_cast<T>(p[P_CHI_DIV_FLOOR]);
  q.chi_min_floor = static_cast<T>(p[P_CHI_MIN_FLOOR]);
  q.npow = static_cast<T>(p[P_NPOW]);
  q.oopsi4_pow = static_cast<T>(p[P_OOPSI4_POW]);
  q.c6n = static_cast<T>(p[P_C6N]);
  q.k1 = static_cast<T>(p[P_K1]);
  q.k1f = static_cast<T>(p[P_K1F]);
  q.k2f = static_cast<T>(p[P_K2F]);
  q.use_z4c = static_cast<T>(p[P_USE_Z4C]);
  q.f0 = static_cast<T>(p[P_F0]);
  q.lapse_harmonic = static_cast<T>(p[P_LAPSE_HARMONIC]);
  q.lapse_advect = static_cast<T>(p[P_LAPSE_ADVECT]);
  q.shift_ggamma = static_cast<T>(p[P_SHIFT_GGAMMA]);
  q.shift_advect = static_cast<T>(p[P_SHIFT_ADVECT]);
  q.shift_eta = static_cast<T>(p[P_SHIFT_ETA]);
  q.shift_alpha2ggamma = static_cast<T>(p[P_SHIFT_ALPHA2GGAMMA]);
  q.shift_hh = static_cast<T>(p[P_SHIFT_HH]);
  q.one_pow = p[P_OOPSI4_POW] == 1.0;
  q.have_ko = p[P_DISS] != 0.0;
  q.have_hh = p[P_SHIFT_HH] != 0.0;
  return q;
}

struct Z4cArgs {
  const void* u;    // [nmb, 22, n3, n2, n1]
  const void* u1;   // the RK register, same shape
  const void* sbc;  // [nmb, 5, n3, n2, n1] Sommerfeld geometry, or null
  void* out;        // fresh buffer, same shape as u; interior written
  const void* mat;  // [nmb, kNMat, n3, n2, n1] stress-energy, or null
  int nmb, n3, n2, n1;
  const double* prm;  // P_COUNT doubles
  const void* bdt;    // the step: one T on the card
  cudaStream_t stream;
};

// Launches the stage on args.stream; returns cudaGetLastError().  MAT:
// the instance with the matter source, which reads args.mat (the vacuum
// instance never does).
template <typename T, int NG, bool MAT>
int z4c_stage_launch(const Z4cArgs& args);

}  // namespace athenak
