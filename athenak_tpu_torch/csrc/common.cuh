// Shared device helpers for the athenak_tpu_torch CUDA kernels.
//
// Arrays are contiguous and laid out as in the Python package:
// cell arrays [nmb, C, n3, n2, n1], face arrays x1f [nmb, n3, n2, n1+1],
// x2f [nmb, n3, n2+1, n1], x3f [nmb, n3+1, n2, n1].  Every entry point
// launches on the stream it is given, never synchronises or allocates,
// and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

namespace athenak {

constexpr int kThreads = 256;

#ifdef __CUDACC__  // the host tests build this header through a shim

// One wave of `kernel` for `need` blocks of work: as many CUDA blocks as
// fit on the card at once (`threads` threads and `smem` bytes of dynamic
// shared memory each), or `need` where that is fewer; the blocks stride
// over the work.
template <typename K>
cudaError_t wave_grid(K kernel, int threads, size_t smem, long long need,
                      unsigned int& grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long wave = static_cast<long long>(sms) * per_sm;
  grid = static_cast<unsigned int>(need < wave ? need : wave);
  return cudaSuccess;
}

// Two elements as one access: 8 bytes in float32, 16 in float64.
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
};
template <>
struct Pair<double> {
  using type = double2;
};

#endif  // __CUDACC__

__device__ __forceinline__ float tpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double tpow(double a, double b) { return pow(a, b); }

// max/min that keep the second operand on ties, as torch.maximum does
// for equal values (the results are identical either way)
template <typename T>
__device__ __forceinline__ T tmax(T a, T b) { return a < b ? b : a; }
template <typename T>
__device__ __forceinline__ T tmin(T a, T b) { return b < a ? b : a; }

// EOS parameters converted once to the working type, as the Python
// package converts its float scalars to the tensor's dtype.
template <typename T>
struct Eos {
  T gamma, gm1, igm1, dfloor, efloor, tfloor, sfloor, sigma_max;
};

template <typename T>
inline Eos<T> make_eos(double gamma, double dfloor, double pfloor,
                       double tfloor, double sfloor, double sigma_max) {
  Eos<T> e;
  e.gamma = static_cast<T>(gamma);
  e.gm1 = static_cast<T>(gamma - 1.0);
  e.igm1 = static_cast<T>(1.0 / (gamma - 1.0));
  e.dfloor = static_cast<T>(dfloor);
  e.efloor = static_cast<T>(pfloor / (gamma - 1.0));
  e.tfloor = static_cast<T>(tfloor);
  e.sfloor = static_cast<T>(sfloor);
  e.sigma_max = static_cast<T>(sigma_max);
  return e;
}

// Newtonian ideal-MHD cons->prim with the floor cascade
// (reference: src/eos/ideal_c2p_mhd.hpp; mirrors ops/eos.py).
// Writes the primitives w and the floored conserved state uf; the
// flags are the density, energy-or-entropy and temperature floor hits.
template <typename T>
__device__ __forceinline__ void c2p(const T u[5], T bx, T by, T bz,
                                    const Eos<T>& eos, T w[5], T uf[5],
                                    int& fl_d, int& fl_e, int& fl_t) {
  T d = u[0];
  const T mx = u[1], my = u[2], mz = u[3], etot = u[4];
  const T b2 = bx * bx + by * by + bz * bz;
  const T dfl = tmax(b2 / eos.sigma_max, eos.dfloor);
  fl_d = d < dfl;
  d = tmax(d, dfl);
  const T di = T(1) / d;
  const T e_k = T(0.5) * di * (mx * mx + my * my + mz * mz);
  const T e_m = T(0.5) * b2;
  T e = etot - e_k - e_m;
  const bool efl = e < eos.efloor;
  e = tmax(e, eos.efloor);
  const bool tfl = eos.gm1 * e * di < eos.tfloor;
  if (tfl) e = d * eos.tfloor / eos.gm1;
  const T spe = eos.gm1 / tpow(d, eos.gm1);
  const bool sfl = spe * e * di <= eos.sfloor;
  if (sfl) e = d * eos.sfloor / spe;
  w[0] = d;
  w[1] = di * mx;
  w[2] = di * my;
  w[3] = di * mz;
  w[4] = e;
  uf[0] = d;
  uf[1] = mx;
  uf[2] = my;
  uf[3] = mz;
  uf[4] = (efl || tfl || sfl) ? e + e_k + e_m : etot;
  fl_e = efl || sfl;
  fl_t = tfl;
}

// Fast magnetosonic speed (reference IdealMHDFastSpeed, ops/eos.py)
template <typename T>
__device__ __forceinline__ T fast_speed(const Eos<T>& eos, T d, T p, T bx,
                                        T by, T bz) {
  const T asq = eos.gamma * p;
  const T ct2 = by * by + bz * bz;
  const T qsq = bx * bx + ct2 + asq;
  const T tmp = bx * bx + ct2 - asq;
  return sqrt(T(0.5) * (qsq + sqrt(tmp * tmp + T(4) * asq * ct2)) / d);
}

}  // namespace athenak
