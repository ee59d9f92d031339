// Kernel F: cell-centred field + cons->prim after a stage, with the
// floor counts and the new dt.
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_aux3d: from u and the
// ghost-filled face fields, bcc averages the faces (i, i+1) of each axis,
// c2p applies the floor chain (common.cuh, ops/eos.py), and the floor hits
// and max(|v_d| + c_f,d) per direction are reduced over the interior
// cells into dtmin.  Plain version: ops/aux.py::fused_aux3d_plain.
//
// Every cell of the whole array, ghosts included, is converted.  With
// wrap (a single fully periodic block) a ghost cell reads the interior
// cell it wraps to along every axis (the cell itself when interior), so
// u, w and bcc come out with every ghost filled, the x3 ghost planes of
// u too.  The Pallas kernel wraps the in-plane ghosts of u, w and bcc,
// heals the x3 ghost planes of w alone and leaves those of u stale; the
// two agree on everything the Pallas kernel fills.  Without wrap (a pool,
// whose u the pool fill has filled) every cell converts its own state.
// Outputs go to fresh buffers: with wrap a ghost thread reads the input
// of the interior cell another thread converts.
//
// What bounds it on the H100: memory, u (5) and the three face arrays in,
// u, w (5 each) and bcc (3) out: 21 values a cell; the c2p is some 100
// operations a cell.  The first design ran a thread a cell over a 64-bit
// flat index (four 64-bit divisions a cell), ended every 256-thread
// block in an atomic on the same six words (9,000 blocks at 132^3), and
// left a memset before the kernel and nine torch ops after it.  This
// design:
//   * numbers the cells flatly in 32-bit arithmetic (aux_cells.cuh),
//     neighbouring threads on neighbouring cells, so the reads of b1[i],
//     b1[i+1], rows j, j+1 of b2 and planes k, k+1 of b3 are coalesced
//     (a map of 16-lane groups to row segments ran 5-11% slower on the
//     H100, its loop holding 60-64 registers against 48-52; a
//     multiply-high division, DivBy in pool_fill.cuh, gained under 1%);
//   * runs one wave of blocks that stride over the cells with the floor
//     counts and the three maxima in registers, then reduce once a block
//     (warp shuffles, shared memory) and add to a per-device workspace
//     with six atomics a block;
//   * lets the last block to finish (a ticket after __threadfence) write
//     the counts and dtmin into the call's fresh outputs and
//     zero the workspace for the next call: one launch a call, nothing
//     before or after it.  dtmin is computed as the plain wrapper's torch
//     ops computed it, min over x1, x2, x3 of (1 / vmax_d) * T(dx_d), so
//     it is bitwise theirs.
// The per-cell arithmetic (the bcc average, c2p, the fast speeds) is the
// first design's, under --fmad=false, so u, w, bcc, the counts and dtmin
// are bitwise its results.

#include "aux_cells.cuh"
#include "mhd_stage.cuh"

namespace athenak {
namespace {

// The per-device accumulators, zero between calls: the floor counts, the
// bit patterns of the three maxima (positive floats order like their
// bits, max_bits in mhd_stage.cuh) and the ticket of finished blocks.
struct AuxWork {
  unsigned long long count[3];
  unsigned long long vmax[3];
  unsigned long long ticket;
};

template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long b);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long b) {
  return __uint_as_float(static_cast<unsigned int>(b));
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long b) {
  return __longlong_as_double(static_cast<long long>(b));
}

// what the last block needs besides the arrays
struct AuxOut {
  AuxWork* work;
  long long* counts;  // [3]: the call's floor counts
  void* dtmin;        // a T: the call's dtmin, written when want_dt
  double dx[3];
  int want_dt;
};

template <typename T, bool kWrap>
__global__ void __launch_bounds__(kThreads)
    aux_kernel(AuxGeom g, Eos<T> eos, const T* __restrict__ u_in,
               const T* __restrict__ b1_in, const T* __restrict__ b2_in,
               const T* __restrict__ b3_in, T* __restrict__ u_out,
               T* __restrict__ w_out, T* __restrict__ bcc_out, AuxOut a) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // block strides of the arrays, in elements
  const long long s_cc = static_cast<long long>(g.ncell);
  const long long s_f1 = static_cast<long long>(g.n3) * g.n2 * (g.n1 + 1);
  const long long s_f2 = static_cast<long long>(g.n3) * (g.n2 + 1) * g.n1;
  const long long s_f3 = static_cast<long long>(g.n3 + 1) * g.n2 * g.n1;
  const int plane = g.n2 * g.n1;
  int cnt[3] = {0, 0, 0};
  T vmax[3] = {T(0), T(0), T(0)};
  for (int t = blockIdx.x * kThreads + threadIdx.x; t < g.cells;
       t += gridDim.x * kThreads) {
    const AuxCell cell = aux_cell(g, t, kWrap);
    const long long m = cell.m;
    const T* u = u_in + m * 5 * s_cc + cell.src;
    const T* b1 = b1_in + m * s_f1 + cell.f1;
    const T* b2 = b2_in + m * s_f2 + cell.f2;
    const T* b3 = b3_in + m * s_f3 + cell.f3;
    const T bx = T(0.5) * (b1[0] + b1[1]);
    const T by = T(0.5) * (b2[0] + b2[g.n1]);
    const T bz = T(0.5) * (b3[0] + b3[plane]);
    T uu[5], ww[5], uf[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) uu[c] = u[c * g.ncell];
    int fd, fe, ft;
    c2p(uu, bx, by, bz, eos, ww, uf, fd, fe, ft);
    const long long dst = m * 5 * s_cc + cell.dst;
    T* uo = u_out + dst;
    T* wo = w_out + dst;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      uo[c * g.ncell] = uf[c];
      wo[c * g.ncell] = ww[c];
    }
    T* bo = bcc_out + m * 3 * s_cc + cell.dst;
    bo[0] = bx;
    bo[g.ncell] = by;
    bo[2 * g.ncell] = bz;
    if (cell.inner) {
      cnt[0] += fd;
      cnt[1] += fe;
      cnt[2] += ft;
      if (a.want_dt) {
        // new-dt signal speeds (physics/mhd.py new_dt)
        const T p = eos.gm1 * ww[4];
        vmax[0] = tmax(vmax[0], fabs(ww[1]) +
                                    fast_speed(eos, ww[0], p, bx, by, bz));
        vmax[1] = tmax(vmax[1], fabs(ww[2]) +
                                    fast_speed(eos, ww[0], p, by, bz, bx));
        vmax[2] = tmax(vmax[2], fabs(ww[3]) +
                                    fast_speed(eos, ww[0], p, bz, bx, by));
      }
    }
  }

  // once a block: warp shuffles, then the warps' partials in shared memory
  __shared__ int s_cnt[3][kWarps];
  __shared__ T s_max[3][kWarps];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    int n = cnt[c];
    T v = vmax[c];
    for (int off = 16; off > 0; off >>= 1) {
      n += __shfl_xor_sync(0xffffffffu, n, off);
      v = tmax(v, __shfl_xor_sync(0xffffffffu, v, off));
    }
    if (lane == 0) {
      s_cnt[c][warp] = n;
      s_max[c][warp] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  AuxWork* w = a.work;
  for (int c = 0; c < 3; ++c) {
    int n = s_cnt[c][0];
    T v = s_max[c][0];
    for (int q = 1; q < kWarps; ++q) {
      n += s_cnt[c][q];
      v = tmax(v, s_max[c][q]);
    }
    if (n) atomicAdd(&w->count[c], static_cast<unsigned long long>(n));
    if (a.want_dt) atomicMax(&w->vmax[c], max_bits<T>(v));
  }
  // the last block to finish sees every other block's atomics
  __threadfence();
  if (atomicAdd(&w->ticket, 1ULL) != gridDim.x - 1) return;
  __threadfence();
  volatile AuxWork* vw = w;
  T dtmin = T(0);
  for (int c = 0; c < 3; ++c) {
    a.counts[c] = static_cast<long long>(vw->count[c]);
    // torch: dx / vmax is vmax.reciprocal() * T(dx); then min of the
    // three, NaN first
    const T q = (T(1) / from_bits<T>(vw->vmax[c])) * static_cast<T>(a.dx[c]);
    if (c == 0 || q != q || (dtmin == dtmin && q < dtmin)) dtmin = q;
    vw->count[c] = 0;
    vw->vmax[c] = 0;
  }
  if (a.want_dt) *static_cast<T*>(a.dtmin) = dtmin;
  vw->ticket = 0;
}

template <typename T>
struct AuxPtrs {
  const T *u, *b1, *b2, *b3;
  T *uo, *wo, *bcco;
};

template <typename T, bool kWrap>
int launch_one(const AuxGeom& g, const Eos<T>& eos, const AuxPtrs<T>& p,
               const AuxOut& a, cudaStream_t s) {
  unsigned int grid = 0;
  const cudaError_t err =
      wave_grid(aux_kernel<T, kWrap>, kThreads, 0,
                (static_cast<long long>(g.cells) + kThreads - 1) / kThreads,
                grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  aux_kernel<T, kWrap><<<grid, kThreads, 0, s>>>(
      g, eos, p.u, p.b1, p.b2, p.b3, p.uo, p.wo, p.bcco, a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const AuxGeom& g, bool wrap, const Eos<T>& eos,
           const AuxPtrs<T>& p, const AuxOut& a, cudaStream_t s) {
  // 32-bit offsets within a block, 32-bit cell numbers (with room for
  // the grid's stride)
  const long long ncell = static_cast<long long>(g.n3) * g.n2 * g.n1;
  if (g.nmb <= 0 || ncell <= 0 || 5 * ncell >= (1LL << 31) ||
      g.nmb * ncell >= (1LL << 31) - (1LL << 24))
    return cudaErrorInvalidValue;
  return wrap ? launch_one<T, true>(g, eos, p, a, s)
              : launch_one<T, false>(g, eos, p, a, s);
}

}  // namespace
}  // namespace athenak

// work: the zeroed AuxWork (7 words) of the stream; counts: the call's
// [3] int64; dtmin: the call's 0-d T, and dx1..dx3, read when want_dt.
#define ATHENAK_AUX_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const void* u, const void* b1, const void* b2,         \
                      const void* b3, void* uo, void* wo, void* bcco,        \
                      void* work, void* counts, void* dtmin, int nmb,        \
                      int n3, int n2, int n1, int ng, int wrap, int want_dt, \
                      double gamma, double dfloor, double pfloor,            \
                      double tfloor, double sfloor, double sigma_max,        \
                      double dx1, double dx2, double dx3, void* stream) {    \
    using namespace athenak;                                                 \
    const AuxPtrs<T> p{                                                      \
        static_cast<const T*>(u),  static_cast<const T*>(b1),                \
        static_cast<const T*>(b2), static_cast<const T*>(b3),                \
        static_cast<T*>(uo),       static_cast<T*>(wo),                      \
        static_cast<T*>(bcco)};                                              \
    const AuxOut a{static_cast<AuxWork*>(work),                              \
                   static_cast<long long*>(counts), dtmin, {dx1, dx2, dx3},  \
                   want_dt};                                                 \
    return launch<T>(                                                        \
        aux_geom(nmb, n3, n2, n1, ng), wrap != 0,                            \
        make_eos<T>(gamma, dfloor, pfloor, tfloor, sfloor, sigma_max), p, a, \
        static_cast<cudaStream_t>(stream));                                  \
  }

ATHENAK_AUX_ENTRY(athenak_fused_aux_f32, float)
ATHENAK_AUX_ENTRY(athenak_fused_aux_f64, double)
