// Kernel C: the split MHD stage, PLM + face floors + Riemann solve in
// x1/x2/x3 and the RK flux-divergence update.
//
// Replaces athenak_tpu/ops/pallas_stage.py::fused_stage3d (its x1 kernel
// mk_k1, the x2 _mk_roll_kernel and the x3 _mk_x3_kernel).  From the
// primitives w, the cell-centred field bcc and the face fields it forms,
// per direction, the PLM face states of the 5 + 2 channels, the density
// and internal-energy floors on them, and the Riemann flux (SR HLLE, SR
// LLF or Newtonian HLLD; srmhd.cuh, hlld.cuh; face_flux.cuh), and from
// the fluxes the register acc = gam0*u0 + gam1*u1 - beta_dt * div(F) (u0
// is not read when gam0 == 0).  It returns acc, the mass flux of each
// direction (the upwind selector of the corner EMFs) and the two face
// EMFs of each direction, every entry of each, ghosts included: the
// stencils wrap circularly along each axis, as the plain version's
// torch.roll does.  Plain version: ops/stage_split.py::fused_stage3d_plain.
//
// What bounds it on the H100: memory.  The function must read w, bcc,
// the face fields and u1 (and u0 when gam0 != 0) and write acc, the mass
// fluxes and the face EMFs: 30 values a cell in the first RK2 stage,
// 0.075 ms at 128^3 in float32 against 3.35 TB/s; the SR HLLE solve is
// some 375 operations a face (chip_smoke.py OPS_FACE), three faces a
// cell, 0.04 ms at the float32 peak.
//
// The first design took four launches: a flux kernel a direction (one
// thread a face over a flat index decoded with 64-bit divisions, the
// stencils read from the caches), writing the 5-channel flux to a
// scratch array, and an accumulate kernel that read it back (15 values a
// cell written and read again): 0.57 ms a call on the SR blast, 0.15 of
// it the accumulate, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
// This design is one launch over a grid of tiles (split_tile.cuh): a
// CUDA block owns a tile of TJ x TI columns of one MeshBlock, ghosts
// included, and a segment of planes, and marches through them.  For
// every plane it copies the window of the eight channels (its rows and
// columns plus the stencils' halo, wrapped) and the normal field of its
// faces into a ring of five planes by cp.async, three steps ahead, each
// thread's offsets computed once.  At plane k the block solves one work
// list of faces, x1 and x2 of plane k and x3 face k+1, in a loop a
// direction so that each face's channels and strides are constants (the
// first design's arithmetic, face_flux.cuh); it keeps the fluxes in
// shared memory, writes the mass flux and face EMFs of the faces it
// owns, and forms acc of its cells of plane k by the first design's
// differences in the same order, the register's u0 and u1 loaded while
// the faces are solved.  A tile's faces on its upper sides are computed
// by both tiles that share them, from the same inputs, so every result
// is bitwise equal to the first design's.  The SR solvers' divisions and
// square roots, at two blocks of nine warps an SM, bound it now.

#include "async_copy.cuh"
#include "common.cuh"
#include "face_flux.cuh"
#include "split_tile.cuh"

namespace athenak {
namespace {

// a direction as a type, for the face lambda
template <int D>
struct Dir {
  static constexpr int value = D;
};

// the staged channel (w 0-4, bcc 5-7) of channel c of direction D's
// frame: d, vx (normal), vy, vz, e, by, bz
template <int D>
__host__ __device__ constexpr int frame_ch(int c) {
  return c == 0   ? 0
         : c == 1 ? D + 1
         : c == 2 ? (D + 1) % 3 + 1
         : c == 3 ? (D + 2) % 3 + 1
         : c == 4 ? 4
         : c == 5 ? 5 + (D + 1) % 3
                  : 5 + (D + 2) % 3;
}

// q(c, s) of face_flux: channel c of direction D's frame at stencil
// cell s, from the ring at the cells' offsets o
template <typename T, int D, int WC>
struct FaceStencil {
  const T* ring;
  int o[4];
  __device__ __forceinline__ T operator()(int c, int s) const {
    return ring[o[s] + frame_ch<D>(c) * WC];
  }
};

template <typename T>
struct SplitArgs {
  const T *w, *bcc, *b1, *b2, *b3, *u0, *u1;
  T *acc, *fden, *femf;
};

// The register's scalars and the cell sizes, each converted once to the
// working type as the first design converted them; the step is read
// from device memory (a 0-d tensor), once a thread.
template <typename T>
struct SplitCoef {
  T gam0, gam1;
  const T* bdt;
  T dx1, dx2, dx3;
  int read_u0;
};

template <typename T, int SOLVER, int TJ, int TI, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    split_stage_kernel(SplitArgs<T> a, FluxGeom geo, Eos<T> eos,
                       SplitCoef<T> cf) {
  constexpr SplitShape H = split_shape(TJ, TI);
  constexpr int WI = H.wi, WC = H.wc, N1 = H.n1, N2 = H.n2, N3 = H.n3,
                NIT = H.nit;
  constexpr int RING = kSplitRing;
  static_assert(N3 <= NT, "one thread a cell of the tile's plane");
  const T bdt = __ldg(cf.bdt);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [RING][8][WC]
  T* const nfr = ring + RING * 8 * WC;             // [RING][NIT]
  T* const f1 = nfr + RING * NIT;                  // [5][N1]
  T* const f2 = f1 + 5 * N1;                       // [5][N2]
  T* const f3 = f2 + 5 * N2;                       // [2][5][N3]

  const FluxBox box = flux_box(geo, blockIdx.x, blockIdx.y, blockIdx.z);
  const int n3 = geo.n3, n2 = geo.n2, n1 = geo.n1;
  const int m = box.m, k0 = box.k0, k1 = box.k1, j0 = box.j0, i0 = box.i0;
  const int tid = threadIdx.x;
  const int plane = n2 * n1;
  const long long ncell = static_cast<long long>(n3) * plane;
  const long long nall = static_cast<long long>(geo.nmb) * ncell;

  // The window cells and normal-field entries this thread copies (tid,
  // tid + NT, ...), as offsets in a plane, computed once.
  constexpr int NR = (WC + NT - 1) / NT, NRF = (NIT + NT - 1) / NT;
  int woff[NR], noff[NRF];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    woff[r] = split_win(tid + r * NT < WC ? tid + r * NT : WC - 1, WI, j0, i0,
                        n2, n1);
  }
#pragma unroll
  for (int r = 0; r < NRF; ++r) {
    const int e = tid + r * NT < NIT ? tid + r * NT : NIT - 1;
    noff[r] = split_nf(split_item(e, TJ, TI), j0, i0, n2, n1);
  }
  const T* const wm = a.w + m * 5 * ncell;
  const T* const bm = a.bcc + m * 3 * ncell;
  const long long p1 = static_cast<long long>(n2) * (n1 + 1);
  const long long p2 = static_cast<long long>(n2 + 1) * n1;
  const T* const b1m = a.b1 + m * n3 * p1;
  const T* const b2m = a.b2 + m * n3 * p2;
  const T* const b3m = a.b3 + m * (n3 + 1) * static_cast<long long>(plane);

  // sequence plane q (k0-2 .. k1+1, wrapped into the block) into its
  // ring slot: the window and the normal fields of the plane's faces
  auto slot = [&](int q) { return (q - k0 + 2) % RING; };
  auto load = [&](int q) {
    const int s = slot(q), qc = split_cell(q, n3);
    T* const dst = ring + s * 8 * WC;
    const int c = qc * plane;
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int h = tid + r * NT;
      if (r == NR - 1 && h >= WC) break;
      const T* src = wm + c + woff[r];
#pragma unroll
      for (int ch = 0; ch < 5; ++ch)
        cp_async<sizeof(T)>(dst + ch * WC + h, src + ch * ncell);
      src = bm + c + woff[r];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        cp_async<sizeof(T)>(dst + (5 + ch) * WC + h, src + ch * ncell);
    }
    T* const nd = nfr + s * NIT;
#pragma unroll
    for (int r = 0; r < NRF; ++r) {
      const int e = tid + r * NT;
      if (r == NRF - 1 && e >= NIT) break;
      const T* src = e < N1        ? b1m + qc * p1
                     : e < N1 + N2 ? b2m + qc * p2
                                   : b3m + static_cast<long long>(qc) * plane;
      cp_async<sizeof(T)>(nd + e, src + noff[r]);
    }
  };

  // Face e of direction D's part of the work list at plane k (x3: face
  // k+1): the flux into f1, f2 or f3, and, for a face the tile owns, the
  // mass flux and face EMFs.
  auto face = [&](auto dir, int e, int k) {
    constexpr int D = decltype(dir)::value;
    const int it = D == 0 ? e : (D == 1 ? N1 + e : N1 + N2 + e);
    const SplitItem q = split_item(it, TJ, TI);
    int o[4];  // the stencil cells in the ring, channel 0
#pragma unroll
    for (int s = 0; s < 4; ++s)
      o[s] = (D == 2 ? slot(k - 1 + s) : slot(k)) * 8 * WC +
             (D == 1 ? q.wr + s : q.wr) * WI + (D == 0 ? q.wcol + s : q.wcol);
    constexpr int ivx = frame_ch<D>(1), ivy = frame_ch<D>(2),
                  ivz = frame_ch<D>(3);
    const T bx = nfr[(D == 2 ? slot(k + 1) : slot(k)) * NIT + it];
    T fr[5], ey, ez;
    face_flux<T, SOLVER>(FaceStencil<T, D, WC>{ring, {o[0], o[1], o[2], o[3]}},
                         bx, eos, fr, ey, ez);
    // back to conserved order: d, m1, m2, m3, E (tau under SR)
    constexpr int nd = D == 0 ? N1 : (D == 1 ? N2 : N3);
    T* const fo = D == 0 ? f1 + e
                  : D == 1 ? f2 + e
                           : f3 + ((k + 1) & 1) * 5 * N3 + e;
    fo[0] = fr[0];
    fo[ivx * nd] = fr[1];
    fo[ivy * nd] = fr[2];
    fo[ivz * nd] = fr[3];
    fo[4 * nd] = fr[4];
    const int kf = D == 2 ? k + 1 : k;
    if (split_owns(q, box, kf)) {
      const long long oc =
          m * ncell + kf * plane + (j0 + q.r) * n1 + i0 + q.c;
      a.fden[D * nall + oc] = fr[0];
      a.femf[2 * D * nall + oc] = ey;
      a.femf[(2 * D + 1) * nall + oc] = ez;
    }
  };

  // the prologue brings planes k0-2 .. k0+1 and solves the x3 faces of
  // plane k0; plane k0+2 is then in flight
  for (int q = k0 - 2; q <= k0 + 1; ++q) load(q);
  cp_async_commit();
  load(k0 + 2);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int e = tid; e < N3; e += NT) face(Dir<2>(), e, k0 - 1);

  const int r = tid / TI, c = tid % TI;
  const bool cell = tid < N3 && j0 + r < box.j1 && i0 + c < box.i1;
  for (int k = k0; k < k1; ++k) {
    // plane k+2 is in; every thread is done with plane k-1, so the slot
    // of plane k-2 takes plane k+3
    cp_async_wait<0>();
    __syncthreads();
    if (k + 3 <= k1 + 1) load(k + 3);
    cp_async_commit();
    // the register's inputs of this thread's cell, in flight during the
    // faces
    const long long o = m * 5 * ncell + k * plane + (j0 + r) * n1 + i0 + c;
    T v0[5], v1[5];
    if (cell) {
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        v1[v] = __ldg(a.u1 + o + v * ncell);
        v0[v] = cf.read_u0 ? __ldg(a.u0 + o + v * ncell) : T(0);
      }
    }
    for (int e = tid; e < N1; e += NT) face(Dir<0>(), e, k);
    for (int e = tid; e < N2; e += NT) face(Dir<1>(), e, k);
    for (int e = tid; e < N3; e += NT) face(Dir<2>(), e, k);
    __syncthreads();
    if (cell) {
      const T* const g1 = f1 + r * (TI + 1) + c;
      const T* const g2 = f2 + r * TI + c;
      const T* const g3l = f3 + (k & 1) * 5 * N3 + tid;
      const T* const g3u = f3 + ((k + 1) & 1) * 5 * N3 + tid;
#pragma unroll
      for (int v = 0; v < 5; ++v) {
        T divf = (g1[v * N1 + 1] - g1[v * N1]) / cf.dx1;
        divf = divf + (g2[v * N2 + TI] - g2[v * N2]) / cf.dx2;
        divf = divf + (g3u[v * N3] - g3l[v * N3]) / cf.dx3;
        const T reg = cf.read_u0 ? cf.gam0 * v0[v] + cf.gam1 * v1[v]
                                 : cf.gam1 * v1[v];
        a.acc[o + v * ncell] = reg - bdt * divf;
      }
    }
  }
}

template <typename T, int SOLVER>
int launch_solver(const SplitArgs<T>& a, int nmb, int n3, int n2, int n1,
                  const Eos<T>& eos, const SplitCoef<T>& cf,
                  cudaStream_t s) {
  using S = SplitTile<T>;
  auto kernel = split_stage_kernel<T, SOLVER, S::TJ, S::TI, S::NT, S::MINB>;
  const size_t smem = static_cast<size_t>(split_smem(S::TJ, S::TI)) *
                      sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        S::NT, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // kernel J's cut with the x3 halo: four planes beyond a segment's own
  const FluxGeom geo = flux_geom(nmb, n3, n2, n1, 2, S::TJ, S::TI,
                                 static_cast<long long>(sms) * per_sm);
  const dim3 grid(geo.ntj * geo.nti, geo.nseg, nmb);
  kernel<<<grid, S::NT, smem, s>>>(a, geo, eos, cf);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const SplitArgs<T>& a, int nmb, int n3, int n2, int n1,
           int solver, double gam0, double gam1, const T* beta_dt, double dx1,
           double dx2, double dx3, const Eos<T>& eos, cudaStream_t s) {
  const SplitCoef<T> cf{static_cast<T>(gam0), static_cast<T>(gam1),
                        beta_dt, static_cast<T>(dx1),
                        static_cast<T>(dx2), static_cast<T>(dx3),
                        gam0 != 0.0};
  switch (solver) {
    case kHlld:
      return launch_solver<T, kHlld>(a, nmb, n3, n2, n1, eos, cf, s);
    case kSrHlle:
      return launch_solver<T, kSrHlle>(a, nmb, n3, n2, n1, eos, cf, s);
    case kSrLlf:
      return launch_solver<T, kSrLlf>(a, nmb, n3, n2, n1, eos, cf, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace athenak

#define ATHENAK_FUSED_STAGE_ENTRY(NAME, T)                                    \
  extern "C" int NAME(const void* w, const void* bcc, const void* b1,         \
                      const void* b2, const void* b3, const void* u0,         \
                      const void* u1, void* acc, void* fden, void* femf,      \
                      int nmb, int n3, int n2, int n1, int solver,            \
                      double gam0, double gam1, const void* beta_dt,          \
                      double dx1,                                             \
                      double dx2, double dx3, double gamma, double dfloor,    \
                      double pfloor, void* stream) {                          \
    using namespace athenak;                                                  \
    const SplitArgs<T> a{                                                     \
        static_cast<const T*>(w),  static_cast<const T*>(bcc),                \
        static_cast<const T*>(b1), static_cast<const T*>(b2),                 \
        static_cast<const T*>(b3), static_cast<const T*>(u0),                 \
        static_cast<const T*>(u1), static_cast<T*>(acc),                      \
        static_cast<T*>(fden),     static_cast<T*>(femf)};                    \
    return launch<T>(a, nmb, n3, n2, n1, solver, gam0, gam1,                  \
                     static_cast<const T*>(beta_dt), dx1,                     \
                     dx2, dx3,                                                \
                     make_eos<T>(gamma, dfloor, pfloor, 0.0, 0.0, 1.0),       \
                     static_cast<cudaStream_t>(stream));                      \
  }

ATHENAK_FUSED_STAGE_ENTRY(athenak_fused_stage_f32, float)
ATHENAK_FUSED_STAGE_ENTRY(athenak_fused_stage_f64, double)
