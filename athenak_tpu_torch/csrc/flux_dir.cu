// Kernel J: the PLM + face-floor + HLLD fluxes of one direction.
//
// Replaces athenak_tpu/ops/pallas_flux.py::fused_plm_hlld_lanes (its
// kernel, _make_kernel) and the dispatcher fused_flux_dir, which the JAX
// package's MHD.fluxes calls for every deck the stage kernels do not
// take (statically refined meshes, 2-D decks).  From the primitives w
// [nmb, 5, n3, n2, n1], the cell-centred field bcc [nmb, 3, ...] and
// the face array of the direction (x1f [nmb, n3, n2, n1+1] for x1,
// read at the lower face of each cell), it forms the PLM (van Leer) face
// states of the 5 + 2 channels along the direction, floors the density
// and the internal energy pfloor / (gamma - 1) on both sides, and
// solves HLLD (hlld.cuh).  It writes the flux [nmb, 5, n3, n2, n1] in
// conserved order and the two face EMFs ey = -F(B_y), ez = F(B_z) [nmb,
// n3, n2, n1]; face i is the lower face of cell i.  Every entry is
// written: the stencil wraps circularly at the block edges, as the plain
// version's torch.roll does, so the whole output arrays agree.  Plain
// version: ops/flux.py::flux_dir_plain.
//
// What bounds it on the H100: it must read the 5 channels of w, the two
// transverse channels of bcc and the normal field (8 values a face; the
// normal channel of bcc is not read, HLLD takes the face field instead)
// and write the flux and the two EMFs (7): 15 x 4 bytes a cell in
// float32, 0.100 ms for 5.6 M cells against 3.35 TB/s; the HLLD
// arithmetic is a few hundred operations a face, with a dozen IEEE
// divisions and square roots.
//
// The first design (one thread a face over a flat index) decoded each
// index with four 64-bit divisions by runtime values and read each
// stencil value four times from the caches, the x3 stencil planes 5 KB
// apart.  This design is one launch over a grid of tiles (flux_tile.cuh:
// tiles of TJ x TI columns x MeshBlock x k segment, no division by a
// runtime value but the tile's two): a block marches through its planes
// and copies each plane's stencil window of the seven channels and the
// normal field of its faces into shared memory by cp.async, one plane
// ahead of use, so each value is read from device memory about once; x3
// keeps a ring of the four planes its stencil spans.  Each thread's copy
// offsets in a plane are computed once: computing them for every copy
// left x1 and x2 no faster than the first design.  One thread computes
// the face of one column of each plane.  The arithmetic is the
// first design's, term by term (plm_face, the face floors, hlld.cuh), so
// the results are bitwise equal.

#include "async_copy.cuh"
#include "common.cuh"
#include "flux_tile.cuh"
#include "hlld.cuh"
#include "stencil.cuh"

namespace athenak {
namespace {

template <typename T, int DIR, int TJ, int TI, int MINB>
__global__ void __launch_bounds__(TJ * TI, MINB)
    flux_tile_kernel(FluxGeom geo, Eos<T> eos, const T* __restrict__ w,
                     const T* __restrict__ bcc,
                     const T* __restrict__ bnorm, T* __restrict__ flx,
                     T* __restrict__ ey, T* __restrict__ ez) {
  constexpr FluxWin W = flux_window(DIR, TJ, TI);
  constexpr int WC = W.nj * W.ni;  // window cells of a plane
  constexpr int NT = TJ * TI;
  constexpr int RING = flux_ring(DIR);
  constexpr int KB = -W.k_lo, KA = W.k_hi;  // planes below and above
  static_assert(RING == KB + KA + 2, "the window's planes and one more");
  // rotated frame: ivx normal, (ivy, ivz) transverse; B likewise
  constexpr int ivx = DIR + 1;
  constexpr int ivy = (DIR + 1) % 3 + 1;
  constexpr int ivz = (DIR + 2) % 3 + 1;
  constexpr int iby = (DIR + 1) % 3;
  constexpr int ibz = (DIR + 2) % 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const ring = reinterpret_cast<T*>(smem_raw);  // [RING][7][WC]
  T* const nfs = ring + RING * 7 * WC;             // [RING][NT]

  const FluxBox box = flux_box(geo, blockIdx.x, blockIdx.y, blockIdx.z);
  const int n3 = geo.n3, n2 = geo.n2, n1 = geo.n1;
  const int m = box.m, k0 = box.k0, k1 = box.k1;
  const int j0 = box.j0, i0 = box.i0;
  const int tid = threadIdx.x;
  const int jr = tid / TI, ir = tid % TI;
  const long long ncell = static_cast<long long>(n3) * n2 * n1;
  const int plane = n2 * n1;

  // Each thread copies the window cells tid, tid + NT, ...: their offsets
  // in a plane, computed once.
  constexpr int NR = (WC + NT - 1) / NT;
  int inplane[NR];
  for (int r = 0; r < NR; ++r) {
    const int h = tid + r * NT < WC ? tid + r * NT : WC - 1;
    const int j = flux_cell(j0 + W.j_lo + h / W.ni, n2, DIR == 1);
    const int i = flux_cell(i0 + W.i_lo + h % W.ni, n1, DIR == 0);
    inplane[r] = j * n1 + i;
  }
  const T* const wm = w + static_cast<long long>(m) * 5 * ncell;
  const T* const bm = bcc + (static_cast<long long>(m) * 3 + iby) * ncell;
  constexpr int DBZ = ibz - iby;
  // the normal field of this thread's face of plane q: nf + q * nf_plane
  const int jc = j0 + jr < n2 ? j0 + jr : n2 - 1;
  const int ic = i0 + ir < n1 ? i0 + ir : n1 - 1;
  const long long nf_plane = DIR == 0   ? static_cast<long long>(n2) * (n1 + 1)
                             : DIR == 1 ? static_cast<long long>(n2 + 1) * n1
                                        : static_cast<long long>(plane);
  const T* const nf =
      bnorm + static_cast<long long>(m) * (DIR == 2 ? n3 + 1 : n3) * nf_plane +
      static_cast<long long>(jc) * (DIR == 0 ? n1 + 1 : n1) + ic;

  // the window of sequence position q (plane q; along x3 the march's
  // positions run from k0 - 2 to k1, wrapped into [0, n3)) and, on the
  // block's own planes, the normal field of its faces, into slot
  // (q - k0 + KB) % RING
  auto load = [&](int q) {
    const int slot = (q - k0 + KB) % RING;
    const long long c =
        static_cast<long long>(flux_cell(q, n3, DIR == 2)) * plane;
    T* const dst = ring + slot * 7 * WC;
    for (int r = 0; r < NR; ++r) {
      const int h = tid + r * NT;
      if (h >= WC) break;
      const T* src = wm + c + inplane[r];
      for (int ch = 0; ch < 5; ++ch)
        cp_async<sizeof(T)>(dst + ch * WC + h, src + ch * ncell);
      src = bm + c + inplane[r];
      cp_async<sizeof(T)>(dst + 5 * WC + h, src);
      cp_async<sizeof(T)>(dst + 6 * WC + h, src + DBZ * ncell);
    }
    if (q >= k0 && q < k1)
      cp_async<sizeof(T)>(nfs + slot * NT + tid, nf + q * nf_plane);
  };

  // the prologue brings the window of the first plane and the position
  // after it; each step then waits for its own window, computes, and
  // copies the position two ahead into the slot it has just freed
  for (int q = k0 - KB; q <= k0 + KA; ++q) load(q);
  cp_async_commit();
  if (k0 + KA + 1 <= k1 - 1 + KA) load(k0 + KA + 1);
  cp_async_commit();
  const bool active = j0 + jr < box.j1 && i0 + ir < box.i1;
  for (int k = k0; k < k1; ++k) {
    cp_async_wait<1>();
    __syncthreads();
    if (active) {
      // the stencil's four cells in the ring
      int o[4];
      for (int s = 0; s < 4; ++s) {
        if (DIR == 0)
          o[s] = ((k - k0 + KB) % RING) * 7 * WC + jr * W.ni + ir + s;
        else if (DIR == 1)
          o[s] = ((k - k0 + KB) % RING) * 7 * WC + (jr + s) * W.ni + ir;
        else
          o[s] = ((k - k0 + s) % RING) * 7 * WC + jr * W.ni + ir;
      }
      auto recon = [&](int ch, T& ql, T& qr) {
        const T* q = ring + ch * WC;
        plm_face(q[o[0]], q[o[1]], q[o[2]], q[o[3]], ql, qr);
      };
      FaceState<T> L, R;
      recon(0, L.d, R.d);
      recon(ivx, L.vx, R.vx);
      recon(ivy, L.vy, R.vy);
      recon(ivz, L.vz, R.vz);
      recon(4, L.e, R.e);
      recon(5, L.by, R.by);
      recon(6, L.bz, R.bz);
      // face-state floors (pallas_stage.py::_floors)
      L.d = tmax(L.d, eos.dfloor);
      R.d = tmax(R.d, eos.dfloor);
      L.e = tmax(L.e, eos.efloor);
      R.e = tmax(R.e, eos.efloor);
      const T bx = nfs[((k - k0 + KB) % RING) * NT + tid];
      T fr[5], fby, fbz;
      hlld(L, R, bx, eos, fr, fby, fbz);
      // back to conserved order: d, m1, m2, m3, E
      const long long oc = static_cast<long long>(m) * ncell +
                           static_cast<long long>(k) * plane + jc * n1 + ic;
      T* const fo = flx + static_cast<long long>(m) * 4 * ncell + oc;
      fo[0] = fr[0];
      fo[ivx * ncell] = fr[1];
      fo[ivy * ncell] = fr[2];
      fo[ivz * ncell] = fr[3];
      fo[4 * ncell] = fr[4];
      ey[oc] = -fby;
      ez[oc] = fbz;
    }
    __syncthreads();
    if (k + 2 + KA <= k1 - 1 + KA) load(k + 2 + KA);
    cp_async_commit();
  }
}

template <typename T, int DIR>
int launch_dir(const T* w, const T* bcc, const T* bnorm, T* flx, T* ey,
               T* ez, int nmb, int n3, int n2, int n1, Eos<T> eos,
               cudaStream_t s) {
  using S = FluxTile<T>;
  auto kernel = flux_tile_kernel<T, DIR, S::TJ, S::TI, S::MINB>;
  constexpr int NT = S::TJ * S::TI;
  const size_t smem =
      static_cast<size_t>(flux_smem(DIR, S::TJ, S::TI)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT,
                                                        smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const FluxGeom geo = flux_geom(nmb, n3, n2, n1, DIR, S::TJ, S::TI,
                                 static_cast<long long>(sms) * per_sm);
  const dim3 grid(geo.ntj * geo.nti, geo.nseg, nmb);
  kernel<<<grid, NT, smem, s>>>(geo, eos, w, bcc, bnorm, flx, ey, ez);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* w, const T* bcc, const T* bnorm, T* flx, T* ey, T* ez,
           int nmb, int n3, int n2, int n1, int dir, Eos<T> eos,
           cudaStream_t s) {
  switch (dir) {
    case 0:
      return launch_dir<T, 0>(w, bcc, bnorm, flx, ey, ez, nmb, n3, n2, n1,
                              eos, s);
    case 1:
      return launch_dir<T, 1>(w, bcc, bnorm, flx, ey, ez, nmb, n3, n2, n1,
                              eos, s);
    case 2:
      return launch_dir<T, 2>(w, bcc, bnorm, flx, ey, ez, nmb, n3, n2, n1,
                              eos, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace athenak

#define ATHENAK_FLUX_DIR_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void* w, const void* bcc, const void* bnorm,     \
                      void* flx, void* ey, void* ez, int nmb, int n3, int n2, \
                      int n1, int dir, double gamma, double dfloor,          \
                      double pfloor, void* stream) {                         \
    using namespace athenak;                                                 \
    return launch<T>(static_cast<const T*>(w), static_cast<const T*>(bcc),   \
                     static_cast<const T*>(bnorm), static_cast<T*>(flx),     \
                     static_cast<T*>(ey), static_cast<T*>(ez), nmb, n3, n2,  \
                     n1, dir,                                                \
                     make_eos<T>(gamma, dfloor, pfloor, 0.0, 0.0, 1.0),      \
                     static_cast<cudaStream_t>(stream));                     \
  }

ATHENAK_FLUX_DIR_ENTRY(athenak_flux_dir_f32, float)
ATHENAK_FLUX_DIR_ENTRY(athenak_flux_dir_f64, double)
