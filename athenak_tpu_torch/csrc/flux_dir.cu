// Kernel J: the PLM + face-floor + HLLD fluxes of one direction.
//
// Replaces athenak_tpu/ops/pallas_flux.py::fused_plm_hlld_lanes (its
// kernel, _make_kernel) and the dispatcher fused_flux_dir, which the JAX
// package's MHD.fluxes calls for every deck the stage kernels do not
// take (statically refined meshes, 2-D decks).  From the primitives w
// [nmb, 5, n3, n2, n1], the cell-centred field bcc [nmb, 3, ...] and
// the face array of the direction (x1f [nmb, n3, n2, n1+1] for x1,
// read at the lower face of each cell), it forms the PLM (van Leer) face
// states of the 5 + 3 channels along the direction, floors the density
// and the internal energy pfloor / (gamma - 1) on both sides, and
// solves HLLD (hlld.cuh).  It writes the flux [nmb, 5, n3, n2, n1] in conserved
// order and the two face EMFs ey = -F(B_y), ez = F(B_z) [nmb, n3, n2,
// n1]; face i is the lower face of cell i.  Plain version:
// ops/flux.py::flux_dir_plain.
//
// Design: one launch per direction, one thread per face: kernel C's
// per-direction flux kernel (face_flux.cuh) without the mass flux.  The
// stencil is read along the direction by stride; the TPU kernel's
// transposes, which bring the stencil onto the lane axis, serve nothing
// on the card.  The stencil wraps circularly at the block edges (a
// modular index), as the plain version's torch.roll does, so the whole
// output arrays agree.
//
// What bounds it on the H100: it must read the 5 channels of w, the two
// transverse channels of bcc and the normal field (8 values a face; the
// normal channel of bcc is not read, HLLD takes the face field instead)
// and write the flux and the two EMFs (7): 15 x 4 bytes a cell in
// float32, 0.100 ms for 5.6 M cells against 3.35 TB/s; the HLLD
// arithmetic is a few hundred operations a face.

#include "common.cuh"
#include "face_flux.cuh"
#include "stencil.cuh"

namespace athenak {
namespace {

template <typename T>
int launch(const T* w, const T* bcc, const T* bnorm, T* flx, T* ey, T* ez,
           int nmb, int n3, int n2, int n1, int dir, Eos<T> eos,
           cudaStream_t s) {
  Dims g{nmb, n3, n2, n1, 2, static_cast<long long>(n3) * n2 * n1};
  const unsigned int grid = grid_for(nmb * g.ncell);
  switch (dir) {
    case 0:
      flux_kernel<T, 0, kHlld><<<grid, kThreads, 0, s>>>(
          g, eos, w, bcc, bnorm, flx, nullptr, ey, ez);
      break;
    case 1:
      flux_kernel<T, 1, kHlld><<<grid, kThreads, 0, s>>>(
          g, eos, w, bcc, bnorm, flx, nullptr, ey, ez);
      break;
    case 2:
      flux_kernel<T, 2, kHlld><<<grid, kThreads, 0, s>>>(
          g, eos, w, bcc, bnorm, flx, nullptr, ey, ez);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
