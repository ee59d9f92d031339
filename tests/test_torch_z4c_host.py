"""The CUDA stage kernel's arithmetic, built for the host with g++.

``csrc/z4c_rhs.cuh`` is plain C++ apart from CUDA's function qualifiers,
``__ldg`` and the kernel with its launch (which it keeps behind
``__CUDACC__``).  Through a small shim header standing for
``cuda_runtime.h`` this file compiles the kernel's per-thread functions
for the CPU and replays the kernel block by block (``run_tiles``: each
channel's window copied, the inner pass of the mixed derivatives, every
thread's derivatives, then every thread's algebra; float and double on
the kernel's boxes, ``csrc/z4c_tile.cuh``), and holds it against the
plain torch stage (``ops/z4c_stage.py``) on the 16^3 single-puncture
deck:

  * on the bench deck's options every channel that AlgConstr leaves
    alone is bitwise equal to the plain version, in float32 and float64:
    the kernel keeps rhs_core's operation order term by term;
  * every channel agrees to 1e-6 (float32) and 1e-13 (float64) of
    max(|value|, 1): the conformal metric and A_ij pass through the cube
    root (``cbrt`` in the kernel, ``x ** (1/3)`` in torch), and with
    chi_psi_power != -4 the conformal factor through ``pow``.

The instances with the matter source are held alike, given a seeded
physical stress-energy (``physical_tmunu``) at nghost 4 (the coupled
TOV decks' depth): the channels AlgConstr leaves alone bitwise, all to
the same tolerances, on the four RK4 stages.

With a counting number type in place of the float, on boxes of one cell
(so that a block's operations are one cell's, its inner derivatives
included), it also counts the kernel's operations a cell (add, subtract,
multiply, divide, negate; pow and cbrt count one), the numbers
``chip_smoke.py`` takes for the kernel's bound, and the operations the
matter source adds.  The test skips where no
g++ is installed.  This checks the source's arithmetic, not the CUDA
build: the card runs the same checks in ``tests/test_torch_cuda.py``.
"""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.driver import make_integrator  # noqa: E402
from athenak_tpu_torch.ops import z4c_stage  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "athenak_tpu_torch", "csrc")
PUNCTURE = os.path.join(ROOT, "inputs", "z4c", "one_puncture.athinput")
SMALL = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16", "z4c/diss=0.5"]
GAUGE = ["z4c/shift_H=0.5", "z4c/shift_alpha2Gamma=0.3",
         "z4c/lapse_harmonic=0.4", "z4c/damp_kappa2=0.1",
         "z4c/chi_psi_power=-2.0"]
PERIODIC = [f"mesh/{s}{a}_bc=periodic" for a in ("x1", "x2", "x3")
            for s in ("i", "o")]
CBRT_CHANNELS = list(range(1, 7)) + list(range(8, 14))

SHIM = r"""
#pragma once
#include <cmath>
using std::cbrt;
using std::pow;
using std::sqrt;
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __launch_bounds__(x)
typedef void* cudaStream_t;
template <class T> inline T __ldg(const T* p) { return *p; }
"""

HARNESS = r"""
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <type_traits>
#include <vector>
#include "z4c_rhs.cuh"

namespace cnt {  // a number type that counts the operations done on it
long long n = 0;
struct Op {
  double v;
  Op() : v(0) {}
  Op(double x) : v(x) {}
};
inline Op operator+(Op a, Op b) { ++n; return Op(a.v + b.v); }
inline Op operator-(Op a, Op b) { ++n; return Op(a.v - b.v); }
inline Op operator*(Op a, Op b) { ++n; return Op(a.v * b.v); }
inline Op operator/(Op a, Op b) { ++n; return Op(a.v / b.v); }
inline Op operator-(Op a) { ++n; return Op(-a.v); }
inline bool operator<(Op a, Op b) { return a.v < b.v; }
inline bool operator>(Op a, Op b) { return a.v > b.v; }
inline bool operator!=(Op a, Op b) { return a.v != b.v; }
inline Op cbrt(Op a) { ++n; return Op(std::cbrt(a.v)); }
inline Op tpow(Op a, Op b) { ++n; return Op(std::pow(a.v, b.v)); }
inline Op cD1(Op, int ng, int q) { return Op(athenak::cD1(0.0, ng, q)); }
inline Op cD2(Op, int ng, int q) { return Op(athenak::cD2(0.0, ng, q)); }
inline Op cAdv(Op, int ng, int q) { return Op(athenak::cAdv(0.0, ng, q)); }
inline Op cDiss(Op, int ng, int q) {
  return Op(athenak::cDiss(0.0, ng, q));
}
}  // namespace cnt

using namespace athenak;

template <class T>
std::vector<T> rd(FILE* f, size_t n) {
  std::vector<double> d(n);
  if (fread(d.data(), 8, n, f) != n) abort();
  std::vector<T> o(n);
  for (size_t i = 0; i < n; ++i) o[i] = T(d[i]);
  return o;
}

template <class T>
double val(T x) { return static_cast<double>(x); }
template <>
double val(cnt::Op x) { return x.v; }

// The whole grid, CUDA block by CUDA block, as z4c_tile_kernel runs it:
// for each channel the window (a plain copy for cp.async), the inner pass
// and every thread's derivatives, then every thread's update; returns
// the operations of the last block.
template <class T, class Sh>
long long run_tiles(const std::vector<T>& u, const std::vector<T>& u1,
                    const std::vector<T>& sbc, const std::vector<T>& mat,
                    std::vector<T>& out, const int* h, const Z4cPrm<T>& P) {
  const int nmb = h[2], n3 = h[3], n2 = h[4], n1 = h[5], has_sbc = h[6];
  const int has_mat = h[7];
  const long long cs = (long long)n3 * n2 * n1;
  const Z4cGeom geo = z4c_geom(nmb, n3, n2, n1, Sh::NG, Sh::TX, Sh::TY,
                               Sh::TZ);
  std::vector<T> buf((size_t)kZ4cSlots * Sh::NC), win(Sh::WIN),
      d1x(Sh::NXD), d1y(Sh::NYD);
  std::vector<Z4cSomm<T>> sb(Sh::NC);
  std::vector<T> beta(3 * Sh::NC), gu(9 * Sh::NC);
  std::vector<long long> cell(Sh::NC);
  long long ops = 0;
  for (long long blk = 0; blk < geo.blocks; ++blk) {
    cnt::n = 0;
    const Z4cBox box = z4c_box(geo, blk);
    const long long mb = (long long)box.m * kNZ4C * cs;
    for (int t = 0; t < Sh::NC; ++t) {
      const Z4cCellPos q = z4c_cell_pos<Sh>(t);
      const int k = std::min(box.k0 + q.z, n3 - 1);
      const int j = std::min(box.j0 + q.y, n2 - 1);
      const int i = std::min(box.i0 + q.x, n1 - 1);
      cell[t] = ((long long)k * n2 + j) * n1 + i;
      for (int d = 0; d < 3; ++d)
        beta[3 * t + d] = u[mb + (I_BETAX + d) * cs + cell[t]];
      T g[3][3];
      for (int a = 0; a < 3; ++a)
        for (int d = 0; d < 3; ++d)
          g[a][d] = u[mb + (I_GXX + S(a, d)) * cs + cell[t]];
      z4c_inverse_metric(g, reinterpret_cast<T(*)[3]>(&gu[9 * t]));
      sb[t].on = false;
      if (has_sbc) {
        const long long s = (long long)box.m * 5 * cs + cell[t];
        sb[t].on = val(sbc[s]) != 0.0;
        if (sb[t].on) {
          sb[t].rad = sbc[s + cs];
          for (int d = 0; d < 3; ++d) sb[t].s_u[d] = sbc[s + (2 + d) * cs];
        }
      }
    }
    for (int c = 0; c < kNZ4C; ++c) {
      for (int w = 0; w < Sh::WIN; ++w)
        win[w] = u[mb + c * cs + z4c_src<Sh>(geo, box, w)];
      if (z4c_mixed(c))
        for (int p = 0; p < Sh::NP; ++p)
          z4c_inner<T, Sh>(p, (const T*)win.data(), d1x.data(), d1y.data(),
                           P);
      for (int t = 0; t < Sh::NC; ++t) {
        const Z4cCellPos q = z4c_cell_pos<Sh>(t);
        z4c_derivs<T, Sh>(c, (const T*)win.data() + q.win,
                          d1x.data() + q.dx, d1y.data() + q.dy, P,
                          &beta[3 * t],
                          reinterpret_cast<const T(*)[3]>(&gu[9 * t]), sb[t],
                          buf.data() + t);
      }
    }
    for (int t = 0; t < Sh::NC; ++t) {
      const Z4cCellPos q = z4c_cell_pos<Sh>(t);
      if (box.k0 + q.z >= box.k1 || box.j0 + q.y >= box.j1 ||
          box.i0 + q.x >= box.i1)
        continue;
      const T* mc = has_mat ? mat.data() + (long long)box.m * kNMat * cs +
                                  cell[t]
                            : nullptr;
      const Z4cCell<T, Sh::NC> F{buf.data() + t, u.data() + mb + cell[t], cs,
                                 sb[t].on, mc};
      const T(*g)[3] = reinterpret_cast<const T(*)[3]>(&gu[9 * t]);
      if (has_mat)
        z4c_update<T, true>(F, P, g, u1.data() + mb + cell[t], cs,
                            out.data() + mb + cell[t]);
      else
        z4c_update<T>(F, P, g, u1.data() + mb + cell[t], cs,
                      out.data() + mb + cell[t]);
    }
    ops = cnt::n;
  }
  return ops;
}

// float and double on the kernel's boxes; the counting type on boxes of
// one cell, so that a block's operations are those of one cell
template <class T, int NG>
long long run(FILE* f, FILE* o, const int* h, const double* prm) {
  const int nmb = h[2], n3 = h[3], n2 = h[4], n1 = h[5], has_sbc = h[6];
  const size_t n = (size_t)nmb * 22 * n3 * n2 * n1;
  const size_t ns = (size_t)nmb * 5 * n3 * n2 * n1;
  const size_t nm = (size_t)nmb * kNMat * n3 * n2 * n1;
  std::vector<T> u = rd<T>(f, n), u1 = rd<T>(f, n), sbc, mat;
  if (has_sbc) sbc = rd<T>(f, ns);
  if (h[7]) mat = rd<T>(f, nm);
  std::vector<T> out(n, T(0.0));
  Z4cPrm<T> P = make_z4c_prm<T>(prm);
  P.bdt = static_cast<T>(prm[P_COUNT]);  // the step, which the kernel reads
                                         // from device memory
  long long ops;
  if constexpr (std::is_same<T, cnt::Op>::value)
    ops = run_tiles<T, Z4cShape<1, 1, 1, NG, 2>>(u, u1, sbc, mat, out, h, P);
  else
    ops = run_tiles<T, Z4cTile<T, NG>>(u, u1, sbc, mat, out, h, P);
  std::vector<double> d(n);
  for (size_t i = 0; i < n; ++i) d[i] = val(out[i]);
  fwrite(d.data(), 8, n, o);
  return ops;
}

template <int NG>
long long dispatch(FILE* f, FILE* o, const int* h, const double* prm) {
  if (h[0] == 0) return run<float, NG>(f, o, h, prm);
  if (h[0] == 1) return run<double, NG>(f, o, h, prm);
  return run<cnt::Op, NG>(f, o, h, prm);
}

int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  FILE* o = fopen(argv[2], "wb");
  int h[8];  // type (0 float, 1 double, 2 counting), ng, nmb, n3, n2, n1,
             // Sommerfeld geometry given, stress-energy given
  if (fread(h, 4, 8, f) != 8) return 1;
  double prm[P_COUNT + 1];  // the parameter block, then the step
  if (fread(prm, 8, P_COUNT + 1, f) != P_COUNT + 1) return 1;
  long long ops = 0;
  switch (h[1]) {
    case 2: ops = dispatch<2>(f, o, h, prm); break;
    case 3: ops = dispatch<3>(f, o, h, prm); break;
    case 4: ops = dispatch<4>(f, o, h, prm); break;
    case 5: ops = dispatch<5>(f, o, h, prm); break;
    default: return 1;
  }
  fclose(o);
  printf("%lld\n", ops);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("z4c_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", f"-I{d}", f"-I{CSRC}", "-o",
                    str(exe), str(d / "harness.cpp")], check=True,
                   capture_output=True, timeout=300)
    return exe


def run_harness(exe, kind, phys, u, u1, sbc, prm, mat=None):
    """Run the host build of kernel H on (u, u1), with the matter source
    where ``mat`` (the stacked stress-energy) is given; returns (out, the
    operations of the last cell)."""
    d = exe.parent
    nmb, _, n3, n2, n1 = u.shape
    with open(d / "in.bin", "wb") as f:
        f.write(struct.pack("8i", kind, phys.ng, nmb, n3, n2, n1,
                            int(sbc is not None), int(mat is not None)))
        f.write(np.asarray(prm, np.float64).tobytes())
        for a in (u, u1) + tuple(x for x in (sbc, mat) if x is not None):
            f.write(np.ascontiguousarray(a, np.float64).tobytes())
    res = subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")],
                         check=True, capture_output=True, text=True,
                         timeout=300)
    out = np.fromfile(d / "out.bin").reshape(u.shape)
    return out, int(res.stdout)


def _phys(extra, prec="double"):
    pin = ParameterInput.from_file(PUNCTURE)
    pin.modify_from_cmdline(SMALL + [f"job/precision={prec}"] + list(extra))
    _, phys, _, driver, st = torch_main.build(pin, device="cpu")
    return phys, driver.initialize(st)["u"].double().numpy()


@pytest.mark.parametrize("prec", ["single", "double"])
@pytest.mark.parametrize("case", ["outflow_ng2", "periodic_ng3"])
def test_host_build_matches_plain_stage(harness, case, prec):
    extra = (["mesh/nghost=2"] if case == "outflow_ng2"
             else ["mesh/nghost=3"] + PERIODIC + GAUGE)
    phys, u = _phys(extra, prec)
    dtype = phys.dtype
    rng = np.random.default_rng(9)
    u = u + 1e-2 * rng.normal(size=u.shape)      # the shift takes both signs
    u1 = u * (1.0 + 1e-3 * rng.normal(size=u.shape))
    ut = torch.tensor(u, dtype=dtype)
    u1t = torch.tensor(u1, dtype=dtype)
    sbc = None if phys.sbc_mask is None else \
        phys.sbc_channels("cpu", dtype).double().numpy()
    rk4 = make_integrator("rk4")
    ng = phys.ng
    core = (slice(None), slice(None), slice(ng, -ng), slice(ng, -ng),
            slice(ng, -ng))
    tol = 1e-6 if prec == "single" else 1e-13
    for s in (0, 1, 3):     # stage 3's coefficients flip det g's sign
        g0, g1 = rk4.gam0[s], rk4.gam1[s]
        bdt = float(torch.tensor(rk4.beta[s] * 0.1, dtype=dtype))
        want = z4c_stage.fused_z4c_stage_plain(ut, u1t, phys, g0, g1, bdt)
        want = want.double().numpy()[core]
        got, _ = run_harness(harness, 0 if prec == "single" else 1, phys,
                             ut.double().numpy(), u1t.double().numpy(), sbc,
                             z4c_stage.stage_params(phys, g0, g1) + [bdt])
        got = got[core]
        if case == "outflow_ng2":
            # chi^1 is a copy in both; the other decks' chi^p is a pow,
            # which may round apart too
            others = [c for c in range(22) if c not in CBRT_CHANNELS]
            np.testing.assert_array_equal(got[:, others], want[:, others])
        err = (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max()
        assert err <= tol, (s, err)


@pytest.mark.parametrize("ng", [2, 3, 4, 5])
def test_operation_counts(harness, ng):
    """Operations of one cell, and of one cell of the Sommerfeld mask, on
    the bench deck's options: the numbers chip_smoke.py bounds with."""
    pin = ParameterInput.from_string(chip_smoke.Z4C_DECK)
    pin.modify_from_cmdline([f"mesh/nghost={ng}", "mesh/nx1=16",
                             "mesh/nx2=16", "mesh/nx3=16"])
    _, phys, _, _, _ = torch_main.build(pin, device="cpu")
    n = 2 * ng + 1                                  # one interior cell
    u = np.zeros((1, 22, n, n, n))
    u[:, [0, 1, 4, 6, 18]] = 1.0                    # chi, g = 1, alpha
    prm = z4c_stage.stage_params(phys, 0.5, 0.5) + [0.1]
    sbc = np.ones((1, 5, n, n, n))
    _, plain = run_harness(harness, 2, phys, u, u, None, prm)
    _, somm = run_harness(harness, 2, phys, u, u, sbc, prm)
    assert chip_smoke.Z4C_OPS[ng] == (plain, somm - plain)


def physical_tmunu(shape, seed):
    """A seeded stress-energy for a Z4c state of ``shape`` [nmb, 22, n3,
    n2, n1]: numpy float64 [nmb, 10, n3, n2, n1] in the order the kernel
    reads (E, S_d, S_dd xx xy xz yy yz zz), of physical form: E in [0.01,
    0.1], S_d = E v with |v_a| <= 0.5, S_dd = E (p delta + v v) with p in
    [0.1, 0.3], symmetric and every component bounded by E."""
    rng = np.random.default_rng(seed)
    cells = (shape[0],) + tuple(shape[2:])
    E = rng.uniform(0.01, 0.1, cells)
    v = rng.uniform(-0.5, 0.5, (3,) + cells)
    p = rng.uniform(0.1, 0.3, cells)
    pairs = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
    chans = [E] + [E * v[a] for a in range(3)] + [
        E * ((p if a == b else 0.0) + v[a] * v[b]) for a, b in pairs]
    return np.stack(chans, axis=1)


def tmunu_dict(mat):
    """The stress-energy dict (as ``DynGRMHD.set_tmunu`` returns it) of a
    stacked [nmb, 10, ...] tensor in ``physical_tmunu``'s order (views)."""
    return {"E": mat[:, 0], "S_d": [mat[:, 1 + a] for a in range(3)],
            "S_dd": [mat[:, 4 + q] for q in range(6)]}


@pytest.mark.parametrize("prec", ["single", "double"])
def test_host_build_matter_matches_plain_stage(harness, prec):
    """The instances with the matter source against the plain stage with
    the same stress-energy, on the four RK4 stages at nghost 4: bitwise
    where AlgConstr takes no cube root, else to 1e-6 (float32) and 1e-13
    (float64) of max(|value|, 1); the source moves every channel it
    feeds beyond those."""
    phys, u = _phys(["mesh/nghost=4"], prec)
    dtype = phys.dtype
    rng = np.random.default_rng(11)
    u = u + 1e-2 * rng.normal(size=u.shape)
    u1 = u * (1.0 + 1e-3 * rng.normal(size=u.shape))
    ut, u1t = torch.tensor(u, dtype=dtype), torch.tensor(u1, dtype=dtype)
    mat = torch.tensor(physical_tmunu(u.shape, 5), dtype=dtype)
    sbc = phys.sbc_channels("cpu", dtype).double().numpy()
    rk4 = make_integrator("rk4")
    core = (slice(None), slice(None)) + (slice(4, -4),) * 3
    tol = 1e-6 if prec == "single" else 1e-13
    others = [c for c in range(22) if c not in CBRT_CHANNELS]
    fed = [7, 14, 15, 16, 17] + list(range(8, 14))
    for s in range(4):
        g0, g1 = rk4.gam0[s], rk4.gam1[s]
        bdt = float(torch.tensor(rk4.beta[s] * 0.1, dtype=dtype))
        want = z4c_stage.fused_z4c_stage_plain(ut, u1t, phys, g0, g1, bdt,
                                               tmunu=tmunu_dict(mat))
        vac = z4c_stage.fused_z4c_stage_plain(ut, u1t, phys, g0, g1, bdt)
        want = want.double().numpy()[core]
        vac = vac.double().numpy()[core]
        got, _ = run_harness(harness, 0 if prec == "single" else 1, phys,
                             ut.double().numpy(), u1t.double().numpy(), sbc,
                             z4c_stage.stage_params(phys, g0, g1) + [bdt],
                             mat=mat.double().numpy())
        got = got[core]
        np.testing.assert_array_equal(got[:, others], want[:, others])
        err = (np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max()
        assert err <= tol, (s, err)
        moved = (np.abs(want - vac) / np.maximum(np.abs(want), 1.0))
        assert all(moved[:, c].max() > 100 * tol for c in fed), s


@pytest.mark.parametrize("ng", [2, 4])
def test_matter_operation_counts(harness, ng):
    """The operations the matter source adds a cell, on and off the
    Sommerfeld mask: chip_smoke.Z4C_MATTER_OPS, whatever the depth."""
    pin = ParameterInput.from_string(chip_smoke.Z4C_DECK)
    pin.modify_from_cmdline([f"mesh/nghost={ng}", "mesh/nx1=16",
                             "mesh/nx2=16", "mesh/nx3=16"])
    _, phys, _, _, _ = torch_main.build(pin, device="cpu")
    n = 2 * ng + 1
    u = np.zeros((1, 22, n, n, n))
    u[:, [0, 1, 4, 6, 18]] = 1.0
    prm = z4c_stage.stage_params(phys, 0.5, 0.5) + [0.1]
    mat = physical_tmunu(u.shape, 1)
    for sbc in (None, np.ones((1, 5, n, n, n))):
        _, vac = run_harness(harness, 2, phys, u, u, sbc, prm)
        _, with_mat = run_harness(harness, 2, phys, u, u, sbc, prm, mat=mat)
        assert with_mat - vac == chip_smoke.Z4C_MATTER_OPS
