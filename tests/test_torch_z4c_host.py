"""The CUDA stage kernel's arithmetic, built for the host with g++.

``csrc/z4c_rhs.cuh`` is plain C++ apart from CUDA's function qualifiers,
``__ldg`` and the launch (which it keeps behind ``__CUDACC__``).  Through
a small shim header standing for ``cuda_runtime.h`` this file compiles
the kernel for the CPU, runs it cell by cell and holds it against the
plain torch stage (``ops/z4c_stage.py``) on the 16^3 single-puncture
deck:

  * on the bench deck's options every channel that AlgConstr leaves
    alone is bitwise equal to the plain version, in float32 and float64:
    the kernel keeps rhs_core's operation order term by term;
  * every channel agrees to 1e-6 (float32) and 1e-13 (float64) of
    max(|value|, 1): the conformal metric and A_ij pass through the cube
    root (``cbrt`` in the kernel, ``x ** (1/3)`` in torch), and with
    chi_psi_power != -4 the conformal factor through ``pow``.

With a counting number type in place of the float it also counts the
kernel's operations a cell (add, subtract, multiply, divide, negate; pow
and cbrt count one), the numbers ``chip_smoke.py`` takes for the
kernel's bound.  The test skips where no g++ is installed.  This checks
the source's arithmetic, not the CUDA build: the card runs the same
checks in ``tests/test_torch_cuda.py``.
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
struct HostDim3 { unsigned x, y, z; };
static HostDim3 blockIdx, threadIdx, blockDim;
"""

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
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

// the whole grid, thread by thread; returns the operations of the last
template <class T, int NG>
long long run(FILE* f, FILE* o, const int* h, const double* prm) {
  const int nmb = h[2], n3 = h[3], n2 = h[4], n1 = h[5], has_sbc = h[6];
  const size_t n = (size_t)nmb * 22 * n3 * n2 * n1;
  const size_t ns = (size_t)nmb * 5 * n3 * n2 * n1;
  std::vector<T> u = rd<T>(f, n), u1 = rd<T>(f, n), sbc;
  if (has_sbc) sbc = rd<T>(f, ns);
  std::vector<T> out(n, T(0.0));
  const Z4cPrm<T> P = make_z4c_prm<T>(prm);
  const long long total =
      (long long)nmb * (n3 - 2 * NG) * (n2 - 2 * NG) * (n1 - 2 * NG);
  blockDim.x = 128;
  long long ops = 0;
  for (long long t = 0; t < total; ++t) {
    blockIdx.x = t / 128;
    threadIdx.x = t % 128;
    cnt::n = 0;
    z4c_stage_kernel<T, NG>(u.data(), u1.data(),
                            has_sbc ? sbc.data() : nullptr, out.data(), nmb,
                            n3, n2, n1, P);
    ops = cnt::n;
  }
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
  int h[7];  // type (0 float, 1 double, 2 counting), ng, nmb, n3, n2, n1,
             // Sommerfeld geometry given
  if (fread(h, 4, 7, f) != 7) return 1;
  double prm[P_COUNT];
  if (fread(prm, 8, P_COUNT, f) != P_COUNT) return 1;
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


def run_harness(exe, kind, phys, u, u1, sbc, prm):
    """Run the host build of kernel H on (u, u1); returns (out, the
    operations of the last cell)."""
    d = exe.parent
    nmb, _, n3, n2, n1 = u.shape
    with open(d / "in.bin", "wb") as f:
        f.write(struct.pack("7i", kind, phys.ng, nmb, n3, n2, n1,
                            int(sbc is not None)))
        f.write(np.asarray(prm, np.float64).tobytes())
        for a in (u, u1) + (() if sbc is None else (sbc,)):
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
                             z4c_stage.stage_params(phys, g0, g1, bdt))
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
    prm = z4c_stage.stage_params(phys, 0.5, 0.5, 0.1)
    sbc = np.ones((1, 5, n, n, n))
    _, plain = run_harness(harness, 2, phys, u, u, None, prm)
    _, somm = run_harness(harness, 2, phys, u, u, sbc, prm)
    assert chip_smoke.Z4C_OPS[ng] == (plain, somm - plain)
