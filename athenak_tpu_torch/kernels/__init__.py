"""Build, load and count the hand-written CUDA kernels.

The sources in ``athenak_tpu_torch/csrc`` are compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o libathenak_kernels.so csrc/*.cu

(plus ``--fmad=false``, see ``NVCC_FLAGS``) into
``athenak_tpu_torch/_build/<hash of the sources>/`` and loaded with
ctypes.  The library has a plain C interface: every entry point takes
device pointers, sizes, scalars and the CUDA stream, launches on that
stream and returns ``cudaGetLastError()``.  Nothing is built or loaded
when this module is imported; the CPU tests never reach ``library()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
# No --use_fast_math: division and sqrt stay IEEE.  --fmad=false keeps
# a*b + c*d from contracting into fma(a, b, c*d), which is not symmetric
# in its two products: on a mirror-symmetric state (the blast at rest)
# the mass flux through a symmetry plane is then exactly zero, as in the
# plain version, and the GS07 upwind selects cannot flip on its sign.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "athenak_periodic_fill": [_P, ctypes.c_longlong] + [_I] * 7 + [_P],
    "athenak_mega_stage_v2": [_P] * 18 + [_I] * 5 + [_D] * 12 + [_P],
}


class Kernel:
    """A wrapper's C entry point and its launch count.

    ``launches`` is a plain integer that the wrapper raises by one where
    it launches the kernel, and nowhere else."""

    def __init__(self, name: str, entry_base: str) -> None:
        self.name = name
        self.entry_base = entry_base
        self.launches = 0

    def entry(self, dtype):
        return getattr(library(), f"{self.entry_base}_{suffix(dtype)}")


MEGA_STAGE_V2 = Kernel("mega_stage_v2", "athenak_mega_stage_v2")
# one CUDA kernel behind two wrappers (cell and face arrays)
PERIODIC_FILL_CC = Kernel("periodic_fill_cc", "athenak_periodic_fill")
PERIODIC_FILL_FC = Kernel("periodic_fill_fc", "athenak_periodic_fill")
ALL = (MEGA_STAGE_V2, PERIODIC_FILL_CC, PERIODIC_FILL_FC)

_LIB = None
BUILD_INFO = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return path


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _LIB
    if _LIB is not None:
        return _LIB
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libathenak_kernels.so"
    t0 = time.perf_counter()
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libathenak_kernels.{os.getpid()}.so"
        cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp)] + [str(p)
                                                           for p in cus]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        BUILD_INFO["log"] = proc.stdout + proc.stderr
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["path"] = str(so)
    lib = ctypes.CDLL(str(so))
    for base, args in _SIGNATURES.items():
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{suffix}")
            fn.argtypes = args
            fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise TypeError(f"the CUDA kernels take float32 or float64, not {dtype}")


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0
