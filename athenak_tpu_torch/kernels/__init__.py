"""Build, load and count the hand-written CUDA kernels.

The sources in ``athenak_tpu_torch/csrc`` are compiled at first use, one
nvcc process for each ``.cu`` file, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -c -o <name>.o csrc/<name>.cu

and linked with ``nvcc -shared`` into
``athenak_tpu_torch/_build/<hash of the sources>/libathenak_kernels.so``,
which is loaded with ctypes.  The library has a plain C interface:
every entry point takes device pointers, sizes, scalars and the CUDA
stream, launches on that stream and returns ``cudaGetLastError()``.  The
stage kernels that take a step (A, C, D, E, H) take it as a device
pointer to a 0-d tensor of the working type (``step``), never as a host
double, so that a CUDA graph of a cycle replays them on the step the
tensor holds at replay.
Nothing is built or loaded when this module is imported; the CPU tests
never reach ``library()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH + ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
                     "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "athenak_periodic_fill": [_P] * 3 + [_I] + [_P] + [_I] * 2 + [_P],
    # gam0, gam1, the step's pointer, the cell sizes, ...
    "athenak_mega_stage_v2": [_P] * 13 + [_I] * 5 + [_D] * 2 + [_P]
    + [_D] * 9 + [_P],
    "athenak_fused_stage": [_P] * 10 + [_I] * 5 + [_D] * 2 + [_P]
    + [_D] * 6 + [_P],
    "athenak_fused_ct": [_P] * 20 + [_I] * 5 + [_D] * 2 + [_P] + [_D] * 3
    + [_P],
    "athenak_mega_stage_v1": [_P] * 14 + [_I] * 6 + [_D] * 2 + [_P]
    + [_D] * 9 + [_P],
    "athenak_fused_aux": [_P] * 10 + [_I] * 7 + [_D] * 9 + [_P],
    "athenak_pool_fill": [_P] * 3 + [_I] + [_P] * 2 + [_I] * 4 + [_P],
    # ..., the parameter block, the step's pointer, the stream
    # u, u1, sbc, the stress-energy (or null), out, ...
    "athenak_z4c_stage": [_P] * 5 + [_I] * 5 + [_P] * 3,
    "athenak_z4c_outflow_fill": [_P, ctypes.c_longlong] + [_I] * 4 + [_P],
    "athenak_flux_dir": [_P] * 6 + [_I] * 5 + [_D] * 3 + [_P],
}


class Kernel:
    """A wrapper's C entry point and its launch count.

    ``launches`` is a plain integer that the wrapper raises by one where
    it launches the kernel, and nowhere else; a replay of a CUDA graph
    runs no wrapper, so ``graphs.py`` adds the launches its capture
    recorded at every replay."""

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
FUSED_STAGE3D = Kernel("fused_stage3d", "athenak_fused_stage")
FUSED_CT3D = Kernel("fused_ct3d", "athenak_fused_ct")
MEGA_STAGE_V1 = Kernel("mega_stage_v1", "athenak_mega_stage_v1")
FUSED_AUX3D = Kernel("fused_aux3d", "athenak_fused_aux")
POOL_FILL = Kernel("pool_fill", "athenak_pool_fill")
Z4C_STAGE = Kernel("z4c_stage", "athenak_z4c_stage")
# kernel H's matter source: the same entry given the stress-energy, its
# own instances and its own count
Z4C_STAGE_MATTER = Kernel("z4c_stage_matter", "athenak_z4c_stage")
Z4C_OUTFLOW_FILL = Kernel("z4c_outflow_fill", "athenak_z4c_outflow_fill")
FLUX_DIR = Kernel("fused_flux_dir", "athenak_flux_dir")
ALL = (MEGA_STAGE_V2, PERIODIC_FILL_CC, PERIODIC_FILL_FC, FUSED_STAGE3D,
       FUSED_CT3D, MEGA_STAGE_V1, FUSED_AUX3D, POOL_FILL, Z4C_STAGE,
       Z4C_STAGE_MATTER, Z4C_OUTFLOW_FILL, FLUX_DIR)

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
        nvcc = _nvcc()
        tag = os.getpid()
        objs = [out_dir / f"{p.stem}.{tag}.o" for p in cus]

        def compile_one(src, obj):
            t = time.perf_counter()
            run = subprocess.run(
                [nvcc] + NVCC_FLAGS + ["-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            return run.returncode, run.stdout, time.perf_counter() - t

        with ThreadPoolExecutor(len(cus)) as pool:
            runs = list(pool.map(compile_one, cus, objs))
        failed = [(c.name, rc, log)
                  for c, (rc, log, _) in zip(cus, runs) if rc]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{log}" for name, rc, log in failed))
        logs = [log for _, log, _ in runs]
        BUILD_INFO["logs"] = {c.name: log for c, log in zip(cus, logs)}
        BUILD_INFO["source_seconds"] = {
            c.name: round(sec, 1) for c, (_, _, sec) in zip(cus, runs)}
        tmp = out_dir / f"libathenak_kernels.{tag}.so"
        link = subprocess.run([nvcc, "-shared"] + ARCH + ["-o", str(tmp)]
                              + [str(o) for o in objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, so)
        for o in objs:
            o.unlink()
        BUILD_INFO["log"] = "".join(logs)
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
    """The current CUDA stream of ``device`` as an integer: torch's raw
    stream, one C call (some 0.3 us on the host), not the 4.5 us of
    building a ``torch.cuda.Stream`` (``torch.cuda.current_stream``)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def step(beta_dt, like):
    """The stage's step as the 0-d tensor whose address a kernel takes:
    ``beta_dt`` itself where it is a 0-d tensor of ``like``'s dtype on
    its card, else a converted copy (a Python number is filled in on the
    card, rounded to the dtype as torch rounds it).  The caller keeps the
    result alive until the launch is queued."""
    if isinstance(beta_dt, torch.Tensor):
        if beta_dt.dim() != 0:
            raise ValueError(f"the step must be a 0-d tensor, got shape "
                             f"{tuple(beta_dt.shape)}")
        return beta_dt.to(device=like.device, dtype=like.dtype)
    return torch.full((), float(beta_dt), dtype=like.dtype,
                      device=like.device)


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0
