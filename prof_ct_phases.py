#!/usr/bin/env python3
"""Where kernel D (``csrc/fused_ct.cu``) spends a plane of its march.

    python3 prof_ct_phases.py [TREE ...]

For each checkout TREE (default: the one beside this script) it copies
``athenak_tpu_torch`` into a temporary directory, adds ``clock64()``
counters to ``fused_ct_kernel`` at the phase boundaries of its march
(thread 0 of every block; each phase up to the barrier that ends it:
the wait for the plane's copies, issuing the next plane's copies, the
cell EMFs, the edges, the faces), builds that copy and runs kernel D 20
times on the first RK2 stage of the SR blast and of the blast at 1 x
128^3 with ghosts (float32; ``chip_smoke.py``'s decks, kernel C's mass
fluxes and face EMFs).  It prints the card, the call ms (CUDA events)
and the cycles a block spends in each phase a plane, averaged over all
blocks.  The counters cost some cycles of their own; compare trees, not
absolute times.  Needs one CUDA card; the patch fails loudly on a
kernel whose march it does not recognise.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
PHASES = ("wait", "issue", "cell EMFs", "edges", "faces")
TICK = "    { const long long t = clock64(); tp[%d] += t - tl; tl = t; }\n"

# (text, text inserted after it) in fused_ct.cu, each the first match
SYNC = "    __syncthreads();\n"
PATCH = (
    ("namespace athenak {\nnamespace {\n",
     "__device__ unsigned long long g_ct_prof[8];\n"),
    ("    cp_async_wait<0>();\n" + SYNC, TICK % 0),
    ("    cp_async_commit();\n", TICK % 1),
    (SYNC + "    if (p >= k0 && has_edge) {\n", None),
    (SYNC + "    if (p > k0) {  // the faces", None),
)
LOOP = "  for (int p = k0 - 1; p <= k1; ++p) {\n"
END = "  }\n}\n\ntemplate <typename T, bool kSr>\nint launch_kind"
TAIL = '''
extern "C" int athenak_ct_prof(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, athenak::g_ct_prof,
                                       8 * sizeof(unsigned long long));
  const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (reset && e == cudaSuccess)
    e = cudaMemcpyToSymbol(athenak::g_ct_prof, z, sizeof(z));
  return static_cast<int>(e);
}
'''


def patch(src: str) -> str:
    for n, (anchor, text) in enumerate(PATCH):
        if anchor not in src:
            raise SystemExit(f"prof_ct_phases: no {anchor!r} in fused_ct.cu")
        new = (anchor + text if text is not None
               else SYNC + TICK % (n - 1) + anchor[len(SYNC):])
        src = src.replace(anchor, new, 1)
    src = src.replace(LOOP, "  long long tp[5] = {0, 0, 0, 0, 0}, "
                      "tl = clock64();\n" + LOOP, 1)
    if END not in src:
        raise SystemExit("prof_ct_phases: the march's end not found")
    src = src.replace(END, TICK % 4 + """  }
  if (threadIdx.x == 0) {
    for (int q = 0; q < 5; ++q)
      atomicAdd(&g_ct_prof[q], static_cast<unsigned long long>(tp[q]));
    atomicAdd(&g_ct_prof[5], 1ULL);
    atomicAdd(&g_ct_prof[6], static_cast<unsigned long long>(k1 - k0 + 2));
  }
}

template <typename T, bool kSr>
int launch_kind""", 1)
    return src + TAIL


def measure(tree: str) -> None:
    """Runs in a process of its own, with the patched package first on
    sys.path."""
    import ctypes

    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, tree)
    from athenak_tpu_torch import kernels
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import stage_split
    fn = kernels.library().athenak_ct_prof
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    sr = os.path.join(tree, "sr.athinput")
    with open(sr, "w") as f:
        f.write(cs.SR_DECK)
    buf = (ctypes.c_ulonglong * 8)()
    for label, deck, solver in (("sr", sr, "sr_hlle"),
                                ("newtonian", cs.DECK, "hlld")):
        mesh, phys, _, driver, st = build(
            cs.pin_for(["job/precision=single"], deck), device="cuda")
        st = phys.unpack_state(driver.initialize(st))
        w, bcc, bfc, u = st["w"], st["bcc"], st["bfc"], st["u"]
        _, fden, emf = stage_split.fused_stage3d(
            w, bcc, bfc, u, u, phys.eos, 0.0, 1.0, mesh.dt, phys.dxs, solver)
        a = (w, bcc, fden, emf, bfc, bfc, 0.0, 1.0, mesh.dt, phys.dxs,
             phys.is_sr)
        ms = cs.cuda_ms(lambda: stage_split.fused_ct3d(*a), 20)
        fn(ctypes.addressof(buf), 1)
        for _ in range(20):
            stage_split.fused_ct3d(*a)
        torch.cuda.synchronize()
        if fn(ctypes.addressof(buf), 1):
            raise RuntimeError("prof_ct_phases: reading the counters failed")
        steps = buf[6]
        per = [buf[q] / steps for q in range(5)]
        print(f"[{cs.smi()}] {label} 128^3: {ms:.4f} ms a call; cycles a "
              "block a plane: " + ", ".join(
                  f"{n} {v:.0f}" for n, v in zip(PHASES, per))
              + f", total {sum(per):.0f} ({buf[5] // 20} blocks, "
              f"{steps / buf[5]:.1f} planes a block)")


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--measure":
        measure(sys.argv[2])
        return 0
    for tree in sys.argv[1:] or [HERE]:
        with tempfile.TemporaryDirectory() as tmp:
            pkg = os.path.join(tmp, "athenak_tpu_torch")
            shutil.copytree(os.path.join(tree, "athenak_tpu_torch"), pkg,
                            ignore=shutil.ignore_patterns("_build",
                                                          "__pycache__"))
            src = os.path.join(pkg, "csrc", "fused_ct.cu")
            with open(src) as f:
                text = patch(f.read())
            with open(src, "w") as f:
                f.write(text)
            print(f"tree {os.path.abspath(tree)}", flush=True)
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--measure", tmp], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
