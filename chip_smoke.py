#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card.  It

  1. checks that CUDA is there, prints the card's name and power limit,
     and builds the kernels from ``athenak_tpu_torch/csrc`` with nvcc;
  2. holds the ghost-fill kernel against its plain version at the 124^3
     blast deck's shapes (128^3 with ghosts), float32 and float64,
     cell and face arrays: bitwise equal;
  3. holds the stage kernel against its plain version on both RK2 stages
     of the 124^3 blast after initialisation: float32 within the two-tier
     bound (> 95% of interior cells within 3e-5 of the field scale, all
     within 5e-3), dtmin within rtol 1e-4, floor counts equal; float64
     within 1e-10 of the field scale;
  4. drives the main path through the CLI (``athenak_tpu_torch.main``) on
     ``inputs/mhd/blast.athinput`` for 20 cycles, with the launch counts
     set to 0 just before: the stage kernel must launch twice a cycle and
     the fill kernels at least once; the state must be finite, keep
     div(B) at roundoff and conserve mass, and the ``bin`` dumps must
     exist.  Then it times 20 cycles of the kernel path and of the plain
     path (``mhd/use_kernels=false``) with CUDA events after a warm-up
     cycle.

Every failure raises, so the exit code is not 0.  The last lines of
standard output are one JSON line with the kernels' numbers and one JSON
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(ROOT, "inputs", "mhd", "blast.athinput")
NCYC = 20


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn() on the current stream."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def two_tier(got, ref, scale, label, tight=3e-5, loose=5e-3):
    """>95% of cells within `tight`, all within `loose` (scale-relative);
    returns the max absolute error."""
    import torch
    err = (got.double() - ref.double()).abs()
    rel = err / scale
    frac = float((rel < tight).double().mean())
    if not (frac > 0.95 and float(rel.max()) < loose):
        raise AssertionError(f"{label}: {frac:.4f} of cells within {tight}, "
                             f"max scale-relative error {float(rel.max()):g}")
    return float(err.max())


def interior(t, ng=2):
    return t[..., ng:-ng, ng:-ng, ng:-ng]


def pin_for(overrides):
    from athenak_tpu_torch.main import read_deck
    return read_deck(DECK, overrides)


def phase_fill(torch, fill, card):
    """Kernel B against its plain version, bitwise."""
    gen = torch.Generator().manual_seed(1)
    n = 128
    times = {}
    errs = {"periodic_fill_cc": 0.0, "periodic_fill_fc": 0.0}
    for dtype in (torch.float32, torch.float64):
        cc = torch.rand((1, 5, n, n, n), generator=gen, dtype=dtype)
        fc = {"x1f": torch.rand((1, n, n, n + 1), generator=gen, dtype=dtype),
              "x2f": torch.rand((1, n, n + 1, n), generator=gen, dtype=dtype),
              "x3f": torch.rand((1, n + 1, n, n), generator=gen, dtype=dtype)}
        cc = cc.cuda()
        fc = {k: v.cuda() for k, v in fc.items()}
        a, b = cc.clone(), cc.clone()
        fill.periodic_fill_cc(a)
        fill.fill_plain(b, fill.shifts(b.shape))
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"periodic_fill_cc {dtype}: not bitwise")
        errs["periodic_fill_cc"] = max(errs["periodic_fill_cc"],
                                       float((a - b).abs().max()))
        fa = {k: v.clone() for k, v in fc.items()}
        fill.periodic_fill_fc(fa)
        for k, v in fc.items():
            ref = v.clone()
            fill.fill_plain(ref, fill.shifts(ref.shape, k))
            if not torch.equal(fa[k], ref):
                raise AssertionError(f"periodic_fill_fc {k} {dtype}: "
                                     "not bitwise")
            errs["periodic_fill_fc"] = max(errs["periodic_fill_fc"],
                                           float((fa[k] - ref).abs().max()))
        if dtype == torch.float32:
            times["periodic_fill_cc"] = (
                cuda_ms(lambda: fill.periodic_fill_cc(a), 50),
                cuda_ms(lambda: fill.fill_plain(b, fill.shifts(b.shape)),
                        50))
            times["periodic_fill_fc"] = (
                cuda_ms(lambda: fill.periodic_fill_fc(fa), 50),
                cuda_ms(lambda: [fill.fill_plain(v, fill.shifts(v.shape, k))
                                 for k, v in fc.items()], 50))
    print(f"phase 2: periodic fill kernels bitwise equal to the plain "
          f"version (f32, f64); [{card}] cc {times['periodic_fill_cc'][0]:.4f}"
          f" ms (plain {times['periodic_fill_cc'][1]:.4f} ms), fc "
          f"{times['periodic_fill_fc'][0]:.4f} ms (plain "
          f"{times['periodic_fill_fc'][1]:.4f} ms)")
    return times, errs


def phase_stage(torch, card):
    """Kernel A against its plain version on both RK2 stages."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import fill, stage

    result = {}
    for prec in ("single", "double"):
        mesh, phys, _, driver, state = build(
            pin_for([f"job/precision={prec}"]), device="cuda")
        state = phys.unpack_state(driver.initialize(state))
        dt = mesh.dt
        u0, b0 = state["u"], state["bfc"]
        eos, dxs = phys.eos, phys.dxs
        inp_u, inp_b = u0, b0
        maxerr = 0.0
        for s, (g0, g1, beta) in enumerate(((0.0, 1.0, 1.0),
                                            (0.5, 0.5, 0.5))):
            bdt = float(torch.tensor(beta, dtype=u0.dtype)
                        * torch.tensor(dt, dtype=u0.dtype))
            args = (inp_u, inp_b, u0, b0, eos, g0, g1, bdt, dxs)
            uk, bk, ck = stage.mega_stage_v2(*args)
            up, bp, cp = stage.mega_stage_v2_plain(*args)
            torch.cuda.synchronize()
            bscale = max(float(interior(bp[c]).abs().max())
                         for c in bp)
            uscale = interior(up).abs().amax(dim=(-3, -2, -1), keepdim=True)
            label = f"stage {s + 1} {prec}"
            if prec == "single":
                maxerr = max(maxerr, two_tier(interior(uk), interior(up),
                                              uscale, f"{label} u"))
                for c in bp:
                    two_tier(interior(bk[c]), interior(bp[c]), bscale,
                             f"{label} {c}")
                for key in ("neos_dfloor", "neos_efloor", "neos_tfloor"):
                    if int(ck[key]) != int(cp[key]):
                        raise AssertionError(f"{label} {key}: "
                                             f"{int(ck[key])} != "
                                             f"{int(cp[key])}")
                rtol = 1e-4
            else:
                err = float(((interior(uk) - interior(up)).abs()
                             / uscale).max())
                berr = max(float((interior(bk[c]) - interior(bp[c])).abs()
                                 .max()) / bscale for c in bp)
                if not (err <= 1e-10 and berr <= 1e-10):
                    raise AssertionError(f"{label}: u err {err:g}, "
                                         f"bfc err {berr:g} > 1e-10")
                rtol = 1e-10
            dk, dp = float(ck["dtmin"]), float(cp["dtmin"])
            if abs(dk - dp) > rtol * abs(dp):
                raise AssertionError(f"{label} dtmin {dk!r} vs {dp!r}")
            # next stage from the plain result, ghosts filled
            inp_u = fill.fill_plain(up, fill.shifts(up.shape))
            inp_b = {c: fill.fill_plain(v, fill.shifts(v.shape, c))
                     for c, v in bp.items()}
        if prec == "single":
            args = (u0, b0, u0, b0, eos, 0.0, 1.0, dt, dxs)
            ms = cuda_ms(lambda: stage.mega_stage_v2(*args), 10)
            plain_ms = cuda_ms(lambda: stage.mega_stage_v2_plain(*args), 3)
            result = {"max_abs_err": maxerr, "ms": ms, "plain_ms": plain_ms}
        print(f"phase 3: mega_stage_v2 agrees with its plain version on "
              f"both RK2 stages ({prec})")
    print(f"phase 3: [{card}] mega_stage_v2 {result['ms']:.3f} ms/stage, "
          f"plain {result['plain_ms']:.3f} ms/stage (f32, 124^3)")
    return result


def timed_cycles(torch, use_kernels: str, card: str) -> float:
    """zone-cycles/s over NCYC cycles after one warm-up cycle."""
    from athenak_tpu_torch.main import build
    mesh, phys, _, driver, state = build(
        pin_for([f"mhd/use_kernels={use_kernels}"]), device="cuda")
    state = driver.initialize(state)
    cycle = driver.make_cycle_fn()
    dt = mesh.dt
    state, dtnew, _ = cycle(state, dt)
    dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(NCYC):
        state, dtnew, _ = cycle(state, dt)
        dt = min(2.0 * dt, driver.cfl_no * float(dtnew))
    t1.record()
    torch.cuda.synchronize()
    sec = t0.elapsed_time(t1) / 1e3
    mbi = mesh.mb_indcs
    return NCYC * mbi.nx1 * mbi.nx2 * mbi.nx3 / sec


def phase_main(torch, kernels, card):
    """The main path through the CLI, with its checks and timings."""
    from athenak_tpu_torch import main as cli_main
    from athenak_tpu_torch.main import build

    _, _, _, _, state0 = build(pin_for([]), device="cuda")
    mass0 = float(interior(state0["u"][:, 0]).double().sum())
    os.environ["ATHENAK_DEVICE"] = "cuda"
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        kernels.reset_counts()
        try:
            mesh, phys, driver, state = cli_main.cli(
                ["-i", DECK, "-d", tmp, f"time/nlim={NCYC}"])
        finally:
            os.chdir(cwd)
        launches = {k.name: k.launches for k in kernels.ALL}
        bins = sorted(f for f in os.listdir(tmp) if f.endswith(".bin"))
    ncyc = mesh.ncycle
    if launches["mega_stage_v2"] != 2 * ncyc or ncyc != NCYC:
        raise AssertionError(f"mega_stage_v2 launched "
                             f"{launches['mega_stage_v2']} times in "
                             f"{ncyc} cycles")
    for name in ("periodic_fill_cc", "periodic_fill_fc"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    u, bfc = state["u"], state["bfc"]
    if not (bool(torch.isfinite(u).all())
            and all(bool(torch.isfinite(v).all()) for v in bfc.values())):
        raise AssertionError("main path: non-finite state")
    dx = phys.dxs["x1"]
    b1, b2, b3 = bfc["x1f"], bfc["x2f"], bfc["x3f"]
    div = ((b1[..., 1:] - b1[..., :-1]) / phys.dxs["x1"]
           + (b2[..., 1:, :] - b2[..., :-1, :]) / phys.dxs["x2"]
           + (b3[:, 1:] - b3[:, :-1]) / phys.dxs["x3"])
    bmax = max(float(v.abs().max()) for v in bfc.values())
    divb = float(interior(div).abs().max()) * dx / bmax
    if divb > 1e-5:
        raise AssertionError(f"max|div B| dx / max|B| = {divb:g} > 1e-5")
    mass = float(interior(u[:, 0]).double().sum())
    dmass = abs(mass - mass0) / mass0
    if dmass > 1e-5:
        raise AssertionError(f"mass changed by {dmass:g} (relative)")
    if not bins:
        raise AssertionError("no bin output written")
    print(f"phase 4: main path {ncyc} cycles, launches {launches}, "
          f"div(B) {divb:.3e}, mass drift {dmass:.3e}, bin files {bins}; "
          f"[{card}] CLI zone-cycles/s {driver.zcps:.6e} "
          f"(wall clock, first cycle included)")
    rates = {}
    for label in ("true", "false", "true", "false"):
        rates.setdefault(label, []).append(timed_cycles(torch, label, card))
    print(f"phase 4: [{card}] zone-cycles/s over {NCYC} cycles after a "
          f"warm-up, kernel path {rates['true']}, plain path "
          f"{rates['false']} (CUDA events)")
    return launches, rates


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from athenak_tpu_torch import kernels
    from athenak_tpu_torch.ops import fill

    card = smi()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"phase 1: kernels built and loaded in "
          f"{time.perf_counter() - t0:.1f} s ({kernels.BUILD_INFO['path']})")
    for line in kernels.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    fill_times, fill_errs = phase_fill(torch, fill, card)
    stage_res = phase_stage(torch, card)
    launches, rates = phase_main(torch, kernels, card)

    print(json.dumps({"kernels": [
        {"name": "mega_stage_v2", "route": "cuda",
         "source": "athenak_tpu_torch/csrc/mega_stage_v2.cu",
         "replaces": "athenak_tpu/ops/pallas_stage.py:823",
         "launches": launches["mega_stage_v2"],
         "max_abs_err": stage_res["max_abs_err"],
         "ms": stage_res["ms"], "plain_ms": stage_res["plain_ms"]},
        {"name": "periodic_fill_cc", "route": "cuda",
         "source": "athenak_tpu_torch/csrc/periodic_fill.cu",
         "replaces": "athenak_tpu/ops/pallas_fill.py:68",
         "launches": launches["periodic_fill_cc"],
         "max_abs_err": fill_errs["periodic_fill_cc"],
         "ms": fill_times["periodic_fill_cc"][0],
         "plain_ms": fill_times["periodic_fill_cc"][1]},
        {"name": "periodic_fill_fc", "route": "cuda",
         "source": "athenak_tpu_torch/csrc/periodic_fill.cu",
         "replaces": "athenak_tpu/ops/pallas_fill.py:89",
         "launches": launches["periodic_fill_fc"],
         "max_abs_err": fill_errs["periodic_fill_fc"],
         "ms": fill_times["periodic_fill_fc"][0],
         "plain_ms": fill_times["periodic_fill_fc"][1]},
    ], "zone_cycles_per_s": {"kernel": rates["true"],
                             "plain": rates["false"]}, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
