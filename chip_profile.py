#!/usr/bin/env python3
"""Kernels A (``mega_stage_v2``) and G (``pool_fill``) on one NVIDIA GPU:
their launches under the profiler, their times and their ptxas report.

    python3 chip_profile.py [--root DIR] [--label NAME] [--trace]
    python3 chip_profile.py --compare NAME1 NAME2
    python3 chip_profile.py --turns PARENT_DIR

``--root`` names the checkout whose ``athenak_tpu_torch`` is measured
(default: the directory of this script); the decks and helpers come from
the ``chip_smoke.py`` beside this script.  ``--turns`` measures another
checkout (say the parent commit, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists) and this one in turns on one card,
each run in its own process: parent (traced), change (traced), change,
parent; then it compares the outputs of each pair.

A run

  * prints the card's name and power limit;
  * compiles ``csrc/mega_stage_v2.cu`` and ``csrc/pool_fill.cu`` of the
    measured tree with the build's flags and prints each kernel's
    registers, spills and shared memory (nvcc ``-Xptxas -v``);
  * with ``--trace``, runs ``torch.profiler`` (CPU and CUDA) over 10
    calls of A at 124^3 and at 8 x 62^3 and over 50 calls of G on
    turb8's u, and prints every device launch: name, calls, mean us;
  * times, with CUDA events, A on the 124^3 blast and on the 8 x 62^3
    pool (f32, as initialised, RK2 stage 1), G on turb8's u (8 x 5 x
    68^3) and face field, ``torch.take`` of every ghost of u, and the
    blast's and the pool's zone-cycles/s (20 and 10 cycles after a
    warm-up cycle);
  * saves A's outputs on both decks (stage 1 and stage 2) and G's
    result to ``.scratch/profile_<label>.pt`` under this script's
    directory, and prints one JSON line with every number.

``--compare`` loads two such files and prints, for every output,
whether the two runs are bitwise equal and the largest difference.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("mega_stage_v2.cu", "pool_fill.cu")


def ptxas_report(cs, kernels, csrc):
    """{source: [line, ...]}: nvcc's -Xptxas -v for each entry function
    of the two sources, one line each."""
    from concurrent.futures import ThreadPoolExecutor
    nvcc = kernels._nvcc()

    def one(src):
        with tempfile.TemporaryDirectory() as tmp:
            run = subprocess.run(
                [nvcc] + kernels.NVCC_FLAGS
                + ["-c", "-o", os.path.join(tmp, "k.o"),
                   os.path.join(csrc, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc {src} failed:\n{run.stdout}")
        return cs.ptxas_lines(run.stdout)

    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(one, SOURCES)))


def device_split(torch, fn, calls: int):
    """[(kernel name, calls, mean us)] of every device launch of
    ``calls`` calls of fn under torch.profiler, or None if the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev = (getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0) or 0)
        if dev <= 0 or e.key.startswith(("aten::", "cuda", "Profiler")):
            continue
        name = e.key
        m = re.search(r"athenak::\(anonymous namespace\)::(\w+<[^>]*>|\w+)",
                      name)
        if m:
            name = m.group(1)
        rows.append((name[:70], e.count, dev / e.count))
    return rows or None


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="run")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar="NAME")
    ap.add_argument("--turns", metavar="PARENT_DIR")
    args = ap.parse_args()
    if args.turns:
        return turns(os.path.abspath(args.turns))
    import torch
    if args.compare:
        return compare(torch, *args.compare)
    if not torch.cuda.is_available():
        print("chip_profile: CUDA is not available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    # chip_smoke from beside this script, the package from the tree
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, root)
    from athenak_tpu_torch import kernels
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import pool_fill, stage

    card = cs.smi()
    print(f"[{args.label}] {card}; tree {root}; package "
          f"{os.path.dirname(kernels.__file__)}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"[{args.label}] kernels loaded in "
          f"{time.perf_counter() - t0:.1f} s ({kernels.BUILD_INFO['path']})")
    report = ptxas_report(cs, kernels, str(kernels.CSRC))
    for src, lines in report.items():
        for line in lines:
            print(f"[{args.label}] ptxas {src}: {line}")

    out = {"label": args.label, "card": card, "ptxas": report}
    saved = {}
    with tempfile.TemporaryDirectory() as tmp:
        decks = {}
        for name, text in (("pool", cs.POOL_DECK), ("turb", cs.TURB_DECK)):
            decks[name] = os.path.join(tmp, f"{name}.athinput")
            with open(decks[name], "w") as f:
                f.write(text)

        # kernel A: both decks as initialised, stage 1 timed
        for label, deck in (("124^3", cs.DECK), ("8x62^3", decks["pool"])):
            mesh, phys, _, driver, st = build(
                cs.pin_for(["job/precision=single"], deck), device="cuda")
            st = phys.unpack_state(driver.initialize(st))
            u0, b0, dt = st["u"], st["bfc"], mesh.dt
            a1 = (u0, b0, u0, b0, phys.eos, 0.0, 1.0, dt, phys.dxs)
            uk, bk, ck = stage.mega_stage_v2(*a1)
            ui, bi = cs.fill_plain(phys, uk.clone(),
                                   {c: v.clone() for c, v in bk.items()})
            a2 = (ui, bi, u0, b0, phys.eos, 0.5, 0.5, 0.5 * dt, phys.dxs)
            uk2, bk2, ck2 = stage.mega_stage_v2(*a2)
            torch.cuda.synchronize()
            for s, (uo, bo, co) in enumerate(((uk, bk, ck),
                                              (uk2, bk2, ck2))):
                saved[f"A {label} stage {s + 1} u"] = cs.interior(uo).cpu()
                for c, v in bo.items():
                    saved[f"A {label} stage {s + 1} {c}"] = \
                        cs.interior(v).cpu()
                saved[f"A {label} stage {s + 1} counters"] = torch.stack(
                    [co["neos_dfloor"].double().cpu(),
                     co["neos_efloor"].double().cpu(),
                     co["neos_tfloor"].double().cpu(),
                     co["dtmin"].double().cpu()])
            out[f"A_ms {label}"] = cs.cuda_ms(
                lambda: stage.mega_stage_v2(*a1), 20)
            print(f"[{args.label}] A {label}: "
                  f"{out[f'A_ms {label}']:.4f} ms")
            if args.trace:
                split = device_split(torch, lambda: stage.mega_stage_v2(*a1),
                                     10)
                out[f"A_split {label}"] = split
                print_split(args.label, f"A {label}", split, 10)
            del mesh, phys, driver, st, u0, b0, uk, bk, uk2, bk2, ui, bi
            torch.cuda.empty_cache()

        # kernel G on turb8
        mesh = cs.pool_mesh(decks["turb"], cs.TURB8)
        nbr = torch.as_tensor(pool_fill.neighbor27(mesh), device="cuda")
        nmb, n = mesh.nmb_total, mesh.mb_indcs.ncells1
        gen = torch.Generator().manual_seed(13)
        u = torch.rand((nmb, 5, n, n, n), generator=gen).cuda()
        fcs = {"x1f": torch.rand((nmb, n, n, n + 1), generator=gen).cuda(),
               "x2f": torch.rand((nmb, n, n + 1, n), generator=gen).cuda(),
               "x3f": torch.rand((nmb, n + 1, n, n), generator=gen).cuda()}
        pool_fill.pool_fill_cc(u, nbr, mesh)
        pool_fill.pool_fill_fc(fcs, nbr, mesh)
        torch.cuda.synchronize()
        saved["G turb8 u"] = u.cpu()
        for c, v in fcs.items():
            saved[f"G turb8 {c}"] = v.cpu()
        dst, src = cs.ghost_donors(torch, pool_fill, tuple(u.shape), "cc",
                                   nbr.cpu(), mesh)
        dst, src = dst.cuda(), src.cuda()
        out["G_ghosts"] = dst.numel()
        for _ in range(3):      # in turns: kernel, take, kernel, ...
            out.setdefault("G_ms", []).append(cs.cuda_ms(
                lambda: pool_fill.pool_fill_cc(u, nbr, mesh), 200))
            out.setdefault("take_ms", []).append(cs.cuda_ms(
                lambda: torch.take(u, src), 200))
        out["G_fc_ms"] = cs.cuda_ms(
            lambda: pool_fill.pool_fill_fc(fcs, nbr, mesh), 200)
        out["G_bound_ms"] = cs.bound(2 * dst.numel() * 4, 0)[0]
        print(f"[{args.label}] G turb8 u {out['G_ms']} ms, torch.take "
              f"{out['take_ms']} ms, faces {out['G_fc_ms']:.4f} ms, bound "
              f"{out['G_bound_ms']:.5f} ms ({out['G_ghosts']} ghosts)")
        if args.trace:
            split = device_split(
                torch, lambda: pool_fill.pool_fill_cc(u, nbr, mesh), 50)
            out["G_split"] = split
            print_split(args.label, "G turb8 u", split, 50)
        del u, fcs, src, dst
        torch.cuda.empty_cache()

        # end to end
        out["blast_zcps"] = cs.timed_cycles(torch, "true", cs.DECK, cs.NCYC)
        out["pool_zcps"] = cs.timed_cycles(torch, "true", decks["pool"],
                                           cs.NCYC_TURB)
        print(f"[{args.label}] zone-cycles/s blast {out['blast_zcps']:.6e}, "
              f"pool {out['pool_zcps']:.6e}")
    os.makedirs(os.path.join(HERE, ".scratch"), exist_ok=True)
    torch.save(saved, os.path.join(HERE, ".scratch",
                                   f"profile_{args.label}.pt"))
    print(json.dumps(out))
    return 0


def print_split(label, what, split, calls):
    if split is None:
        print(f"[{label}] trace {what}: the profiler recorded no device "
              "time")
        return
    total = sum(c * us for _, c, us in split)
    print(f"[{label}] trace {what}: {total / calls:.2f} us of device time "
          "a call")
    for name, c, us in sorted(split, key=lambda r: -r[1] * r[2]):
        print(f"[{label}]   {name}: {c} launches, {us:.2f} us each")


def turns(parent: str) -> int:
    """parent, change, change, parent, then the two comparisons."""
    runs = ((parent, "parent1", True), (HERE, "change1", True),
            (HERE, "change2", False), (parent, "parent2", False))
    for root, label, trace in runs:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                        root, "--label", label] + (["--trace"] if trace
                                                   else []), check=True)
    for a, b in (("parent1", "change1"), ("parent2", "change2")):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--compare", a, b], check=True)
    return 0


def compare(torch, a: str, b: str) -> int:
    ra = torch.load(os.path.join(HERE, ".scratch", f"profile_{a}.pt"))
    rb = torch.load(os.path.join(HERE, ".scratch", f"profile_{b}.pt"))
    same = True
    for key in ra:
        x, y = ra[key], rb[key]
        eq = torch.equal(x, y)
        same &= eq
        diff = float((x.double() - y.double()).abs().max())
        print(f"compare {a} / {b}: {key}: "
              f"{'bitwise equal' if eq else f'differs, max {diff:g}'}")
    print(f"compare {a} / {b}: {'all bitwise equal' if same else 'differ'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
