#!/usr/bin/env python3
"""Audit of the batched cycle window on one NVIDIA card.

    python3 window_audit.py [--out .scratch/window_audit.json] [DECK ...]

For every deck under ``inputs/`` (or the named ones), cut in size as
``tests/test_torch_deck_catalog.py`` cuts it, both on the kernel path and
with ``<block>/use_kernels=false`` where the deck has such a block, it
builds the run on the card and, where the JAX package's condition takes
the window (no adaptive mesh, no turbulence driving, no particles; the
outputs are left off), runs two cycles of it:

  * eagerly under ``torch.cuda.set_sync_debug_mode("warn")``, listing
    every place in the port's code that read the card (a synchronising
    call) inside the window's cycles;
  * from a CUDA graph where ``Driver.graph_window`` admits the
    configuration, recording whether the capture held and the launches
    it made.

It prints one line a run and writes every record as JSON to ``--out``.
A configuration that the predicate admits and whose capture fails, or
one it closes although no host read was found, is listed at the end.
The exit code is 0 when there is none of either.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
import traceback
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
INPUTS = os.path.join(ROOT, "inputs")
NCYC = 2
# the catalog test's cuts, and the decks whose set-up alone takes minutes
# at their shipped size on one card
CUTS = {
    "tests/gr_monopole.athinput": [
        "mesh/nx1=64", "mesh/nx2=64", "mesh/nx3=32", "meshblock/nx1=32",
        "meshblock/nx2=64", "meshblock/nx3=32"],
    "radiation/snake.athinput": [
        "mesh/nx1=32", "mesh/nx2=64", "meshblock/nx1=32",
        "meshblock/nx2=32"],
    "z4c/two_puncture_trackers.athinput": [
        "mesh/nx1=32", "mesh/nx2=32", "mesh/nx3=32", "meshblock/nx1=16",
        "meshblock/nx2=16", "meshblock/nx3=16", "problem/tp_npoints=16",
        "problem/tp_iterations=20"],
}
BLOCKS = ("mhd", "hydro", "z4c")


def strip_outputs(text: str) -> str:
    """A deck's text without its ``<outputN>`` blocks."""
    out, skip = [], False
    for line in text.splitlines():
        s = line.strip()
        if s.startswith("<") and s.endswith(">"):
            skip = s.startswith("<output")
        if not skip:
            out.append(line)
    return "\n".join(out) + "\n"


def reads(caught):
    """file:line of each synchronising call in the port's code."""
    pkg = os.path.join(ROOT, "athenak_tpu_torch")
    got = {}
    for w in caught:
        if "synchroniz" not in str(w.message):
            continue
        fname = os.path.relpath(w.filename, ROOT)
        if not w.filename.startswith(pkg):
            fname = f"(outside the package) {fname}"
        key = f"{fname}:{w.lineno}"
        got[key] = got.get(key, 0) + 1
    return got


def one(torch, kernels, rel, extra):
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.main import build
    with open(os.path.join(INPUTS, rel)) as f:
        pin = ParameterInput.from_string(strip_outputs(f.read()))
    pin.modify_from_cmdline(CUTS.get(rel, []) + list(extra)
                            + [f"time/nlim={NCYC}"])
    rec = {"deck": rel, "extra": list(extra)}

    def fresh():
        mesh, phys, _, driver, state = build(
            ParameterInput.from_string(pin.dump()), device="cuda")
        return mesh, driver, driver.initialize(state)

    mesh, driver, state = fresh()
    if driver.time_evolution == "static":
        rec["path"] = "static"
        return rec
    if not driver.use_window([], False):
        rec["path"] = "per-cycle loop (AMR, driving or particles)"
        return rec
    why = driver.graph_window(state)
    rec["closed"] = why
    # eager window: where the cycles read the card
    driver.window_graphs = False
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            driver._cycle_fn = driver._build_cycle()
            batch = driver._build_batch_cycle(NCYC)
            u = state["u"]
            t = torch.full((), mesh.time, dtype=u.dtype, device=u.device)
            dt = torch.full((), mesh.dt, dtype=u.dtype, device=u.device)
            nc = torch.zeros((), dtype=torch.int32, device=u.device)
            nl = torch.full((), NCYC, dtype=torch.int32, device=u.device)
            batch(state, t, dt, nc, nl)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    rec["host_reads"] = reads(caught)
    if why is None:
        mesh, driver, state = fresh()
        kernels.reset_counts()
        t0 = time.perf_counter()
        try:
            driver.execute(state)
            rec["graph"] = dict(driver.window)
            rec["launches"] = {k.name: k.launches for k in kernels.ALL
                               if k.launches}
        except Exception as e:      # the audit records what failed
            rec["graph_error"] = f"{type(e).__name__}: {e}"[:500]
            rec["graph_trace"] = traceback.format_exc()[-1500:]
        rec["graph_seconds"] = time.perf_counter() - t0
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("decks", nargs="*")
    ap.add_argument("--out", default=os.path.join(ROOT, ".scratch",
                                                  "window_audit.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("window_audit: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from athenak_tpu_torch import kernels
    from athenak_tpu_torch.athinput import ParameterInput
    os.environ["ATHENAK_DEVICE"] = "cuda"
    kernels.library()
    decks = args.decks or sorted(
        os.path.relpath(p, INPUTS) for p in glob.glob(
            os.path.join(INPUTS, "**", "*.athinput"), recursive=True))
    out, bad = [], []
    t_all = time.perf_counter()
    for rel in decks:
        pin = ParameterInput.from_file(os.path.join(INPUTS, rel))
        runs = [[]] + [[f"{b}/use_kernels=false"] for b in BLOCKS
                       if b in pin.blocks]
        for extra in runs:
            t0 = time.perf_counter()
            try:
                rec = one(torch, kernels, rel, extra)
            except Exception as e:  # a deck that does not start
                rec = {"deck": rel, "extra": extra,
                       "error": f"{type(e).__name__}: {e}"[:500]}
            rec["seconds"] = time.perf_counter() - t0
            out.append(rec)
            torch.cuda.empty_cache()
            print(json.dumps(rec)[:600], flush=True)
            if "graph_error" in rec:
                bad.append(f"{rel} {extra}: admitted, capture failed: "
                           f"{rec['graph_error'][:200]}")
            elif rec.get("closed") and not rec.get("host_reads"):
                bad.append(f"{rel} {extra}: closed ({rec['closed']}) but "
                           "no host read found")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"window_audit: {len(out)} runs in "
          f"{time.perf_counter() - t_all:.1f} s; {len(bad)} to look at")
    for line in bad:
        print("  " + line)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
