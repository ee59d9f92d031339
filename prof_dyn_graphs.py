#!/usr/bin/env python3
"""What the CUDA graphs of the dyngr stage and the child lanes of
``chip_smoke.py`` cost and save, on one NVIDIA GPU.

    python3 prof_dyn_graphs.py [--cycles N] [--copies K ...]

1. The graphs: sod, tov_cowling and tov_z4c_smr as shipped (f64)
   through ``main.run``, with the CUDA graphs of the primitive solver
   and the Z4c RHS with matter (``athenak_tpu_torch/graphs.py``) and
   with them switched off (the eager calls), in turns (graphs, eager,
   graphs, eager).  Each turn runs 3 and 3 + N cycles (N = 10 by
   default); the difference over N is the ms of a cycle once the
   captures are made, and the 3-cycle run's wall time minus three such
   cycles is the cost of the first cycle (the captures and the warm-up;
   the first turn of the first deck also carries the process's own
   warm-up).
2. The lanes: K copies (1, 2 and 4 by default) of
   tests/test_rad_gr.py's linear wave at 32 cells, 300 cycles each, in
   K processes on the card at once; each copy's ms a cycle (the
   driver's own clock).

It prints the card's name and power limit, one line a measurement and
a JSON line with every number.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DYN = os.path.join(HERE, "inputs", "dyn_grmhd")
DECKS = ("sod", "tov_cowling", "tov_z4c_smr")
LWAVE = """
import json, os, sys, tempfile
sys.path.insert(0, {here!r})
import chip_smoke
from athenak_tpu_torch.athinput import ParameterInput
from athenak_tpu_torch.main import run
pin = ParameterInput.from_string(chip_smoke.test_literal(
    "test_rad_gr.py", "RAD_LWAVE_DECK"))
pin.modify_from_cmdline(["mesh/nx1=32", "meshblock/nx1=8",
                         "time/nlim={n}"])
os.chdir(tempfile.mkdtemp())
mesh, _, driver, _ = run(pin, device="cuda")
print(json.dumps({{"cycles": mesh.ncycle,
                  "ms_a_cycle": 1e3 * driver.wall_seconds / mesh.ncycle}}))
"""


def run_seconds(torch, deck, n):
    """Wall seconds of ``main.run`` on ``deck`` for n cycles (the card
    synchronised at the end)."""
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.main import run
    pin = ParameterInput.from_file(os.path.join(DYN, f"{deck}.athinput"))
    pin.modify_from_cmdline([f"time/nlim={n}"])
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t = time.perf_counter()
            mesh, _, _, _ = run(pin, device="cuda")
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
        finally:
            os.chdir(cwd)
    if mesh.ncycle != n:
        raise AssertionError(f"{deck}: {mesh.ncycle} cycles, {n} asked")
    return sec


def graphs_ab(torch, ncyc):
    from athenak_tpu_torch import graphs
    replay = graphs.Graphed.__call__

    def eager(self, *args):
        return self.fn(*args)

    out = {}
    for deck in DECKS:
        rec = {"graphs": [], "eager": []}
        for mode in ("graphs", "eager", "graphs", "eager"):
            graphs.Graphed.__call__ = replay if mode == "graphs" else eager
            try:
                short = run_seconds(torch, deck, 3)
                long_ = run_seconds(torch, deck, 3 + ncyc)
            finally:
                graphs.Graphed.__call__ = replay
            cycle = (long_ - short) / ncyc
            rec[mode].append({"ms_a_cycle": 1e3 * cycle,
                              "first_cycle_extra_ms":
                                  1e3 * (short - 3 * cycle)})
        out[deck] = rec
        cyc = {m: [round(r["ms_a_cycle"], 2) for r in rec[m]] for m in rec}
        first = {m: [round(r["first_cycle_extra_ms"]) for r in rec[m]]
                 for m in rec}
        print(f"{deck} (f64, as shipped): ms a cycle once captured, in "
              f"turns {cyc}; the first three cycles' extra ms {first}")
    return out


def lanes(copies, n=300):
    out = {}
    env = dict(os.environ, ATHENAK_DEVICE="cuda")
    for k in copies:
        procs = [subprocess.Popen(
            [sys.executable, "-c", LWAVE.format(here=HERE, n=n)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for _ in range(k)]
        recs = []
        for p in procs:
            so, se = p.communicate(timeout=900)
            if p.returncode != 0:
                raise AssertionError(f"linear wave copy: {se[-2000:]}")
            recs.append(json.loads(so.strip().splitlines()[-1]))
        out[str(k)] = [r["ms_a_cycle"] for r in recs]
        print(f"{k} copies of the 32-cell linear wave at once, {n} cycles "
              f"each: ms a cycle {[round(v, 2) for v in out[str(k)]]}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=10)
    ap.add_argument("--copies", type=int, nargs="*", default=[1, 2, 4])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("prof_dyn_graphs: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke
    card = chip_smoke.smi()
    print(card)
    res = {"card": card, "graphs": graphs_ab(torch, args.cycles),
           "lanes": lanes(args.copies)}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
