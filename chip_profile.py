#!/usr/bin/env python3
"""Kernels A (``mega_stage_v2``), G (``pool_fill``), E (``mega_stage_v1``),
J (``fused_flux_dir``), H (``z4c_stage``), C (``fused_stage3d``), F
(``fused_aux3d``), B (``periodic_fill_cc/fc``), D (``fused_ct3d``) and I
(``z4c_outflow_fill``) on one NVIDIA GPU: their launches under the
profiler, their times and their ptxas report.

    python3 chip_profile.py [--root DIR] [--label NAME] [--trace]
                            [--kernels AGEJHCFBDI] [--no-e2e]
    python3 chip_profile.py --compare NAME1 NAME2
    python3 chip_profile.py --turns PARENT_DIR [--kernels AGEJHCFBDI]

``--root`` names the checkout whose ``athenak_tpu_torch`` is measured
(default: the directory of this script); the decks and helpers come from
the ``chip_smoke.py`` beside this script.  ``--turns`` measures another
checkout (say the parent commit, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists) and this one in turns on one card,
each run in its own process: parent (traced), change (traced), change,
parent; then it compares the outputs of each pair.  ``--kernels`` picks
which of A, G, E, J, H, C, F, B, D and I a run measures (all by
default);
``--no-e2e`` skips the zone-cycles/s of the decks.

A run

  * prints the card's name and power limit;
  * prints the registers, spills and shared memory (nvcc ``-Xptxas
    -v``) of each picked kernel's sources in the measured tree:
    ``csrc/mega_stage_v2.cu`` (A), ``pool_fill.cu`` (G),
    ``mega_stage_v1.cu`` (E), ``flux_dir.cu`` (J), the eight
    ``z4c_stage_ng*_f*.cu`` instances (H), ``fused_stage.cu`` (C),
    ``fused_aux.cu`` (F), ``periodic_fill.cu`` (B), ``fused_ct.cu``
    (D) and ``z4c_stage.cu`` (I), from the library build's own log where
    this process built it;
  * with ``--trace``, runs ``torch.profiler`` (CPU and CUDA) over 10
    calls of A at 124^3 and at 8 x 62^3, over 50 calls of G on turb8's
    u, over 10 calls of each RK2 stage of E at 128^3 and at 8 x 64^3
    (``chip_smoke.py`` phase 7's random states), over 10 calls of J
    for each direction on the smr deck (``SMR_FULL``: 120 blocks of
    36^3) and on ot (1024^2) as initialised, over 10 calls of each of
    H's four RK4 stages at 60^3 ng 2 (``Z4C_DECK``) and 64^3 ng 3
    (``one_puncture.athinput``) in float32 (phase 10's inputs), and
    over 10 calls of C on the first RK2 stage of the SR blast (SR HLLE)
    and of the Newtonian blast (HLLD) in float32 (phase 5's inputs),
    over 20 calls of F with its wrap on one 128^3 block and without it
    on 8 x 64^3 (phase 7's random states, f32), over 50 calls of B on
    1 x 5 x 128^3, on the three face arrays of 128^3 in one call and on
    each alone (phase 2's arrays, f32), over 50 calls of G's fills and
    of ``torch.take``, over 20 calls of D on the first RK2 stage of the
    SR blast and of the blast (1 x 128^3 with ghosts, f32) and over 50
    calls of I at 60^3 ng 2 and 64^3 ng 3 (f32), and prints every device
    launch: name, calls, mean us;
  * times, with CUDA events, A on the 124^3 blast and on the 8 x 62^3
    pool (f32, as initialised, RK2 stage 1), G on turb8's u (8 x 5 x
    68^3) and face field, ``torch.take`` of every ghost of u, E on both
    RK2 stages at both shapes (f32), J for each direction on smr and ot
    (f32, as initialised), H on each RK4 stage at both shapes (f32), C
    on the first and second RK2 stage of the SR blast and the blast
    (f32), F, B, D and I on the traced calls, each beside its host us
    (the median of five rounds of calls issued without a synchronise), and
    the zone-cycles/s of blast (20 cycles), pool, turb1 and turb8 (10
    cycles; with A, G, E, J, F or B), smr and ot (with A, G, E or J), of
    z4c and puncture (with H or I) and of the SR blast (with C, B or D;
    10 cycles each after a warm-up cycle);
  * saves A's outputs on both decks (stage 1 and stage 2) and G's
    result, and digests of E's interior u' and faces (both stages and
    gam1 = 0, both shapes, f32 and f64) and of J's whole flux, ey and ez
    (each direction; smr as initialised and after 5 cycles, ot; f32 and
    f64), of H's interior output (the four RK4 stages at 60^3 ng 2, 64^3
    ng 3, 2 x 32^3 ng 4 and a ragged 46 x 38 x 42 ng 5 block, with and
    without the Sommerfeld geometry, f32 and f64) and of C's whole acc,
    mass fluxes and face EMFs (HLLD, SR HLLE, SR LLF; both RK2 stages;
    f32 and f64), of F's u, w and bcc with its counts and dtmin (with and
    without dxs, on the random states, at 16^3 and on the turb1 and
    turb8 decks' states; f32 and f64) and of B's every output (128^3,
    ragged, the blast after one stage; f32 and f64), of D's three new
    face arrays (the SR blast and the blast with kernel C's fluxes, both
    RK2 stages, and two ragged pools, SR and Newtonian; f32 and f64) and of
    I's filled array (60^3 ng 2, 64^3 ng 3, a 40 x 34 x 36 ng 4 and the
    ragged ng 5 block; f32 and f64), and which of F's outputs equal the
    plain version's bitwise, to
    ``.scratch/profile_<label>.pt`` under this script's
    directory, and prints one JSON line with every number.  A digest is
    the SHA-256 of the tensor's bytes and the float64 sums of its planes
    along the last two axes.

``--compare`` loads two such files and prints every output in which the
two runs differ, with the largest difference (of the values, or of the
plane sums for a digest), and the count of outputs that are bitwise
equal.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
Z4C_INSTANCES = tuple(f"z4c_stage_ng{ng}_f{b}.cu" for ng in (2, 3, 4, 5)
                      for b in (32, 64))
SOURCES = {"A": ("mega_stage_v2.cu",), "G": ("pool_fill.cu",),
           "E": ("mega_stage_v1.cu",), "J": ("flux_dir.cu",),
           "H": Z4C_INSTANCES, "C": ("fused_stage.cu",),
           "F": ("fused_aux.cu",), "B": ("periodic_fill.cu",),
           "D": ("fused_ct.cu",), "I": ("z4c_stage.cu",)}
# H's shapes: phase 10's three and a ragged single block at nghost 5; I's
# also a ragged single block at nghost 4
Z4C_NG5 = ["mesh/nghost=5", "mesh/nx1=46", "mesh/nx2=38", "mesh/nx3=42"]
Z4C_NG4 = ["mesh/nghost=4", "mesh/nx1=40", "mesh/nx2=34", "mesh/nx3=36"]


def ptxas_report(cs, kernels, csrc, picked):
    """{source: [line, ...]}: nvcc's -Xptxas -v for each entry function
    of the picked kernels' sources, one line each; from the library
    build's log where this process built the library, else compiled
    anew."""
    from concurrent.futures import ThreadPoolExecutor
    nvcc = kernels._nvcc()
    logs = kernels.BUILD_INFO.get("logs") or {}
    sources = [s for k in picked for s in SOURCES[k]
               if os.path.exists(os.path.join(csrc, s))]

    def one(src):
        if src in logs:
            return cs.ptxas_lines(logs[src])
        with tempfile.TemporaryDirectory() as tmp:
            run = subprocess.run(
                [nvcc] + kernels.NVCC_FLAGS
                + ["-c", "-o", os.path.join(tmp, "k.o"),
                   os.path.join(csrc, src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode:
            raise RuntimeError(f"nvcc {src} failed:\n{run.stdout}")
        return cs.ptxas_lines(run.stdout)

    with ThreadPoolExecutor(max(len(sources), 1)) as pool:
        return dict(zip(sources, pool.map(one, sources)))


def digest(t):
    """(SHA-256 of the bytes, float64 sums of the planes along the last
    two axes) of a tensor on the card."""
    sums = t.double().sum(dim=(-2, -1)).flatten().cpu()
    host = t.contiguous().cpu().numpy()
    return {"sha256": hashlib.sha256(host.data).hexdigest(), "sums": sums}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="run")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--kernels", default="AGEJHCFBDI")
    ap.add_argument("--no-e2e", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar="NAME")
    ap.add_argument("--turns", metavar="PARENT_DIR")
    args = ap.parse_args()
    if args.turns:
        return turns(os.path.abspath(args.turns), args.kernels, args.no_e2e)
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

    card = cs.smi()
    print(f"[{args.label}] {card}; tree {root}; package "
          f"{os.path.dirname(kernels.__file__)}")
    t0 = time.perf_counter()
    kernels.library()
    print(f"[{args.label}] kernels loaded in "
          f"{time.perf_counter() - t0:.1f} s ({kernels.BUILD_INFO['path']})")
    report = ptxas_report(cs, kernels, str(kernels.CSRC), args.kernels)
    for src, lines in report.items():
        for line in lines:
            print(f"[{args.label}] ptxas {src}: {line}")

    out = {"label": args.label, "card": card, "ptxas": report}
    saved = {}
    with tempfile.TemporaryDirectory() as tmp:
        decks = {}
        for name, text in (("pool", cs.POOL_DECK), ("turb", cs.TURB_DECK),
                           ("z4c", cs.Z4C_DECK), ("sr", cs.SR_DECK)):
            decks[name] = os.path.join(tmp, f"{name}.athinput")
            with open(decks[name], "w") as f:
                f.write(text)
        steps = {"A": profile_a, "G": profile_g, "E": profile_e,
                 "J": profile_j, "H": profile_h, "C": profile_c,
                 "F": profile_f, "B": profile_b, "D": profile_d,
                 "I": profile_i}
        for key in args.kernels:
            if key in steps:
                steps[key](torch, cs, args, decks, out, saved)
                torch.cuda.empty_cache()
        if not args.no_e2e:
            end_to_end(torch, cs, args, decks, out)
    os.makedirs(os.path.join(HERE, ".scratch"), exist_ok=True)
    torch.save(saved, os.path.join(HERE, ".scratch",
                                   f"profile_{args.label}.pt"))
    print(json.dumps(out))
    return 0


def profile_a(torch, cs, args, decks, out, saved):
    """Kernel A: both decks as initialised, stage 1 timed."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import stage
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
        for s, (uo, bo, co) in enumerate(((uk, bk, ck), (uk2, bk2, ck2))):
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
        print(f"[{args.label}] A {label}: {out[f'A_ms {label}']:.4f} ms")
        if args.trace:
            split = cs.device_split(
                torch, lambda: stage.mega_stage_v2(*a1), 10)
            out[f"A_split {label}"] = split
            print_split(args.label, f"A {label}", split, 10)
        del mesh, phys, driver, st, u0, b0, uk, bk, uk2, bk2, ui, bi
        torch.cuda.empty_cache()


def profile_g(torch, cs, args, decks, out, saved):
    """Kernel G on turb8's u and faces, beside torch.take."""
    from athenak_tpu_torch.ops import pool_fill
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
    timed(torch, cs, args, out, "G", "turb8 u",
          lambda: pool_fill.pool_fill_cc(u, nbr, mesh), 50)
    timed(torch, cs, args, out, "take", "turb8 u",
          lambda: torch.take(u, src), 50)
    timed(torch, cs, args, out, "G", "turb8 faces",
          lambda: pool_fill.pool_fill_fc(fcs, nbr, mesh), 50)


def host_us(torch, fn, calls: int, rounds: int = 5) -> float:
    """Host microseconds a call: the wall time of ``calls`` calls issued
    without a synchronise, over ``calls``; the median of ``rounds``
    rounds (the host's cores are shared, and single rounds spread)."""
    fn()
    per = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return sorted(per)[rounds // 2]


def timed(torch, cs, args, out, kernel, label, fn, calls):
    """A call's ms under CUDA events (as ``chip_smoke.cuda_ms`` times it),
    its host us and, with --trace, its device us a call under the
    profiler, into ``out`` under "<kernel>_ms <label>", "<kernel>_host_us
    <label>", "<kernel>_device_us <label>" and "<kernel>_split <label>"."""
    ms = cs.cuda_ms(fn, calls)
    host = host_us(torch, fn, calls)
    out[f"{kernel}_ms {label}"] = ms
    out[f"{kernel}_host_us {label}"] = host
    dev = "not traced"
    if args.trace:
        split = cs.device_split(torch, fn, calls)
        out[f"{kernel}_split {label}"] = split
        if split is not None:
            dev = cs.split_us(split, calls)
            out[f"{kernel}_device_us {label}"] = dev
            dev = f"{dev:.2f} us"
    print(f"[{args.label}] {kernel} {label}: {ms:.4f} ms a call (events), "
          f"host {host:.1f} us a call, device {dev} a call")
    if args.trace:
        print_split(args.label, f"{kernel} {label}", split, calls)


def save_aux(torch, saved, key, got):
    """Digests of kernel F's u, w and bcc, and its counts and dtmin."""
    u, w, bcc, c = got
    for name, t in (("u", u), ("w", w), ("bcc", bcc)):
        saved[f"{key} {name}"] = digest(t)
    saved[f"{key} counts"] = torch.stack(
        [c[k].cpu() for k in ("neos_dfloor", "neos_efloor", "neos_tfloor")])
    if "dtmin" in c:
        saved[f"{key} dtmin"] = c["dtmin"].reshape(1).cpu()


def profile_f(torch, cs, args, decks, out, saved):
    """Kernel F on chip_smoke.py phase 7's random states (one 132^3 block
    with its wrap, 8 blocks of 68^3 without; floors at 0.5) and on the
    turb1 (wrap) and turb8 (no wrap) decks' states as initialised:
    digests of u, w and bcc, the counts and dtmin, f64 and f32, with and
    without dxs; f32 call ms, host us and traces; and which outputs equal
    the plain version's bitwise, on the random states and at the card
    tests' 16^3."""
    from athenak_tpu_torch.ops import aux
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    floors = EOSData(dfloor=0.5, pfloor=0.5)
    same = {}
    cases = ((True, 1, 132), (False, 8, 68), (True, 1, 16), (False, 2, 16))
    for dtype in (torch.float64, torch.float32):
        tag = "f32" if dtype == torch.float32 else "f64"
        for wrap, nmb, n in cases:
            gen = torch.Generator().manual_seed(12)
            w, bfc, bcc = cs.random_mhd(torch, gen, nmb, n, dtype,
                                        bimodal=True)
            u = prim_to_cons_mhd(w, bcc, EOSData())
            dxs = {"x1": 1 / (n - 4), "x2": 0.9 / (n - 4),
                   "x3": 1.1 / (n - 4)}
            a = (u, bfc, floors, dxs, wrap)
            label = (f"{nmb}x{n - 4}^3" if nmb > 1 else f"{n - 4}^3") + \
                (" wrap" if wrap else "")
            got = aux.fused_aux3d(*a)
            ref = aux.fused_aux3d_plain(*a)
            torch.cuda.synchronize()
            save_aux(torch, saved, f"F {label} {tag}", got)
            save_aux(torch, saved, f"F {label} {tag} no dxs",
                     aux.fused_aux3d(u, bfc, floors, None, wrap))
            same[f"{label} {tag}"] = {
                **{k: torch.equal(x, y) for k, x, y in
                   zip(("u", "w", "bcc"), got[:3], ref[:3])},
                **{k: torch.equal(got[3][k], ref[3][k]) for k in ref[3]}}
            del got, ref
            if tag == "f32" and n > 16:
                timed(torch, cs, args, out, "F", label,
                      lambda: aux.fused_aux3d(*a), 20)
            del w, bfc, bcc, u
            torch.cuda.empty_cache()
    out["F_plain_bitwise"] = same
    print(f"[{args.label}] F outputs bitwise equal to the plain version's: "
          f"{json.dumps(same)}")
    for label, extra, wrap in (("turb1", [], True),
                               ("turb8", cs.TURB8, False)):
        for prec in ("double", "single"):
            state, phys = cs.deck_state(torch, decks["turb"], extra, prec)
            tag = "f32" if prec == "single" else "f64"
            save_aux(torch, saved, f"F {label} deck {tag}", aux.fused_aux3d(
                state["u"], state["bfc"], phys.eos, dxs=phys.dxs, wrap=wrap))
            torch.cuda.synchronize()
            del state, phys
            torch.cuda.empty_cache()


def profile_b(torch, cs, args, decks, out, saved):
    """Kernel B on chip_smoke.py phase 2's random arrays (1 x 5 x 128^3
    and the three face arrays of 128^3), on a ragged 2 x 3 x 9 x 14 x 23
    and on the blast deck's u and faces after one kernel-A stage (stale
    ghosts): digests of every output, f64 and f32, the faces in one call
    and each alone; f32 call ms, host us and traces at 128^3 (cc, the
    three faces in one call, each face array alone)."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import fill, stage
    for dtype in (torch.float64, torch.float32):
        tag = "f32" if dtype == torch.float32 else "f64"
        for label, nmb, nc, (n3, n2, n1) in (("128^3", 1, 5, (128,) * 3),
                                             ("ragged", 2, 3, (9, 14, 23))):
            gen = torch.Generator().manual_seed(1)

            def rand(*shape):
                return torch.rand(shape, generator=gen, dtype=dtype).cuda()

            cc = rand(nmb, nc, n3, n2, n1)
            fc = {"x1f": rand(nmb, n3, n2, n1 + 1),
                  "x2f": rand(nmb, n3, n2 + 1, n1),
                  "x3f": rand(nmb, n3 + 1, n2, n1)}
            one = {c: v.clone() for c, v in fc.items()}
            fill.periodic_fill_cc(cc)
            fill.periodic_fill_fc(fc)
            for c, v in one.items():
                fill.periodic_fill_fc({c: v})
            torch.cuda.synchronize()
            key = f"B {label} {tag}"
            saved[f"{key} cc"] = digest(cc)
            for c in fc:
                saved[f"{key} {c}"] = digest(fc[c])
                saved[f"{key} {c} alone"] = digest(one[c])
            if tag == "f32" and label == "128^3":
                timed(torch, cs, args, out, "B", "cc 1x5x128^3",
                      lambda: fill.periodic_fill_cc(cc), 50)
                timed(torch, cs, args, out, "B", "fc 128^3",
                      lambda: fill.periodic_fill_fc(fc), 50)
                for c in fc:
                    timed(torch, cs, args, out, "B", f"{c} 128^3",
                          lambda: fill.periodic_fill_fc({c: fc[c]}), 50)
            del cc, fc, one
    for prec in ("double", "single"):
        mesh, phys, _, driver, st = build(
            cs.pin_for([f"job/precision={prec}"], cs.DECK), device="cuda")
        st = phys.unpack_state(driver.initialize(st))
        uk, bk, _ = stage.mega_stage_v2(st["u"], st["bfc"], st["u"],
                                        st["bfc"], phys.eos, 0.0, 1.0,
                                        mesh.dt, phys.dxs)
        fill.periodic_fill_cc(uk)
        fill.periodic_fill_fc(bk)
        torch.cuda.synchronize()
        tag = "f32" if prec == "single" else "f64"
        saved[f"B blast {tag} u"] = digest(uk)
        for c, v in bk.items():
            saved[f"B blast {tag} {c}"] = digest(v)
        del mesh, phys, driver, st, uk, bk
        torch.cuda.empty_cache()


def profile_e(torch, cs, args, decks, out, saved):
    """Kernel E on chip_smoke.py phase 7's random states: one block of
    128^3 and 8 blocks of 64^3 (interiors), both RK2 stages; f64 and
    f32 digests, f32 times and traces."""
    from athenak_tpu_torch.ops import stage_v1
    from athenak_tpu_torch.ops.eos import EOSData, prim_to_cons_mhd
    eos = EOSData()
    for dtype in (torch.float64, torch.float32):
        for nmb, n in ((1, 132), (8, 68)):
            nx = n - 4
            label = f"{nmb}x{nx}^3" if nmb > 1 else f"{nx}^3"
            dxs = {"x1": 1 / nx, "x2": 1 / nx, "x3": 1 / nx}
            gen = torch.Generator().manual_seed(11)
            w, bfc, bcc = cs.random_mhd(torch, gen, nmb, n, dtype)
            w1, bfc1, bcc1 = cs.random_mhd(torch, gen, nmb, n, dtype)
            u0 = prim_to_cons_mhd(w, bcc, eos)
            u1 = prim_to_cons_mhd(w1, bcc1, eos)
            tag = "f32" if dtype == torch.float32 else "f64"
            # both RK2 stages, and gam1 = 0 (the register not read)
            for s, (g0, g1, beta) in enumerate(cs.RK2 + ((1.0, 0.0, 1.0),)):
                old = (u1, bfc1) if g1 else (None, None)
                a = (w, bcc, bfc, u0, *old, eos, g0, g1, beta * 0.1 / nx,
                     dxs)
                uk, bk = stage_v1.fused_mega_stage3d(*a)
                torch.cuda.synchronize()
                key = (f"E {label} {tag} stage {s + 1}" if g1 else
                       f"E {label} {tag} gam1 0")
                saved[f"{key} u"] = digest(cs.interior(uk))
                for c, v in bk.items():
                    saved[f"{key} {c}"] = digest(cs.interior(v))
                del uk, bk
                if tag == "f64" or not g1:
                    continue
                ms = cs.cuda_ms(lambda: stage_v1.fused_mega_stage3d(*a), 20)
                out[f"E_ms {label} stage {s + 1}"] = ms
                print(f"[{args.label}] E {label} stage {s + 1}: {ms:.4f} ms")
                if args.trace:
                    split = cs.device_split(
                        torch, lambda: stage_v1.fused_mega_stage3d(*a), 10)
                    out[f"E_split {label} stage {s + 1}"] = split
                    print_split(args.label, f"E {label} stage {s + 1}",
                                split, 10)
            del w, bfc, bcc, w1, bfc1, bcc1, u0, u1
            torch.cuda.empty_cache()


def profile_j(torch, cs, args, decks, out, saved):
    """Kernel J on the smr deck (as initialised and after 5 cycles) and
    on ot: f64 and f32 digests of the whole outputs; f32 times and
    traces of the initial states."""
    from athenak_tpu_torch.ops import flux
    cases = (("smr", cs.SMR_FULL, cs.SMR_DECK, 0),
             ("smr 5 cycles", cs.SMR_FULL, cs.SMR_DECK, 5),
             ("ot", cs.OT_FULL, cs.OT_DECK, 0))
    for label, extra, deck, ncyc in cases:
        for prec in ("double", "single"):
            state, phys = cs.deck_state(torch, deck, extra, prec, ncyc)
            w, bcc, bfc = state["w"], state["bcc"], state["bfc"]
            del state
            tag = "f32" if prec == "single" else "f64"
            for name, _axis, ivx, _dx in phys.dirs:
                a = (w, bcc, bfc[f"{name}f"], phys.eos, name, ivx)
                got = flux.fused_flux_dir(*a)
                torch.cuda.synchronize()
                key = f"J {label} {tag} {name}"
                for what, v in zip(("flux", "ey", "ez"), got):
                    saved[f"{key} {what}"] = digest(v)
                del got
                if prec == "double" or ncyc:
                    continue
                for _ in range(10):  # clocks up after host-bound work
                    flux.fused_flux_dir(*a)
                ms = cs.cuda_ms(lambda: flux.fused_flux_dir(*a), 20)
                out[f"J_ms {label} {name}"] = ms
                print(f"[{args.label}] J {label} {name}: {ms:.4f} ms")
                if args.trace:
                    split = cs.device_split(
                        torch, lambda: flux.fused_flux_dir(*a), 10)
                    out[f"J_split {label} {name}"] = split
                    print_split(args.label, f"J {label} {name}", split, 10)
            del w, bcc, bfc
            torch.cuda.empty_cache()


def profile_h(torch, cs, args, decks, out, saved):
    """Kernel H on phase 10's inputs (the state after initialisation,
    perturbed, and a perturbed register) at 60^3 ng 2, 64^3 ng 3, 2 x
    32^3 ng 4 and a ragged ng 5 block: digests of the interior output of
    the four RK4 stages with and without the Sommerfeld geometry, f64
    and f32; f32 times and traces of each stage at the first two."""
    import copy
    from athenak_tpu_torch.ops import z4c_stage as zs
    shapes = (("60^3 ng 2", decks["z4c"], []),
              ("64^3 ng 3", cs.PUNCTURE, []),
              ("2x32^3 ng 4", cs.PUNCTURE, cs.Z4C_POOL),
              ("46x38x42 ng 5", cs.PUNCTURE, Z4C_NG5))
    for label, deck, extra in shapes:
        for prec in ("double", "single"):
            phys, u, u1, dt = cs.z4c_inputs(torch, deck, extra, prec)
            plain_bc = copy.copy(phys)
            plain_bc.sbc_mask = None
            tag = "f32" if prec == "single" else "f64"
            sets = cs.rk4_sets(torch, u.dtype, dt)
            for s, (g0, g1, bdt) in enumerate(sets):
                for somm, z in (("sbc", phys), ("no sbc", plain_bc)):
                    got = zs.fused_z4c_stage(u, u1, z, g0, g1, bdt)
                    torch.cuda.synchronize()
                    saved[f"H {label} {tag} stage {s + 1} {somm}"] = \
                        digest(cs.interior(got, phys.ng))
                    del got
                if tag == "f64" or label not in ("60^3 ng 2", "64^3 ng 3"):
                    continue
                a = (u, u1, phys, g0, g1, bdt)
                ms = cs.cuda_ms(lambda: zs.fused_z4c_stage(*a), 20)
                out[f"H_ms {label} stage {s + 1}"] = ms
                print(f"[{args.label}] H {label} stage {s + 1}: {ms:.4f} ms")
                if args.trace:
                    split = cs.device_split(
                        torch, lambda: zs.fused_z4c_stage(*a), 10)
                    out[f"H_split {label} stage {s + 1}"] = split
                    print_split(args.label, f"H {label} stage {s + 1}",
                                split, 10)
            del phys, plain_bc, u, u1
            torch.cuda.empty_cache()


def profile_c(torch, cs, args, decks, out, saved):
    """Kernel C on phase 5's inputs (the decks' states after
    initialisation): HLLD on the blast, SR HLLE and SR LLF on the SR
    blast, both RK2 stages (the second with u0 read), digests of the
    whole acc, mass fluxes and face EMFs in f64 and f32; f32 times and
    traces of HLLD and SR HLLE, the path's instance."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import stage_split
    cases = (("sr_hlle", decks["sr"], []),
             ("sr_llf", decks["sr"], ["mhd/rsolver=llf"]),
             ("hlld", cs.DECK, []))
    for solver, deck, extra in cases:
        for prec in ("double", "single"):
            mesh, phys, _, driver, state = build(
                cs.pin_for(extra + [f"job/precision={prec}"], deck),
                device="cuda")
            state = phys.unpack_state(driver.initialize(state))
            if phys.stage_solver != solver:
                raise AssertionError(f"{solver}: the deck gives "
                                     f"{phys.stage_solver}")
            tag = "f32" if prec == "single" else "f64"
            w, bcc, bfc, u = state["w"], state["bcc"], state["bfc"], \
                state["u"]
            u1 = u * 0.999
            for s, (g0, g1, beta) in enumerate(cs.RK2):
                a = (w, bcc, bfc, u, u1, phys.eos, g0, g1, beta * mesh.dt,
                     phys.dxs, solver)
                acc, fden, emf = stage_split.fused_stage3d(*a)
                torch.cuda.synchronize()
                key = f"C {solver} {tag} stage {s + 1}"
                saved[f"{key} acc"] = digest(acc)
                for d, v in fden.items():
                    saved[f"{key} fden {d}"] = digest(v)
                for e, v in emf.items():
                    saved[f"{key} emf {e}"] = digest(v)
                del acc, fden, emf
                if tag == "f64" or solver == "sr_llf":
                    continue
                ms = cs.cuda_ms(lambda: stage_split.fused_stage3d(*a), 20)
                out[f"C_ms {solver} stage {s + 1}"] = ms
                print(f"[{args.label}] C {solver} stage {s + 1}: "
                      f"{ms:.4f} ms")
                if args.trace and s == 0:
                    split = cs.device_split(
                        torch, lambda: stage_split.fused_stage3d(*a), 10)
                    out[f"C_split {solver} stage 1"] = split
                    print_split(args.label, f"C {solver} stage 1", split,
                                10)
            del mesh, phys, driver, state, w, bcc, bfc, u, u1
            torch.cuda.empty_cache()


def profile_d(torch, cs, args, decks, out, saved):
    """Kernel D on phase 5's inputs (the SR blast's and the blast's state
    after initialisation, 1 x 128^3 with ghosts, with kernel C's mass
    fluxes and face EMFs of the first RK2 stage), both RK2 stages (the
    second with bfc_old = 0.999 bfc), and on random inputs on ragged
    pools of 2 x 14 x 21 x 37 and 2 x 10 x 13 x 44 cells, SR and
    Newtonian: digests of the three new face arrays, whole, in f64 and
    f32; f32 call ms, host us and traces of the first stage at 128^3,
    with the bound."""
    from athenak_tpu_torch.main import build
    from athenak_tpu_torch.ops import stage_split
    cases = (("sr", decks["sr"], "sr_hlle"), ("newtonian", cs.DECK, "hlld"))
    for label, deck, solver in cases:
        for prec in ("double", "single"):
            mesh, phys, _, driver, state = build(
                cs.pin_for([f"job/precision={prec}"], deck), device="cuda")
            state = phys.unpack_state(driver.initialize(state))
            w, bcc, bfc, u = state["w"], state["bcc"], state["bfc"], \
                state["u"]
            _, fden, emf = stage_split.fused_stage3d(
                w, bcc, bfc, u, u, phys.eos, 0.0, 1.0, mesh.dt, phys.dxs,
                solver)
            old = {c: v * 0.999 for c, v in bfc.items()}
            tag = "f32" if prec == "single" else "f64"
            for s, (g0, g1, beta) in enumerate(cs.RK2):
                a = (w, bcc, fden, emf, bfc, old, g0, g1, beta * mesh.dt,
                     phys.dxs, phys.is_sr)
                nb = stage_split.fused_ct3d(*a)
                torch.cuda.synchronize()
                for c, v in nb.items():
                    saved[f"D {label} {tag} stage {s + 1} {c}"] = digest(v)
                if tag == "f32" and s == 0:
                    moved = (cs.nbytes(w) * 3 // 5
                             + cs.nbytes(bcc, *fden.values(), *emf.values())
                             + 2 * cs.nbytes(*bfc.values())
                             + cs.nbytes(*nb.values()))
                    out[f"D_bound_ms {label} 128^3"] = cs.bound(
                        moved, cs.OPS_CT * w[:, 0].numel())[0]
                    timed(torch, cs, args, out, "D", f"{label} 128^3",
                          lambda: stage_split.fused_ct3d(*a), 20)
                del nb
            del mesh, phys, driver, state, w, bcc, bfc, u, fden, emf, old
            torch.cuda.empty_cache()
    for shape, sr, dtype in itertools.product(
            ((2, 14, 21, 37), (2, 10, 13, 44)), (True, False),
            (torch.float64, torch.float32)):
        gen = torch.Generator().manual_seed(23)

        def rand(*s):
            return torch.randn(s, generator=gen,
                               dtype=torch.float64).to("cuda", dtype)

        nmb, n3, n2, n1 = shape
        fcs = {"x1f": (nmb, n3, n2, n1 + 1), "x2f": (nmb, n3, n2 + 1, n1),
               "x3f": (nmb, n3 + 1, n2, n1)}
        w, bcc = rand(nmb, 5, n3, n2, n1), rand(nmb, 3, n3, n2, n1)
        fden = {d: rand(*shape) for d in ("x1", "x2", "x3")}
        emf = {e: rand(*shape) for e in ("e3x1", "e2x1", "e1x2", "e3x2",
                                         "e2x3", "e1x3")}
        bfc = {c: rand(*s) for c, s in fcs.items()}
        old = {c: rand(*s) for c, s in fcs.items()}
        dxs = {"x1": 1 / 33, "x2": 1 / 17, "x3": 1 / 10}
        nb = stage_split.fused_ct3d(w, bcc, fden, emf, bfc, old, 0.5, 0.5,
                                    0.01, dxs, sr)
        torch.cuda.synchronize()
        key = (f"D {'x'.join(map(str, shape))} "
               f"{'sr' if sr else 'newtonian'} "
               f"{'f32' if dtype == torch.float32 else 'f64'}")
        for c, v in nb.items():
            saved[f"{key} {c}"] = digest(v)


def profile_i(torch, cs, args, decks, out, saved):
    """Kernel I on phase 10's inputs (the deck's state after
    initialisation with every channel perturbed, ghosts included) at
    60^3 ng 2 (``Z4C_DECK``), 64^3 ng 3 (``one_puncture.athinput``), a
    40 x 34 x 36 ng 4 block and the ragged 46 x 38 x 42 ng 5 block:
    digests of the filled array in f64 and f32; f32 call ms, host us and
    traces at the first two, with the bound."""
    from athenak_tpu_torch.ops import z4c_stage as zs
    shapes = (("60^3 ng 2", decks["z4c"], []),
              ("64^3 ng 3", cs.PUNCTURE, []),
              ("40x34x36 ng 4", cs.PUNCTURE, Z4C_NG4),
              ("46x38x42 ng 5", cs.PUNCTURE, Z4C_NG5))
    for label, deck, extra in shapes:
        for prec in ("double", "single"):
            phys, u, _, _ = cs.z4c_inputs(torch, deck, extra, prec)
            if not phys.fold_bc:
                raise AssertionError(f"I {label}: the deck does not take "
                                     "the outflow fill kernel")
            tag = "f32" if prec == "single" else "f64"
            got = zs.outflow_fill(u.clone(), phys.bvals)
            torch.cuda.synchronize()
            saved[f"I {label} {tag}"] = digest(got)
            del got
            if tag == "f32" and label in ("60^3 ng 2", "64^3 ng 3"):
                out[f"I_bound_ms {label}"] = cs.outflow_fill_bound(phys,
                                                                   u)[0]
                timed(torch, cs, args, out, "I", label,
                      lambda: zs.outflow_fill(u, phys.bvals), 50)
            del phys, u
            torch.cuda.empty_cache()


def end_to_end(torch, cs, args, decks, out):
    """zone-cycles/s of the kernel path of every deck the picked kernels
    run on: blast, pool, turb1 and turb8 with A, G, E, J, F or B; smr
    and ot with A, G, E or J; z4c and puncture with H or I; the SR blast
    with C, B or D."""
    single = ["job/precision=single"]
    runs = []
    if set(args.kernels) & set("AGEJFB"):
        runs += [("blast", cs.DECK, cs.NCYC, (), "mhd"),
                 ("pool", decks["pool"], cs.NCYC_TURB, (), "mhd"),
                 ("turb1", decks["turb"], cs.NCYC_TURB, (), "mhd"),
                 ("turb8", decks["turb"], cs.NCYC_TURB, cs.TURB8, "mhd")]
    if set(args.kernels) & set("AGEJ"):
        runs += [("smr", cs.SMR_DECK, cs.NCYC_SMR, single + cs.SMR_FULL,
                  "mhd"),
                 ("ot", cs.OT_DECK, cs.NCYC_SMR, single + cs.OT_FULL,
                  "mhd")]
    if set(args.kernels) & set("HI"):
        runs += [("z4c", decks["z4c"], cs.NCYC_Z4C, (), "z4c"),
                 ("puncture", cs.PUNCTURE, cs.NCYC_Z4C, single, "z4c")]
    if set(args.kernels) & set("CBD"):
        runs += [("sr", decks["sr"], cs.NCYC_SR, (), "mhd")]
    for name, deck, ncyc, extra, block in runs:
        out[f"{name}_zcps"] = cs.timed_cycles(torch, "true", deck, ncyc,
                                              extra, block=block)
        torch.cuda.empty_cache()
    print(f"[{args.label}] zone-cycles/s " + ", ".join(
        f"{name} {out[f'{name}_zcps']:.6e}" for name, *_ in runs))


def print_split(label, what, split, calls):
    if split is None:
        print(f"[{label}] trace {what}: the profiler recorded no device "
              "time")
        return
    # each kernel's mean time times its launches a call, rounded: late in
    # a long process the profiler drops a few records
    total = sum(us * round(c / calls) for _, c, us in split)
    print(f"[{label}] trace {what}: {total:.2f} us of device time a call")
    for name, c, us in sorted(split, key=lambda r: -r[1] * r[2]):
        print(f"[{label}]   {name}: {c} launches, {us:.2f} us each")


def turns(parent: str, kernels: str, no_e2e: bool) -> int:
    """parent, change, change, parent, then the two comparisons."""
    runs = ((parent, "parent1", True), (HERE, "change1", True),
            (HERE, "change2", False), (parent, "parent2", False))
    for root, label, trace in runs:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--root",
                        root, "--label", label, "--kernels", kernels]
                       + (["--trace"] if trace else [])
                       + (["--no-e2e"] if no_e2e else []), check=True)
    for a, b in (("parent1", "change1"), ("parent2", "change2")):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--compare", a, b], check=True)
    return 0


def compare(torch, a: str, b: str) -> int:
    ra = torch.load(os.path.join(HERE, ".scratch", f"profile_{a}.pt"))
    rb = torch.load(os.path.join(HERE, ".scratch", f"profile_{b}.pt"))
    equal = []
    for key in ra:
        x, y = ra[key], rb[key]
        if isinstance(x, dict):     # a digest
            eq = x["sha256"] == y["sha256"]
            x, y = x["sums"], y["sums"]
        else:
            eq = torch.equal(x, y)
        if eq:
            equal.append(key)
            continue
        diff = float((x.double() - y.double()).abs().max())
        print(f"compare {a} / {b}: {key}: differs, max {diff:g}")
    groups = sorted({" ".join(k.split()[:2]) for k in equal})
    print(f"compare {a} / {b}: {len(equal)} of {len(ra)} outputs bitwise "
          f"equal ({', '.join(groups)}): "
          f"{'all bitwise equal' if len(equal) == len(ra) else 'differ'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
