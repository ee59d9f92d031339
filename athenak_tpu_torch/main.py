"""Entry point / CLI of the PyTorch + CUDA port.

Counterpart of ``athenak_tpu/main.py`` (reference: src/main.cpp:61-420):

  -i <file>   input athinput file
  -d <dir>    run directory
  -n          dump parameters and quit
  -c          show configuration and quit
  -m          output mesh structure and quit
  -v          validate the input deck and quit
  -t hh:mm:ss wall-time limit
  -w seconds  watchdog hang-abort window
  -r <file>   resume from a restart (.rst) file, the port's or the JAX
              package's
  -p <dir>    trace the run with ``torch.profiler`` into a directory
plus block/par=value overrides (applied on top of the restart file's
parameters under ``-r``).

The device comes from ``ATHENAK_DEVICE`` (default ``cuda``) for the CLI,
or from the ``device=`` argument of ``build``/``run``.  Asking for CUDA
where there is none raises; the port never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch


def setup_precision(pin) -> torch.dtype:
    """float64 unless <job>/precision=single (reference: config.hpp.in
    SINGLE_PRECISION_ENABLED); returns the run's dtype."""
    prec = "double"
    if pin.does_block_exist("job") and \
            pin.does_parameter_exist("job", "precision"):
        prec = pin.get_string("job", "precision")
    if prec == "double":
        return torch.float64
    if prec == "single":
        return torch.float32
    raise ValueError(f"job/precision={prec} must be single|double")


def resolve_device(device=None) -> torch.device:
    """The run's device: ``device`` or $ATHENAK_DEVICE (default cuda)."""
    dev = torch.device(device if device is not None
                       else os.environ.get("ATHENAK_DEVICE", "cuda"))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} was asked for but CUDA is not available "
            "(set ATHENAK_DEVICE=cpu for a CPU run)")
    return dev


def read_deck(path, overrides=()):
    """The athinput file at ``path`` with block/par=value overrides."""
    from .athinput import ParameterInput
    pin = ParameterInput.from_file(path)
    pin.modify_from_cmdline(list(overrides))
    return pin


def make_physics(pin, mesh, bvals, device, dtype):
    """Select and construct the physics module (reference:
    MeshBlockPack::AddPhysics, meshblock_pack.cpp:102-235), in the JAX
    package's order: radiation alone, radiation with a fluid on a flat or
    Kerr-Schild background, dynamical GRMHD (<mhd> with <adm> or <z4c>,
    which takes a <radiation> block's deck too), vacuum Z4c,
    ion-neutral, MHD, hydro."""
    if pin.does_block_exist("radiation") \
            and not pin.does_block_exist("hydro") \
            and not pin.does_block_exist("mhd"):
        # radiation-only transport (reference: AddPhysics radiation
        # branch)
        from .radiation.radiation import Radiation
        return Radiation(pin, mesh, bvals, device, dtype)
    if pin.does_block_exist("radiation") \
            and not (pin.does_block_exist("adm")
                     or pin.does_block_exist("z4c")):
        # radiation coupled to hydro or MHD (reference: AddPhysics
        # rad_hydro/rad_mhd branches + RadFluidCoupling)
        from .radiation.rad_fluid import RadiationFluid
        return RadiationFluid(pin, mesh, bvals, device, dtype)
    if pin.does_block_exist("mhd") and (pin.does_block_exist("adm")
                                        or pin.does_block_exist("z4c")):
        # dynamical GRMHD: <mhd>+<adm> on a fixed or prescribed
        # spacetime, <mhd>+<z4c> fully coupled (reference: AddPhysics
        # dyn_grmhd branch, meshblock_pack.cpp:205-235)
        from .dyngr import DynGRMHD
        return DynGRMHD(pin, mesh, bvals, device, dtype)
    if pin.does_block_exist("z4c"):
        # vacuum numerical relativity (reference: AddPhysics z4c branch)
        from .z4c.z4c import Z4c
        return Z4c(pin, mesh, bvals, device=device, dtype=dtype)
    if pin.does_block_exist("ion-neutral"):
        # two fluids, <hydro> neutrals and <mhd> ions, ImEx-coupled
        # (reference: AddPhysics ion-neutral branch)
        if not (pin.does_block_exist("hydro")
                and pin.does_block_exist("mhd")):
            raise ValueError(
                "<ion-neutral> requires both <hydro> and <mhd> blocks")
        from .physics.ion_neutral import IonNeutral
        return IonNeutral(pin, mesh, bvals, device=device, dtype=dtype)
    if pin.does_block_exist("mhd"):
        from .physics.mhd import MHD
        return MHD(pin, mesh, bvals, device=device, dtype=dtype)
    if pin.does_block_exist("hydro"):
        from .physics.hydro import Hydro
        return Hydro(pin, mesh, bvals, device=device, dtype=dtype)
    raise ValueError("no <hydro> or <mhd> block in input file")


def build(pin, device=None, leaves=None):
    """Mesh -> boundary values -> physics -> pgen -> driver (reference
    main.cpp order).  ``leaves`` gives the tree of a refined mesh (a
    restart's evolved tree).  Returns (mesh, phys, pgen, driver,
    state)."""
    from .bvals import BoundaryValues
    from .driver import Driver
    from .mesh import Mesh
    from .pgen import get_pgen

    dtype = setup_precision(pin)
    dev = resolve_device(device)
    mesh = Mesh(pin, leaves=leaves)
    bvals = BoundaryValues(mesh)
    phys = make_physics(pin, mesh, bvals, dev, dtype)
    pgen = get_pgen(pin.get_string("problem", "pgen_name"))
    state = pgen.init(pin, mesh, phys)
    driver = Driver(pin, mesh, phys)
    return mesh, phys, pgen, driver, state


def profiled(profile_dir, device=None, rank=None):
    """A context that traces what runs inside it with ``torch.profiler``
    (the host's activity, and the card's under CUDA) and writes the trace
    into ``profile_dir`` when it ends, as a ``*.pt.trace.json`` file that
    TensorBoard and Perfetto read (``tensorboard_trace_handler``; the JAX
    package's ``-p`` writes a ``jax.profiler`` trace).  Under ranks each
    rank writes its own file, named ``rank<r>``.  No directory: no
    tracing."""
    import contextlib
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, on_trace_ready=tensorboard_trace_handler(
        profile_dir, worker_name=None if rank is None else f"rank{rank}"))


def run(pin, verbose: bool = False, device=None, ranks=None,
        profile_dir=None):
    """Full run; returns (mesh, phys, driver, state), the mesh and physics
    of the final tree under AMR.  A problem generator with a ``final``
    hook (the wave tests' error files) runs it on the final state.  With
    ``ranks`` (``parallel.Ranks``) the block axis is split over its
    process group on the ranks' device: rank 0 writes the outputs and
    gets the whole final state, the other ranks None.  With
    ``profile_dir`` the whole run is traced there (``profiled``)."""
    from .outputs import make_outputs

    if ranks is not None and device is None:
        device = ranks.device
    with profiled(profile_dir, device, getattr(ranks, "rank", None)):
        mesh, phys, pgen, driver, state = build(pin, device=device)
        driver.ranks = ranks
        outputs = make_outputs(pin, mesh, phys, driver)
        return _evolve(pin, pgen, driver, state, outputs, verbose)


def _evolve(pin, pgen, driver, state, outputs, verbose):
    """Initialise and run the built state with its outputs, then the
    generator's ``final`` hook: (mesh, phys, driver, state) of the final
    tree."""
    state = driver.initialize(state)
    state = driver.execute(state, outputs=outputs, verbose=verbose)
    mesh, phys = driver.mesh, driver.phys
    if hasattr(pgen, "final") and state is not None:
        pgen.final(pin, mesh, phys, state)
    return mesh, phys, driver, state


def run_restart(restart_file, overrides=(), verbose: bool = False,
                device=None, ranks=None, profile_dir=None):
    """Resume a run from a ``.rst`` file (reference restart path:
    src/main.cpp:250-277; the JAX package's ``run_restart``): rebuild
    from the stored parameter dump with ``overrides`` on top, replace
    the problem generator's state with the stored one, keep the stored
    time, dt and cycle, skip the output intervals already passed and the
    initial-condition outputs (the CCE and horizon dumps take their
    stored cadence), and run on.  A refined mesh is rebuilt on
    the stored tree (``tree_leaves``) and an adaptive run takes back its
    cycles since the last refinement (``amr_ncyc_since_ref``).  Under
    ``ranks`` every rank reads the file and keeps its rows; with
    ``profile_dir`` the run is traced there.  Returns (mesh, phys, driver,
    state) of the final tree."""
    from .athinput import ParameterInput
    from .outputs import load_restart, make_outputs
    from .state import state_from_numpy

    params, time, dt, ncycle, rstate, extras = load_restart(
        restart_file, with_extras=True)
    pin = ParameterInput.from_string(params)
    pin.modify_from_cmdline(list(overrides))
    if ranks is not None and device is None:
        device = ranks.device
    with profiled(profile_dir, device, getattr(ranks, "rank", None)):
        mesh, phys, pgen, driver, _ = build(
            pin, device=device, leaves=extras.get("tree_leaves"))
        driver.ranks = ranks
        if driver.pamr is not None and "amr_ncyc_since_ref" in extras:
            driver.pamr.ncyc_since_ref = np.array(
                extras["amr_ncyc_since_ref"], dtype=np.int64)
        state = state_from_numpy(rstate, phys.device, phys.dtype)
        mesh.time, mesh.dt, mesh.ncycle = time, dt, ncycle
        driver.res_flag = True
        outputs = make_outputs(pin, mesh, phys, driver)
        for out in outputs:
            if hasattr(out, "resume"):       # the CCE and horizon dumps
                out.resume(extras)
                continue
            p = out.params
            if p.dt > 0.0:
                nskip = int(math.floor((time + 1e-12) / p.dt)) + 1
                p.file_number = nskip
                p.last_time = nskip * p.dt - p.dt
        return _evolve(pin, pgen, driver, state, outputs, verbose)


def cli(argv=None):
    """Parse the command line and do what it asks.  Returns the run's
    (mesh, phys, driver, state), or None for the flags that quit early."""
    ap = argparse.ArgumentParser(prog="athenak_tpu_torch")
    ap.add_argument("-i", dest="input", help="input athinput file")
    ap.add_argument("-r", dest="restart", default=None,
                    help="restart (.rst) file")
    ap.add_argument("-d", dest="rundir", default=None, help="run directory")
    ap.add_argument("-n", dest="dump_params", action="store_true",
                    help="dump parameters and quit")
    ap.add_argument("-c", dest="show_config", action="store_true",
                    help="show configuration and quit")
    ap.add_argument("-m", dest="show_mesh", action="store_true",
                    help="output mesh structure and quit")
    ap.add_argument("-v", dest="validate", action="store_true",
                    help="validate input file and quit")
    ap.add_argument("-t", dest="walltime", default=None,
                    help="wall time limit hh:mm:ss")
    ap.add_argument("-p", dest="profile_dir", default=None,
                    help="trace the run into this directory "
                    "(torch.profiler)")
    ap.add_argument("-w", dest="watchdog", default=None, type=float,
                    help="watchdog hang-abort window in seconds")
    ap.add_argument("overrides", nargs="*",
                    help="block/par=value parameter overrides")
    args = ap.parse_args(argv)

    if args.show_config:
        dev = resolve_device()
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
            else "cpu"
        print(f"athenak_tpu_torch on torch {torch.__version__}, "
              f"device: {dev} ({name})")
        return None
    if args.restart:
        # resolve the file before -d changes the directory
        restart_path = os.path.abspath(args.restart)
        if args.rundir:
            os.makedirs(args.rundir, exist_ok=True)
            os.chdir(args.rundir)

        def runner():
            return run_restart(restart_path, args.overrides, verbose=True,
                               profile_dir=args.profile_dir)
    else:
        if not args.input:
            ap.error("an input file is required (-i)")
        pin = read_deck(args.input, args.overrides)
        if args.rundir:
            os.makedirs(args.rundir, exist_ok=True)
            os.chdir(args.rundir)
        if args.dump_params:
            pin.dump(sys.stdout)
            return None
        if args.show_mesh or args.validate:
            from .mesh import Mesh
            mesh = Mesh(pin)
            if args.show_mesh:
                print(f"nmb_total={mesh.nmb_total} ({mesh.nmb_x1}x"
                      f"{mesh.nmb_x2}x{mesh.nmb_x3} root blocks)")
                for gid in range(mesh.nmb_total):
                    loc = mesh.lloc_eachmb[gid]
                    print(f"  gid={gid} lloc=({loc[0]},{loc[1]},{loc[2]}) "
                          f"level={int(mesh.mb_lev[gid])}")
            if args.validate:
                from .outputs import make_outputs
                _, phys, _, _, _ = build(pin)
                make_outputs(pin, mesh, phys)
                pin.check_unused_parameters()
                print("validation complete")
            return None

        def runner():
            return run(pin, verbose=True, profile_dir=args.profile_dir)

    from .driver import Driver
    if args.walltime:
        from .utils import parse_walltime
        try:
            Driver.wall_limit = parse_walltime(args.walltime)
        except ValueError:
            ap.error(f"-t expects hh:mm:ss, got '{args.walltime}'")
    wd = None
    if args.watchdog:
        from .utils import WatchDog
        wd = WatchDog(args.watchdog)
        Driver.watchdog = wd
    try:
        result = runner()
    finally:
        if wd is not None:
            wd.stop()
        Driver.watchdog = None
        Driver.wall_limit = None
    print(result[2].finalize_report())
    return result


def main(argv=None) -> int:
    cli(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
