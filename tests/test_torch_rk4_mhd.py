"""MHD under RK4 (``time/integrator=rk4``) against the JAX package.

The RK4()4[2S] integrator keeps a second register that every stage
after the first accumulates (``accumulate_rk4``: u1 + delta u, and each
face array alike).  Each case runs one deck through both packages for
two RK4 cycles in float64 on the CPU (``torch_deck_parity.DeckPair``,
the JAX side with its own ``MHD.accumulate_rk4``) and holds the
initial and initialised states to 1e-12 and u and the face field after
the cycles to 1e-10 of their scale:

  * the 3-D blast cut to 16^3 on kernel A's route (its gate opened for
    CPU tensors, so the wrapper runs A's plain version), moved by 0.3 of
    a cell off its mirror planes, each cycle against the JAX driver's
    own cycle run eagerly (``jax.disable_jit``), as
    ``tests/test_torch_mhd_slice.py`` holds the blast: the blast starts
    at rest, where a zero mass flux's rounding noise picks the GS07
    upwind branch (ROADMAP F4), and under RK4 XLA's fused rounding of
    the jitted stage (even at its optimisation level 0) parts the face
    field from the eager one by 5e-9 of its scale in two cycles, where
    eager JAX and the port agree to 3e-16;
  * ``linear_wave_mhd`` cut to 16 x 8 x 8 on the general route;
  * ``mub1`` (SR MHD) at 128 cells, against JAX's jnp path (F1);
  * ``torus_sane`` (GR MHD) cut to 24 x 24 x 16 at its cell size (see
    ``TORUS_CUT``), moved by 0.3 of a cell (F4),
    w through its conserved image (F12), as
    ``tests/test_torch_gr_slice.py`` holds the torus (the face field
    needs no rounding floor on this cut);
  * the driven MHD turbulence deck (``chip_smoke.TURB_DECK``) cut to
    16^3 on kernels E + F's route (their gate opened for CPU tensors,
    so each wrapper runs its plain version), the JAX side with its own
    turbulence driver applied before ``save_state``, the forcing field
    and the threefry key held too;
  * the Orszag-Tang deck with a refined centre (``chip_smoke.OT_SMR``,
    two levels) on kernel J's route (its plain version);

each of the last two also against the port's general route (1e-10 of
each field's scale).  One case holds the port's batched window on the
blast at 8^3 (two batches of 16 RK4 cycles, kernel A's route) bitwise
to its per-cycle loop.  A second test builds every physics class the
driver steps (Newtonian, SR and GR, hydro and MHD) under every
integrator of ``make_integrator`` and takes one cycle: each physics has
the registers each integrator asks for.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
import chip_smoke  # noqa: E402
from athenak_tpu_torch.ops import flux as torch_flux  # noqa: E402
from athenak_tpu_torch.physics import mhd as torch_mhd  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_batch_window import port_run  # noqa: E402
from test_torch_gr_slice import assert_gr_states_close, shift  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (JAX_EXTRA, DeckPair,  # noqa: E402
                               assert_close, assert_states_close,
                               check_pair, deck_text)

RK4 = ["time/integrator=rk4"]
F64 = ["job/precision=double"]
BLAST = "inputs/mhd/blast.athinput"
CUT3 = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
BLAST_CUT = F64 + CUT3 + shift((16, 16, 16), (-1.0,) * 3, (1.0,) * 3)
# the torus at its shipped cell size (1) on 24 x 24 x 16 cells about the
# hole.  Cut to 16^3 it is ill-conditioned under RK4 in both packages:
# at the shipped extent (cells 3.75 wide) it blows up within two cycles
# (u to 1e23-1e30 of its scale) from the corners of the outflow faces
# (the stages with gam0 < 0 pass through the floors), and as a cube of
# 16 at cell size 1 two units in the last place of u move u by 2e-5 of
# its scale in two cycles (first-order flux correction flags flipping
# beside the outflow faces, which cut the torus); this cut moves it by
# 7e-15
TORUS_CUT = F64 + ["mesh/nx1=24", "mesh/nx2=24", "mesh/nx3=16"] + shift(
    (24, 24, 16), (-12.0, -12.0, -8.0), (12.0, 12.0, 8.0))
# deck, overrides, the route of its stages on the CPU (A: kernel A's
# gate opened, so its plain version runs)
CASES = {
    "blast_a": (BLAST, BLAST_CUT, "A"),
    "linear_wave_mhd": ("inputs/tests/linear_wave_mhd.athinput",
                        ["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8"],
                        "general"),
    "mub1": ("inputs/srmhd/mub1.athinput", ["mesh/nx1=128"], "general"),
    "torus_sane": ("inputs/grmhd/torus_sane.athinput", TORUS_CUT,
                   "general"),
    # the two kernel routes, held to JAX and to the general route
    "turb_e_vs_general": (None, F64 + CUT3, "E"),
    "ot_smr_j_vs_general": ("inputs/mhd/orszag_tang.athinput",
                            F64 + chip_smoke.OT_SMR, "J"),
    "blast_window_vs_loop": (BLAST, F64 + ["mesh/nx1=8", "mesh/nx2=8",
                                           "mesh/nx3=8", "time/nlim=32",
                                           "time/tlim=10"],
                             "A"),
}
NCYC = 2


def _blast_cycles(text, overrides):
    """NCYC cycles of both drivers' ``make_cycle_fn`` on the same dt
    (the JAX one eagerly), u and the face field within 1e-10 of their
    scale and the new dt within 1e-10 after each; the port on A's
    route."""
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + list(overrides))
    mj, _, _, dj, sj = jax_main.build(pj)
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(list(overrides))
    mt, phys, _, dt_, st = torch_main.build(pt, device="cpu")
    sj, st = dj.initialize(sj), dt_.initialize(st)
    assert dj.integrator.name == dt_.integrator.name == "rk4"
    assert phys.stage_route(st["u"]) == "A"
    assert_states_close(state_to_numpy(st), jax.tree_util.tree_map(
        np.asarray, sj), 1e-12, keys=("u",))
    cyc_j, cyc_t = dj.make_cycle_fn(), dt_.make_cycle_fn()
    dt = mj.dt
    for _ in range(NCYC):
        with jax.disable_jit():
            sj, dn_j, _ = cyc_j(sj, jnp.asarray(dt))
        st, dn_t, _ = cyc_t(st, dt)
        ref = jax.tree_util.tree_map(np.asarray, sj)
        assert_states_close(state_to_numpy(st), ref, 1e-10, keys=("u",))
        np.testing.assert_allclose(float(dn_t), float(dn_j), rtol=1e-10)
        dt = min(2.0 * dt, dj.cfl_no * float(dn_j))
    assert all(k.launches == 0 for k in kernels.ALL)


def _kernel_route_pair(text, overrides, route, monkeypatch, rundir):
    """The deck on a kernel route's plain versions (its gate opened for
    CPU tensors) against the JAX package (``DeckPair``, 1e-10), and
    against the port's own general route (1e-10 of each field's
    scale)."""
    calls = []
    plain = torch_flux.fused_flux_dir

    def spy(*args):
        calls.append(args[4])
        return plain(*args)
    with monkeypatch.context() as m:
        m.setattr(torch_mhd, "kernel_dtype_ok", lambda t: True)
        m.setattr(torch_flux, "fused_flux_dir", spy)
        p = DeckPair(text, overrides, ncyc=NCYC, rundir=rundir)
        got = p.phys.stage_route(torch.from_numpy(p.port_ready["u"]))
    assert p.driver.integrator.name == "rk4"
    assert p.phys.multilevel == (route == "J")
    if route == "E":
        assert got == "E" and not calls
        assert p.phys.pturb is not None
        np.testing.assert_array_equal(p.state["turb_key"],
                                      p.jax_state["turb_key"])
        assert_close(p.state["turb_force"], p.jax_state["turb_force"],
                     1e-10, "turb_force")
    else:
        assert got == "general" and calls[:4] == ["x1", "x2"] * 2
        assert len(calls) == 2 * 4 * NCYC
    check_pair(p)
    gen = port_run(text, overrides + [f"time/nlim={NCYC}"])
    assert gen["route"] == "general"
    assert gen["mesh"].ncycle == NCYC
    assert_states_close(p.state, gen["state"], 1e-10)
    assert np.abs(p.state["u"] - p.port_ready["u"]).max() > 0.0


@pytest.mark.parametrize("case", sorted(CASES))
def test_rk4_matches_reference(case, monkeypatch, tmp_path,
                               one_torch_thread):
    path, extra, route = CASES[case]
    text = deck_text(path) if path else chip_smoke.TURB_DECK
    overrides = RK4 + extra
    if route in ("E", "J"):
        _kernel_route_pair(text, overrides, route, monkeypatch,
                           str(tmp_path))
        return
    if route == "A":
        monkeypatch.setattr(torch_mhd, "kernel_dtype_ok", lambda t: True)
    if case == "blast_window_vs_loop":
        win = port_run(text, overrides)
        loop = port_run(text, overrides, verbose=True)
        assert win["route"] == "A" and win["driver"].window["batches"] == 2
        assert loop["driver"].window is None
        assert win["mesh"].ncycle == loop["mesh"].ncycle == 32
        for key, ref in loop["state"].items():
            got = win["state"][key]
            for c in (ref if isinstance(ref, dict) else [None]):
                np.testing.assert_array_equal(
                    got if c is None else got[c], ref if c is None
                    else ref[c], err_msg=f"{key} {c}")
        assert (win["mesh"].time, win["mesh"].dt) == \
            (loop["mesh"].time, loop["mesh"].dt)
        assert win["driver"].ecounters == loop["driver"].ecounters
        return
    if case == "blast_a":
        _blast_cycles(text, overrides)
        return
    p = DeckPair(text, overrides, ncyc=NCYC, rundir=str(tmp_path))
    assert p.driver.integrator.name == "rk4"
    assert p.phys.stage_route(torch.from_numpy(p.port_ready["u"])) == route
    if case == "torus_sane":
        assert p.mesh.ncycle == NCYC and p.phys.is_gr
        assert_states_close(p.port_init, p.jax_init, 1e-12)
        assert_gr_states_close(p, p.port_ready, p.jax_ready, 1e-12)
        assert_gr_states_close(p, p.state, p.jax_state, 1e-10)
        np.testing.assert_allclose(p.mesh.time, p.jax_time, rtol=1e-10)
    else:
        check_pair(p)
        assert p.phys.is_sr == (case == "mub1")
    assert np.abs(p.state["u"] - p.port_ready["u"]).max() > 0.0
    assert all(k.launches == 0 for k in kernels.ALL)


# one deck of each physics class the driver steps, cut small
PHYSICS = {
    "hydro": ("inputs/hydro/sod.athinput", ["mesh/nx1=32"]),
    "sr_hydro": ("inputs/srhydro/mb1.athinput", ["mesh/nx1=32"]),
    "gr_hydro": ("inputs/grhydro/bondi.athinput",
                 ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8"]),
    "mhd": (BLAST, F64 + ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8"]),
    "sr_mhd": ("inputs/srmhd/mub1.athinput", ["mesh/nx1=32"]),
    "gr_mhd": ("inputs/grmhd/torus_sane.athinput",
               F64 + ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8"]),
}
INTEGRATORS = ("rk1", "rk2", "rk3", "rk4", "imex2", "imex2+", "imex3")


@pytest.mark.parametrize("integ", INTEGRATORS)
@pytest.mark.parametrize("physics", sorted(PHYSICS))
def test_every_physics_steps_every_integrator(physics, integ,
                                              one_torch_thread):
    path, extra = PHYSICS[physics]
    pin = ParameterInput.from_string(deck_text(path))
    pin.modify_from_cmdline(list(extra) + [f"time/integrator={integ}",
                                           "time/nlim=1"])
    mesh, phys, _, driver, st = torch_main.build(pin, device="cpu")
    assert driver.integrator.name == integ
    assert phys.is_sr == physics.startswith("sr_")
    assert phys.is_gr == physics.startswith("gr_")
    assert hasattr(phys, "accumulate_rk4")
    st0 = state_to_numpy(driver.initialize(st))
    st = driver.execute(driver.initialize(st))
    assert mesh.ncycle == 1 and mesh.time > 0.0
    got = state_to_numpy(st)
    assert np.isfinite(got["u"]).all()
    assert np.abs(got["u"] - st0["u"]).max() > 0.0
    if physics.endswith("mhd"):
        assert all(np.isfinite(v).all() for v in got["bfc"].values())
