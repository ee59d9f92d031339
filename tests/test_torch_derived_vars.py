"""The derived-variable registry (``outputs/variables.py::resolve``)
against the JAX package's, name for name, on the CPU in float64.

Every name of the reference's ``var_choice`` table that the JAX
``resolve`` takes (the lists of ``tests/test_var_choice_parity.py``) is
one case, on a small deck of its physics: the port runs the deck (16^3
or less, at most two blocks a direction, three cycles; the Z4c and
radiation decks one), and the port's state, as numpy and then JAX
arrays, goes to both packages' ``resolve``.  The labels must be
identical and the interior equal to 1e-10 of the field's scale
(NaN where the other has NaN).  The dimension-dependent names (curl,
curvature, div(B), the 4-current, the dynamo and SGS moments) run again
on the 2-D Orszag-Tang deck and the 1-D Brio-Wu row; ``mhd_jcon`` again
on the GR monopole, where it reads the metric.  The 3-D deck carries an
``mhd_jcon`` output, so the port's driver keeps the prior (w, bcc, dt)
that JAX's test sets by hand.

Three faults of the JAX package are shown here (ROADMAP F29-F31):
``_mhd_curvature``'s B^2 floor of 1e-300 is 0 in float32, so a cell with
B = 0 gives NaN in both packages; ``_prtcl_density`` bins and divides by
the root grid's dx, so on a refined mesh the JAX density misses the
particle count, which the port's (each block's dx) keeps; and JAX's
``turb_force`` reads a ``force`` entry no state holds (the port reads
``turb_force``; the JAX side is given the entry under its name).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu import outputs as jax_outputs  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.outputs import variables as jax_vars  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch import outputs as torch_outputs  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.outputs import variables as port_vars  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_gr_slice import MONOPOLE, shift  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from test_var_choice_parity import (ADM_NAMES, CON_NAMES,  # noqa: E402
                                    HYDRO_NAMES, MHD_NAMES, MISC_NAMES,
                                    RAD_FLUID_PREFIXED, RAD_NAMES,
                                    TMUNU_NAMES, WEYL_NAMES, Z4C_NAMES)
from torch_deck_parity import JAX_EXTRA, deck_text, interior  # noqa: E402

CUT16 = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16", "meshblock/nx1=16",
         "meshblock/nx2=16", "meshblock/nx3=8"]
JCON_OUT = ["output9/file_type=bin", "output9/variable=mhd_jcon",
            "output9/dcycle=1000"]
Z4C_DECK = """
<job>
basename = vc

<mesh>
nghost = 2
nx1 = 8
x1min = -4.0
x1max = 4.0
ix1_bc = outflow
ox1_bc = outflow
nx2 = 8
x2min = -4.0
x2max = 4.0
ix2_bc = outflow
ox2_bc = outflow
nx3 = 8
x3min = -4.0
x3max = 4.0
ix3_bc = outflow
ox3_bc = outflow

<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
tlim = 0.1

<z4c>
diss = 0.1

<problem>
pgen_name = z4c_one_puncture
"""


def _rad_deck():
    from torch_deck_parity import deck_literal
    return deck_literal("test_rad_gr.py", "RAD_LWAVE_DECK")


# deck -> (text, overrides, cycles)
DECKS = {
    "mhd3d": (lambda: deck_text("inputs/mhd/blast.athinput"),
              ["job/precision=double", "mhd/nscalars=1", *CUT16,
               *JCON_OUT], 3),
    "mhd2d": (lambda: deck_text("inputs/mhd/orszag_tang.athinput"),
              ["mesh/nx1=16", "mesh/nx2=16", "meshblock/nx1=8",
               "meshblock/nx2=16", *JCON_OUT], 3),
    "mhd1d": (lambda: deck_text("inputs/mhd/bw.athinput"),
              ["mesh/nx1=32", "problem/bxl=0.75", "problem/byl=1.0",
               "problem/byr=-1.0", *JCON_OUT], 3),
    "hydro": (lambda: deck_text("inputs/tests/advect_hyd.athinput"),
              ["mesh/nx1=16", "mesh/nx2=16", "meshblock/nx1=16",
               "meshblock/nx2=8"], 3),
    "gr": (lambda: MONOPOLE, shift((16, 16, 8), (-6, -6, 0), (6, 6, 6))
           + JCON_OUT, 3),
    "turb": (lambda: deck_text("inputs/turb/turb.athinput"),
             ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16",
              "mesh/nx3=16"], 3),
    "drift": (lambda: deck_text("inputs/particles/random_drift.athinput"),
              ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"], 3),
    "grav": (lambda: deck_text("inputs/tests/jeans_wave.athinput"),
             ["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8",
              "meshblock/nx1=16", "meshblock/nx2=8", "meshblock/nx3=8"], 3),
    "dyngr": (lambda: deck_text("inputs/dyn_grmhd/sod.athinput"),
              ["mesh/nx1=32"], 3),
    "z4c": (lambda: Z4C_DECK, [], 1),
    "rad": (_rad_deck, ["mesh/nx1=16", "meshblock/nx1=16"], 1),
}
MISC_DECK = {"turb_force": "turb", "prtcl_d": "drift", "grav_phi": "grav",
             "mhd_t": "dyngr"}
# the names of the dimension-dependent kernels, run on every MHD deck
NDIM_NAMES = ["mhd_wz", "mhd_w2", "mhd_jz", "mhd_j2", "mhd_bmag",
              "mhd_divb", "mhd_curv", "mhd_curv_alt", "mhd_k_jxb",
              "mhd_curv_perp", "mhd_jcon", "mhd_sgs", "mhd_dynamo_ks"]

CASES = (
    [("hydro", n) for n in HYDRO_NAMES]
    + [("mhd3d", n) for n in MHD_NAMES + ["mhd_curv_alt"]]
    + [(d, n) for d in ("mhd2d", "mhd1d") for n in NDIM_NAMES]
    + [("gr", "mhd_jcon")]
    + [("rad", n) for n in RAD_NAMES]
    + [("mhd3d" if "mhd" in n else "hydro", n) for n in RAD_FLUID_PREFIXED]
    + [("z4c", n) for n in Z4C_NAMES + ADM_NAMES + CON_NAMES + WEYL_NAMES]
    + [("dyngr", n) for n in TMUNU_NAMES]
    # the rest of the table but prtcl_all, the trk output's raw dump
    + [(MISC_DECK[n], n) for n in MISC_NAMES if n != "prtcl_all"])


def _port_run(text, overrides, ncyc):
    """The deck through the port's driver for ``ncyc`` cycles (no output
    written) on its per-cycle loop, which keeps the prior (w, bcc, dt)
    that ``mhd_jcon`` reads (the batched window keeps none, as the JAX
    driver's does not), reached as the JAX tests reach it: ``verbose``;
    (mesh, phys, driver, state of host-ready tensors)."""
    import contextlib
    import io
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(list(overrides) + [f"time/nlim={ncyc}"])
    mesh, phys, _, driver, state = torch_main.build(pin, device="cpu")
    state = driver.initialize(state)
    with contextlib.redirect_stdout(io.StringIO()):
        state = driver.execute(state, verbose=True)
    return mesh, driver.phys, driver, state


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


_RUNS = {}


def run(deck):
    """The port's run of a deck and the JAX package's mesh and physics of
    the same parameters, with the port's state as JAX arrays (shared by
    the module's cases)."""
    if deck not in _RUNS:
        text, overrides, ncyc = DECKS[deck]
        text = text()
        mesh, phys, driver, state = _port_run(text, overrides, ncyc)
        pj = JaxInput.from_string(text)
        pj.modify_from_cmdline(JAX_EXTRA + list(overrides))
        jmesh, jphys, _, _, _ = jax_main.build(pj)
        jst = _to_jax(state_to_numpy(state))
        prev = getattr(phys, "_jcon_prev", None)
        if prev is not None:
            jphys._jcon_prev = (jnp.asarray(prev[0].numpy()),
                                jnp.asarray(prev[1].numpy()), prev[2])
        _RUNS[deck] = (mesh, phys, state, jmesh, jphys, jst)
    return _RUNS[deck]


def _compare(name, got, ref, labels, jlabels):
    assert list(labels) == list(jlabels), name
    got = got.detach().cpu().numpy()
    ref = np.asarray(ref)
    if name == "grav_phi":
        ref = ref[:, 0]      # JAX's phi[:, None] (ROADMAP F18)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert len(labels) == got.shape[1], name
    g, r = interior(got), interior(ref)
    assert np.array_equal(np.isnan(g), np.isnan(r)), name
    fin = np.isfinite(r)
    scale = float(np.abs(r[fin]).max()) if fin.any() else 0.0
    err = float(np.abs(g[fin] - r[fin]).max()) if fin.any() else 0.0
    assert err <= 1e-10 * scale, f"{name}: {err:g} of scale {scale:g}"


@pytest.mark.parametrize("deck,name", CASES,
                         ids=[f"{d}-{n}" for d, n in CASES])
def test_resolve_matches_jax(deck, name, one_torch_thread):
    mesh, phys, state, jmesh, jphys, jst = run(deck)
    if name == "turb_force":
        # JAX's resolve reads state["force"] (ROADMAP F31)
        jst = dict(jst, force=jst["turb_force"])
    labels, got = port_vars.resolve(name, phys, state, mesh)
    if name == "adm_psi4":
        # JAX's passes the six-component list to its 3x3 determinant
        # (ROADMAP F11): det(gamma)^(1/6) of its own ADM metric instead
        _, adm = jax_vars.resolve("adm", jphys, jst, jmesh)
        xx, xy, xz, yy, yz, zz = (np.asarray(adm[:, i]) for i in range(6))
        det = xx * (yy * zz - yz * yz) - xy * (xy * zz - yz * xz) \
            + xz * (xy * yz - yy * xz)
        jlabels, ref = ["adm_psi4"], (det ** (1.0 / 6.0))[:, None]
    else:
        jlabels, ref = jax_vars.resolve(name, jphys, jst, jmesh)
    _compare(name, got, ref, labels, jlabels)


def test_jcon_reads_the_saved_prior_state(one_torch_thread):
    """The driver keeps the last cycle's (w, bcc, dt) for ``mhd_jcon``;
    the 4-current is then non-zero, and zero without a prior state."""
    mesh, phys, state, _, _, _ = run("mhd3d")
    w_old, bcc_old, dt = phys._jcon_prev
    assert w_old.shape == state["w"].shape and 0.0 < dt < 1.0
    _, j = port_vars.resolve("mhd_jcon", phys, state, mesh)
    assert float(interior(j.numpy()).__abs__().max()) > 0.0
    phys._jcon_prev = None
    try:
        _, j = port_vars.resolve("mhd_jcon", phys, state, mesh)
        assert not j.any()
    finally:
        phys._jcon_prev = (w_old, bcc_old, dt)


def test_unknown_names_raise_value_error():
    mesh, phys, state, jmesh, jphys, jst = run("mhd3d")
    for name in ("prtcl_all", "mhd_nope", "hydro_nope", "nope"):
        with pytest.raises(ValueError):
            port_vars.resolve(name, phys, state, mesh)
        with pytest.raises(ValueError):
            jax_vars.resolve(name, jphys, jst, jmesh)


def test_output_types_are_jax_types():
    assert sorted(torch_outputs._TYPES) == sorted(jax_outputs._TYPES)


def test_f29_curvature_floor_is_zero_in_float32(one_torch_thread):
    """ROADMAP F29: B^2 is floored at 1e-300, which is 0 in float32, so
    where B = 0 the curvatures are 0/0 in both packages; in float64 the
    floor holds and they are 0."""
    text = deck_text("inputs/mhd/blast.athinput")
    over = CUT16 + ["problem/b_amb=0.0"]
    for prec, nan in (("single", True), ("double", False)):
        pin = ParameterInput.from_string(text)
        pin.modify_from_cmdline(over + [f"job/precision={prec}"])
        mesh, phys, _, driver, state = torch_main.build(pin, device="cpu")
        state = phys.unpack_state(driver.initialize(state))
        pj = JaxInput.from_string(text)
        pj.modify_from_cmdline(JAX_EXTRA + over)
        jmesh, jphys, _, _, _ = jax_main.build(pj)
        jst = _to_jax(state_to_numpy(state))
        for key in ("curv", "curv_alt", "k_jxb", "curv_perp"):
            _, got = port_vars.resolve(f"mhd_{key}", phys, state, mesh)
            _, ref = jax_vars.resolve(f"mhd_{key}", jphys, jst, jmesh)
            assert got.dtype == (torch.float32 if nan else torch.float64)
            assert bool(torch.isnan(got).all()) == nan, (prec, key)
            assert bool(np.isnan(np.asarray(ref)).all()) == nan, (prec, key)
            if not nan:
                assert not got.any() and not np.asarray(ref).any()


def test_f30_particle_density_on_a_refined_mesh(one_torch_thread):
    """ROADMAP F30: on test_particles.py's two-level deck the port's
    sum of prtcl_d times the cell volume is the particle count, block by
    block; the JAX package's, binned with the root grid's dx, is not."""
    from test_particles import SMR_DECK
    mesh, phys, _, state = _port_run(SMR_DECK, [], 2)
    assert mesh.multilevel and int(mesh.mb_lev.max()) == 1
    _, d = port_vars.resolve("prtcl_d", phys, state, mesh)
    d = interior(d.numpy())[:, 0]
    vol = (mesh.mb_size["dx1"] * mesh.mb_size["dx2"]
           * mesh.mb_size["dx3"])
    per_block = d.sum(axis=(1, 2, 3)) * vol
    nprt = state["prtcl_x"].shape[0]
    gids = phys.ppart.gids(state["prtcl_x"])
    np.testing.assert_allclose(per_block,
                               np.bincount(gids, minlength=mesh.nmb_total),
                               rtol=1e-12)
    assert abs(per_block.sum() - nprt) <= 1e-9 * nprt
    pj = JaxInput.from_string(SMR_DECK)
    pj.modify_from_cmdline(JAX_EXTRA)
    jmesh, jphys, _, _, _ = jax_main.build(pj)
    _, ref = jax_vars.resolve("prtcl_d", jphys,
                              _to_jax(state_to_numpy(state)), jmesh)
    ref = interior(np.asarray(ref))[:, 0]
    jsum = (ref.sum(axis=(1, 2, 3)) * vol).sum()
    assert abs(jsum - nprt) > 0.01 * nprt


def test_f31_jax_turb_force_reads_no_entry(one_torch_thread):
    """ROADMAP F31: JAX's ``turb_force`` reads state["force"], which its
    turbulence driver never makes (it keeps "turb_force"): its own state
    raises KeyError, where the port's resolves."""
    mesh, phys, state, jmesh, jphys, jst = run("turb")
    assert "force" not in jst and "turb_force" in jst
    with pytest.raises(KeyError):
        jax_vars.resolve("turb_force", jphys, jst, jmesh)
    labels, f = port_vars.resolve("turb_force", phys, state, mesh)
    assert labels == ["force1", "force2", "force3"]
    assert float(f.abs().max()) > 0.0
