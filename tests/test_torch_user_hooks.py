"""The problem generators' hooks, the kernel gates they and GR close, and
the star-disk magnetosphere that uses both hooks, against the JAX
package, float64 on the CPU.

  * ``inputs/mhd/disk_magnetosphere.athinput`` cut to 32 x 32 x 16 in
    eight blocks (moved by 0.3 of a cell: the disk and the dipole are
    symmetric about faces of the grid, ROADMAP F4): the initial state to
    1e-12, three cycles through the port's ``main.run`` against the JAX
    package's jitted cycle at 1e-10, and the planet's history columns
    against the JAX package's hook on the same state.  The JAX package's
    state carries no time, so its planets never act and its history hook
    fails for want of ``t``; the JAX run here is given ``t`` (its cycle
    then advances it), as the port's state carries it.
  * GR closes every MHD kernel: the port's gates for A, C, D, E and J on
    GR decks equal the JAX package's built with its TPU gate on, and on a
    Newtonian PLM + HLLD deck marked GR each gate function closes, the
    port's and the JAX package's.
  * The hooks: a source-term hook or a user boundary function installed
    after the physics is built closes kernel A at run time and leaves the
    stage to kernel E, as the JAX package's ``_mega_v2_active`` and route
    order; a user boundary function closes kernel F's fill and the pool
    route of the v1 stage; it closes the Z4c outflow fold (kernel I),
    the port's gate and the JAX package's.
  * An adaptive-mesh rebuild carries both hooks to the new physics.
"""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (JAX_EXTRA, JaxInput,  # noqa: E402
                               assert_states_close, deck_text, jit_o0)

DISK = "inputs/mhd/disk_magnetosphere.athinput"
DISK_CUT = ["mesh/nx1=32", "mesh/nx2=32", "mesh/nx3=16", "meshblock/nx1=16",
            "meshblock/nx2=16", "meshblock/nx3=8",
            "mesh/x1min=-1.9625", "mesh/x1max=2.0375",
            "mesh/x2min=-1.9625", "mesh/x2max=2.0375",
            "mesh/x3min=-0.9625", "mesh/x3max=1.0375"]
NCYC = 3


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """The disk through both packages: (JAX objects and states, the
    port's run, its directory)."""
    from athenak_tpu import main as jax_main
    text = deck_text(DISK)
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + DISK_CUT)
    jmesh, jphys, _, jdrv, js = jax_main.build(pj)
    jinit = jax.tree_util.tree_map(np.asarray, js)
    js = jdrv.initialize(dict(js, t=jnp.asarray(0.0)))
    cycle = jit_o0(jdrv.make_cycle_fn())
    dt = jnp.asarray(jdrv.mesh.dt)
    for _ in range(NCYC):
        js, dtn, _ = cycle(js, dt)
        dt = jnp.asarray(min(float(dtn) * jdrv.cfl_no, 2.0 * float(dt)))
    run = tmp_path_factory.mktemp("disk")
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(DISK_CUT + [f"time/nlim={NCYC}",
                                       "output1/data_format=%.17e"])
    cwd = os.getcwd()
    os.chdir(run)
    try:
        _, tphys0, _, _, st0 = torch_main.build(
            ParameterInput.from_string(pt.dump()), device="cpu")
        tinit = state_to_numpy(st0)
        res = torch_main.run(pt, device="cpu")
    finally:
        os.chdir(cwd)
    return types.SimpleNamespace(
        jmesh=jmesh, jphys=jphys, jinit=jinit,
        jstate=jax.tree_util.tree_map(np.asarray, jdrv._unpadded(js)),
        tinit=tinit, res=res, run=run)


def test_disk_initial_state(disk):
    assert_states_close(disk.tinit, disk.jinit, 1e-12)
    assert float(disk.tinit["t"]) == 0.0 and "t" not in disk.jinit
    mesh, phys = disk.res[0], disk.res[1]
    assert mesh.nmb_total == 8
    assert phys.srcterms_func.needs_time and phys.srcterms_func.needs_bcc
    assert phys.bvals.user_bc_func is not None


def test_disk_three_cycles(disk):
    mesh, phys, driver, st = disk.res
    got = state_to_numpy(st)
    assert mesh.ncycle == NCYC
    assert_states_close(got, disk.jstate, 1e-10)
    np.testing.assert_allclose(float(got["t"]), float(disk.jstate["t"]),
                               rtol=1e-10)
    np.testing.assert_allclose(mesh.time, float(got["t"]), rtol=1e-12)
    assert np.isfinite(got["u"]).all()
    # the planets' ramp has begun: the source term moved the gas
    assert float(got["t"]) > 0.0


def test_disk_history(disk):
    """The rows of ``diskmag.hst`` (t = 0 and the end) carry the planet's
    14 columns; the last row's are the JAX package's hook on the port's
    final state (given its time)."""
    mesh, phys, _, st = disk.res
    lines = (disk.run / "diskmag.hst").read_text().splitlines()
    rows = np.array([[float(x) for x in ln.split()] for ln in lines[2:]])
    assert rows.shape == (2, 2 + 8 + 14)
    labels, vals = disk.jphys.user_hist_func(
        disk.jmesh, jax.tree_util.tree_map(jnp.asarray, state_to_numpy(st)))
    assert labels[-1] == "mp0" and len(labels) == 14
    for lab in labels:
        assert f"={lab}" in lines[1]
    np.testing.assert_allclose(rows[-1, -14:], vals, rtol=1e-12,
                               atol=1e-12 * np.abs(vals).max())
    assert rows[0, -1] == 0.0 and 0.0 < rows[-1, -1] < 1e-3


# ------------------------------------------------------------------ gates
def _jax_mhd(text, extra):
    """The JAX package's MHD with its TPU gate evaluated (the route forced
    on, x64 off while the object is built)."""
    from athenak_tpu.athinput import ParameterInput as JaxIn
    from athenak_tpu.bvals import BoundaryValues as JaxBvals
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu.physics.mhd import MHD as JaxMHD
    pin = JaxIn.from_string(text)
    pin.modify_from_cmdline(extra + ["mhd/use_pallas=true"])
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        mesh = JaxMesh(pin)
        return JaxMHD(pin, mesh, JaxBvals(mesh)), mesh
    finally:
        jax.config.update("jax_enable_x64", x64)


def _port_mhd(text, extra):
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    from athenak_tpu_torch.physics.mhd import MHD
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(extra)
    mesh = Mesh(pin)
    return MHD(pin, mesh, BoundaryValues(mesh), "cpu", torch.float32), mesh


GR_DECKS = {"torus_sane": ("inputs/grmhd/torus_sane.athinput",
                           ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=12"]),
            "monopole": ("inputs/tests/monopole.athinput",
                         ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]),
            "gr_monopole": ("inputs/tests/gr_monopole.athinput",
                            ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=8",
                             "meshblock/nx1=8", "meshblock/nx2=16",
                             "meshblock/nx3=8", "mesh/nghost=2"]),
            "torus llf": ("inputs/grmhd/torus_sane.athinput",
                          ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=12",
                           "mhd/rsolver=llf", "mhd/fofc=false"])}


@pytest.mark.parametrize("case", sorted(GR_DECKS))
def test_gr_closes_the_kernels_as_jax(case):
    path, extra = GR_DECKS[case]
    jp, _ = _jax_mhd(deck_text(path), extra)
    tp, _ = _port_mhd(deck_text(path), extra)
    assert tp.is_gr and jp.is_gr and not jp.use_pallas
    for flag in ("use_fused_stage", "use_fused_ct", "use_mega_stage",
                 "use_mega_v2"):
        assert getattr(tp, flag) == getattr(jp, flag) is False, flag
    assert not tp.use_flux_dir                 # JAX: no use_pallas fluxes
    assert tp.fofc_excise_mask is not None and jp.fofc_excise_mask is not None
    np.testing.assert_array_equal(tp.fofc_excise_mask.numpy(),
                                  np.asarray(jp.fofc_excise_mask))
    np.testing.assert_array_equal(tp.excise_mask.numpy(),
                                  np.asarray(jp.excise_mask))


_NEWTON = ("inputs/tests/linear_wave_mhd.athinput",
           ["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8"])


def test_gr_clause_of_each_gate():
    """A Newtonian PLM + HLLD deck, the gates' physics all open, then
    marked GR: every gate function closes, the port's and the JAX
    package's (``pallas_stage.py:171-174, 365, 566``)."""
    from athenak_tpu.ops import pallas_stage as jps
    from athenak_tpu_torch.ops import flux, stage, stage_split
    text, extra = deck_text(_NEWTON[0]), _NEWTON[1]
    jp, jmesh = _jax_mhd(text, extra)
    tp, tmesh = _port_mhd(text, extra)
    port = {"pallas_physics": lambda: stage.pallas_physics(tp),
            "A": lambda: stage.supports_mega_v2(tp, tmesh),
            "E": lambda: stage.supports_mega_stage(tp, tmesh),
            "C": lambda: stage_split.supports_fused_stage(tp, tmesh),
            "D": lambda: stage_split.supports_fused_ct(tp, tmesh),
            "J": lambda: flux.supports_flux_dir(tp)}
    jax_ = {"A": lambda: jps.supports_mega_v2(jp, jmesh),
            "E": lambda: jps.supports_mega_stage(jp, jmesh),
            "D": lambda: jps.supports_fused_ct(jp, jmesh)}
    for name, fn in port.items():
        assert fn(), name
    for name, fn in jax_.items():
        assert fn(), name
    tp.is_gr = jp.is_gr = True
    for name, fn in list(port.items()) + list(jax_.items()):
        assert not fn(), name


def _set_hook(phys, which):
    if which == "srcterms_func":
        phys.srcterms_func = lambda u, w, beta_dt: u
    elif which == "user_bc_func":
        phys.bvals.user_bc_func = lambda u, bv: u


@pytest.mark.parametrize("blocks", [1, 8], ids=["block", "pool"])
@pytest.mark.parametrize("hook", [None, "srcterms_func", "user_bc_func"])
def test_hooks_close_kernels_as_jax(hook, blocks, monkeypatch):
    """The stage route on a (simulated) float32 card tensor, with a hook
    installed after the physics is built: A without one, E with one, as
    the JAX package's ``_mega_v2_active`` and ``use_mega_stage``; the v1
    route's fill: F on one block, the pool fill and F on a pool, the
    general fill under a user boundary function (``mhd.py:1601-1610``;
    the JAX fill flags set as a TPU sets them)."""
    from athenak_tpu.ops import pallas_stage as jps
    from athenak_tpu_torch import bvals as tbv
    from athenak_tpu_torch.ops import stage
    from athenak_tpu_torch.physics import mhd as tmhd
    text = deck_text("inputs/mhd/blast.athinput")
    extra = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
    if blocks == 8:
        extra += ["meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8"]
    jp, jmesh = _jax_mhd(text, extra)
    tp, tmesh = _port_mhd(text, extra)
    assert jp.use_mega_v2 and tp.use_mega_v2
    _set_hook(jp, hook)
    _set_hook(tp, hook)
    card = torch.zeros(1)
    monkeypatch.setattr(tmhd, "kernel_dtype_ok", lambda t: True)
    monkeypatch.setattr(tbv, "kernel_dtype_ok", lambda t: True)
    route = tp.stage_route(card)
    assert (route == "A") == jp._mega_v2_active()
    assert route == ("A" if hook is None else "E")
    assert (route == "E") == (not jp._mega_v2_active() and jp.use_mega_stage)
    assert stage.supports_mega_v2(tp, tmesh) == jps.supports_mega_v2(jp,
                                                                      jmesh)
    # the JAX v1 route's fill branches, its TPU flags as on a TPU
    jbv = jp.bvals
    jbv.use_pallas_fill = tp.bvals.use_fill_kernel
    jbv.use_pool_fill = tp.bvals.use_pool_fill
    if jbv.use_pallas_fill and jbv.user_bc_func is None:
        ref = "F"
    elif jbv.use_pool_fill and jbv.user_bc_func is None:
        ref = "G+F"
    else:
        ref = "general"
    assert tp.aux_route(card) == ref
    assert ref == ("general" if hook == "user_bc_func"
                   else "F" if blocks == 1 else "G+F")


def test_user_bc_closes_the_z4c_fold():
    from athenak_tpu.athinput import ParameterInput as JaxIn
    from athenak_tpu.bvals import BoundaryValues as JaxBvals
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu.ops.pallas_z4c import fold_bc_supported as jax_fold
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    from athenak_tpu_torch.ops.z4c_stage import fold_bc_supported
    text = deck_text("inputs/z4c/one_puncture.athinput")
    extra = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
    jpin, tpin = JaxIn.from_string(text), ParameterInput.from_string(text)
    jpin.modify_from_cmdline(extra)
    tpin.modify_from_cmdline(extra)
    jmesh, tmesh = JaxMesh(jpin), Mesh(tpin)
    jbv, tbv = JaxBvals(jmesh), BoundaryValues(tmesh)
    z = types.SimpleNamespace(bvals=jbv, multilevel=False)
    assert fold_bc_supported(tbv) and jax_fold(z, jmesh)
    jbv.user_bc_func = tbv.user_bc_func = lambda u, bv: u
    assert not fold_bc_supported(tbv) and not jax_fold(z, jmesh)


@pytest.mark.parametrize("deck", ["inputs/mhd/blast_amr.athinput",
                                  "inputs/hydro/blast_hydro_amr.athinput"])
def test_amr_rebuild_keeps_the_hooks(deck, tmp_path, monkeypatch):
    """A tree update builds new boundaries and physics: the problem
    generator's hooks come along (the JAX ``amr.py:845-848``)."""
    monkeypatch.chdir(tmp_path)
    pin = ParameterInput.from_string(deck_text(deck))
    pin.modify_from_cmdline(["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
                             "meshblock/nx1=8", "meshblock/nx2=8",
                             "meshblock/nx3=8"])
    mesh, phys, _, driver, state = torch_main.build(pin, device="cpu")
    state = driver.initialize(state)
    calls = []

    def src(u, w, beta_dt):
        calls.append("src")
        return u

    def ubc(u, bv):
        calls.append("bc")
        return u

    phys.srcterms_func, phys.bvals.user_bc_func = src, ubc
    leaves = list(mesh.leaves)
    state = driver.pamr.rebuild(driver, state, leaves,
                                [("same", i) for i in range(len(leaves))])
    new = driver.phys
    assert new is not phys and new.bvals is not phys.bvals
    assert new.srcterms_func is src and new.bvals.user_bc_func is ubc
    assert "bc" in calls                      # the rebuild's fills ran it
    state, _, _ = driver.make_cycle_fn()(state, driver.mesh.dt)
    assert "src" in calls
