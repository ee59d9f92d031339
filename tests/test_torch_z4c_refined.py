"""Z4c on refined meshes: the port against the JAX package in float64 on
the CPU.

  * ``refinement.prolong_cc4`` (4th-order Lagrange prolongation, 5-point
    stencil) against JAX's on random arrays to 1e-13;
  * ``tests/test_z4c_smr.py``'s mesh (16^3 root of 8^3 blocks, nghost 4,
    one level-1 region: 15 blocks, RK3): flat space (the puncture with
    zero mass) stays an exact fixed point through the 4th-order
    mixed-level fills over a cycle, and the single puncture (periodic,
    as ``test_puncture_on_smr``) agrees with JAX over an RK stage;
  * ``inputs/z4c/one_puncture_amr.athinput`` at a 16^3 root of 8^3
    blocks (outflow, RK4, ``dchi``) with the puncture moved into one
    root block and ``dchi_max`` 0.2, so that only that block refines,
    two cycles: the tree refines after the first, both packages take
    the same tree and agree;
  * ``Z4cAMR``'s flags (chi, dchi, the radius shells) on random states.

The JAX cycles run outside ``jax.jit`` (``tests/test_torch_z4c_ops.py``:
a right-hand side is thousands of small operations, each compiled once);
its AMR step runs as the JAX package has it, with ``jax.jit`` made the
identity so that its rebuild's fills run the same way.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu import refinement as jax_ref  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu.z4c.z4c_amr import Z4cAMR as JaxZ4cAMR  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch import refinement  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.mesh import Mesh  # noqa: E402
from athenak_tpu_torch.z4c.z4c_amr import Z4cAMR  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import deck_text  # noqa: E402

SMR_DECK = """
<job>
basename = z4csmr
<mesh>
nghost = 4
nx1 = 16
x1min = -8.0
x1max = 8.0
nx2 = 16
x2min = -8.0
x2max = 8.0
nx3 = 16
x3min = -8.0
x3max = 8.0
<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8
<mesh_refinement>
refinement = static
num_levels = 2
<refined_region1>
level = 1
x1min = -4.0
x1max = 0.0
x2min = -4.0
x2max = 0.0
x3min = -4.0
x3max = 0.0
<time>
evolution = dynamic
integrator = rk3
cfl_number = 0.25
nlim = 1
tlim = 10.0
<z4c>
diss = 0.5
damp_kappa1 = 0.02
damp_kappa2 = 0.0
lapse_oplog = 2.0
lapse_advect = 1.0
shift_eta = 2.0
chi_min_floor = 1.0e-12
<problem>
pgen_name = z4c_one_puncture
punc_ADM_mass = 1.0
"""

AMR_DECK = "inputs/z4c/one_puncture_amr.athinput"
AMR_CUT = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16",
           "mesh_refinement/num_levels=2", "time/nlim=2",
           "z4c_amr/dchi_max=0.2",
           "problem/punc_center_x1=-5.1", "problem/punc_center_x2=-4.9",
           "problem/punc_center_x3=-5.3"]


def scaled_err(got, want):
    want = np.asarray(want)
    return float((np.abs(np.asarray(got) - want)
                  / np.maximum(np.abs(want), 1.0)).max())


@pytest.mark.parametrize("axes", [[-1], [-2, -1], [-3, -2, -1], [-3, -1]])
def test_prolong_cc4_matches_jax(axes):
    rng = np.random.default_rng(len(axes))
    c = rng.standard_normal((3, 2, 9, 10, 11))
    ref = np.asarray(jax_ref.prolong_cc4(jnp.asarray(c), axes))
    got = refinement.prolong_cc4(torch.as_tensor(c), axes).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert refinement.prolong_guard(4) == 2 == jax_ref.prolong_guard(4)
    # exact on quartic polynomials along one axis
    x = np.arange(9.0) - 4.0
    q = (x ** 4 - 2 * x ** 3 + x - 0.5)[None, :]
    fine = refinement.prolong_cc4(torch.as_tensor(q), [-1]).numpy()
    xf = np.repeat(x[2:-2], 2) + np.tile([-0.25, 0.25], 5)
    np.testing.assert_allclose(fine[0], xf ** 4 - 2 * xf ** 3 + xf - 0.5,
                               rtol=0, atol=1e-12)


def _jax_run(pin, ncyc, amr=False):
    """The JAX package's build, initialize and ``ncyc`` cycles outside
    jit with the driver's dt rule (and its AMR step); the final u, the
    time and the trees."""
    mesh, phys, _, driver, state = jax_main.build(pin)
    state = driver.initialize(state)
    trees = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", lambda f, **kw: f)
        for _ in range(ncyc):
            cycle = driver.make_cycle_fn()
            state, dtnew, _ = cycle(state, jnp.asarray(driver.mesh.dt))
            m = driver.mesh
            m.time += m.dt
            m.ncycle += 1
            m.dt = min(2.0 * m.dt, driver.cfl_no * float(dtnew))
            if amr:
                state, changed = driver.pamr.step(driver, state)
                if changed:
                    m = driver.mesh
                    dtn = float(driver.phys.dt_from_state(state))
                    m.dt = min(m.dt, driver.cfl_no * dtn)
                    trees.append((m.ncycle, [tuple(int(v) for v in leaf)
                                             for leaf in m.leaves]))
    return np.asarray(state["u"]), driver.mesh, trees


def _port_run(pin, tmp_path):
    pin.modify_from_cmdline([f"job/basename={tmp_path}/z4c"])
    return torch_main.run(pin, device="cpu")


def test_flat_fixed_point_on_smr(tmp_path):
    pin = ParameterInput.from_string(SMR_DECK)
    pin.modify_from_cmdline(["problem/punc_ADM_mass=0.0"])
    mesh, phys, pgen, driver, state = torch_main.build(pin, device="cpu")
    assert mesh.multilevel and mesh.nmb_total == 15
    assert phys.bvals.prolong_order == 4 and not phys.use_stage_kernel
    state = driver.initialize(state)
    u0 = state["u"].clone()
    state = driver.execute(state)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    assert float((state["u"] - u0)[act].abs().max()) < 1e-12


def test_puncture_on_smr_matches_jax():
    """The first RK3 stage of the puncture on the refined mesh from the
    initialised state: the right-hand side with per-block spacings, the
    4th-order mixed-level fill and the projection."""
    jmesh, jphys, _, jdrv, jst = jax_main.build(
        JaxInput.from_string(SMR_DECK))
    jst = jdrv.initialize(jst)
    rk = jdrv.integrator
    args = (rk.gam0[0], rk.gam1[0], rk.beta[0] * jmesh.dt)
    ref = np.asarray(jphys.stage_update(jst, jphys.save_state(jst),
                                        *args)[0]["u"])
    mesh, phys, _, driver, st = torch_main.build(
        ParameterInput.from_string(SMR_DECK), device="cpu")
    st = driver.initialize(st)
    assert mesh.dt == jmesh.dt == pytest.approx(0.25 * 0.5)
    assert isinstance(phys.idx[0], torch.Tensor)
    assert phys.idx[0].shape == (15, 1, 1, 1)
    u = phys.stage_update(st, phys.save_state(st), *args)[0]["u"].numpy()
    assert scaled_err(u, ref) <= 1e-10
    assert np.isfinite(u).all() and u[:, 18].min() > 0.0


def test_one_puncture_amr_matches_jax(tmp_path):
    text = deck_text(AMR_DECK)
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(AMR_CUT)
    ref, jmesh, jtrees = _jax_run(pj, 2, amr=True)
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(AMR_CUT)
    mesh, phys, driver, st = _port_run(pt, tmp_path)
    trees = [(r["ncycle"], r["leaves"]) for r in driver.pamr.updates]
    assert trees == jtrees and len(trees) == 1
    assert mesh.nmb_total == jmesh.nmb_total == 15
    assert driver.pamr.z4c_amr.method == "dchi"
    assert phys.multilevel and not phys.use_stage_kernel
    assert mesh.time == pytest.approx(jmesh.time, rel=1e-14)
    u = st["u"].numpy()
    assert scaled_err(u, ref) <= 1e-10
    assert u[:, 0].min() > 0.0


Z4C_AMR = """
<mesh>
nghost = 4
nx1 = 32
x1min = -10.0
x1max = 10.0
nx2 = 32
x2min = -10.0
x2max = 10.0
nx3 = 32
x3min = -10.0
x3max = 10.0
<meshblock>
nx1 = 8
nx2 = 8
nx3 = 8
<mesh_refinement>
refinement = adaptive
num_levels = 3
<z4c>
diss = 1.0
<z4c_amr>
{body}
"""


@pytest.mark.parametrize("body", [
    "method = chi_min\nchi_min = 0.4",
    "method = dchi\ndchi_max = 0.02",
    "method = trivial\nradius_0_rad = 6.0\nradius_0_reflevel = 2\n"
    "radius_1_rad = 12.0\nradius_1_reflevel = 1"])
def test_z4c_amr_flags_match_jax(body):
    text = Z4C_AMR.format(body=body)
    pj, pt = JaxInput.from_string(text), ParameterInput.from_string(text)
    jz, tz = JaxZ4cAMR(pj), Z4cAMR(pt)
    assert tz.method == jz.method and tz.radius == jz.radius
    jmesh, mesh = JaxMesh(pj), Mesh(pt)
    rng = np.random.default_rng(5)
    mbi = mesh.mb_indcs
    r = np.linspace(0.0, 1.0, mesh.nmb_total)[:, None, None, None, None]
    u = 0.1 + 2.0 * r * (0.5 + 0.1 * rng.random(
        (mesh.nmb_total, 22, mbi.ncells3, mbi.ncells2, mbi.ncells1)))
    ref = np.asarray(jz.device_flags(jnp.asarray(u), jmesh))
    got = tz.device_flags(torch.as_tensor(u), mesh).numpy()
    np.testing.assert_array_equal(got, ref)
    lev = np.zeros(mesh.nmb_total, np.int64)
    lev[::3] = 1
    lev[::7] = 2
    jmesh.mb_lev, mesh.mb_lev = lev, lev.copy()
    ref = jz.host_flags(ref.copy(), {"u": u}, jmesh, None)
    got = tz.host_flags(got.copy(), {"u": u}, mesh, None)
    np.testing.assert_array_equal(got, ref)
    assert set(ref.tolist()) >= {-1, 1} or tz.method == "trivial"


def test_tracker_method_raises():
    """``method = tracker`` is ported: its flags (the trackers' distance
    to each block's box, against each tracker's radius and level) equal
    the JAX package's on a tree with three levels; an unknown method
    raises, in both packages."""
    text = Z4C_AMR.format(body="method = tracker")
    pj, pt = JaxInput.from_string(text), ParameterInput.from_string(text)
    jz, tz = JaxZ4cAMR(pj), Z4cAMR(pt)
    assert tz.method == jz.method == "tracker"
    jmesh, mesh = JaxMesh(pj), Mesh(pt)
    lev = np.zeros(mesh.nmb_total, np.int64)
    lev[::3] = 1
    lev[::7] = 2
    jmesh.mb_lev, mesh.mb_lev = lev, lev.copy()

    class Phys:                      # what host_flags reads of Z4c
        nco = 2
        tracker_pos0 = np.array([[2.6, -1.0, 0.0], [-4.0, 0.0, 0.0]])
        tracker_radius = np.array([3.0, 1.5])
        tracker_reflevel = np.array([2, -1])

    flags = np.zeros(mesh.nmb_total, np.int32)
    pos = np.array([[2.4, -1.1, 0.3], [-4.2, 0.1, -0.2]])
    ref = jz.host_flags(flags.copy(), {"co_pos": jnp.asarray(pos)}, jmesh,
                        Phys)
    got = tz.host_flags(flags.copy(), {"co_pos": torch.as_tensor(pos)},
                        mesh, Phys)
    np.testing.assert_array_equal(got, ref)
    assert set(ref.tolist()) == {-1, 0, 1}
    np.testing.assert_array_equal(
        tz.host_flags(flags.copy(), {}, mesh, Phys),
        jz.host_flags(flags.copy(), {}, jmesh, Phys))
    bad = Z4C_AMR.format(body="method = nearest")
    for cls, inp in ((Z4cAMR, ParameterInput), (JaxZ4cAMR, JaxInput)):
        with pytest.raises(ValueError, match="nearest"):
            cls(inp.from_string(bad))
