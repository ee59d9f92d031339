"""The statically refined MHD slice through both packages.

The decks are ``test_torch_refinement.py``'s: the 2-D Orszag-Tang vortex
on 28 blocks of two levels and the 3-D blast on 120 blocks of 4^3, in
float64 (JAX runs in float64 in this suite, tests/conftest.py).

  * Three cycles through the port's ``main.cli`` (with a ``bin`` dump)
    against three JAX cycles: u and the face field on the interiors, the
    time and the dt chain to 1e-10, the dump's block locations, levels
    and extents equal to the JAX mesh's and its data to 1e-10.  The JAX
    cycles run under ``jax.jit`` at XLA's backend optimisation level 0
    from the port's initialised state (its fills, which match the JAX
    package's, ``test_torch_smr_fill.py``); the first dt of both packages
    from that state agrees to 1e-12.  Compiling the JAX package's
    initialisation too would add half a minute.

The port alone on the same decks, kernel J's route against JAX's Pallas
route and the options that raise are in ``test_torch_smr_route.py``.

``inputs/mhd/blast_smr.athinput`` itself runs through the CLI in
``test_torch_smr_route.py``.  It is not held against JAX cycle by cycle: its blast sits
at rest on the corner of eight blocks, so the mass flux through the
three symmetry planes is zero up to rounding and the corner EMFs'
upwind selects follow the sign of that noise; torch's vectorised CPU
square root and XLA's differ in the last bit, and the two packages part
by 1e-3 within a cycle.  The 3-D deck here moves the blast off the
faces.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.vis.readers import read_binary  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_refinement import deck, one_torch_thread  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLAST_SMR = os.path.join(ROOT, "inputs", "mhd", "blast_smr.athinput")
NCYC = 3
JAX_EXTRA = ["mesh/coalesce=false", "mesh/pencil_pack=false"]
OUTPUT = """
<output1>
file_type = bin
variable = mhd_w_bcc
dcycle = 100
"""


def _jit_o0(fn):
    return jax.jit(fn, compiler_options={"xla_backend_optimization_level": 0})


def _interior(a):
    """The interior cells (faces: the interior and its upper face) of a
    cell [nmb, nvar, n3, n2, n1] or face [nmb, n3, n2, n1] array."""
    sl = [slice(None)] * a.ndim
    for ax in range(a.ndim - 3, a.ndim):
        if a.shape[ax] > 2:
            sl[ax] = slice(2, -2)
    return a[tuple(sl)]


_JAX_RUNS = {}


def _port_initialized(name, extra=()):
    """The port's mesh, physics, driver and state after initialisation."""
    pin = ParameterInput.from_string(deck(name))
    pin.modify_from_cmdline(list(extra))
    mesh, phys, _, driver, st = torch_main.build(pin, device="cpu")
    return mesh, phys, driver, driver.initialize(st)


def _jax_cycles(name, extra=(), ncyc=NCYC):
    """JAX from the port's initialised state: its first dt and ``ncyc``
    cycles with the port driver's dt chain (2x growth, CFL); the JAX mesh
    and physics, the port's first dt, the final state as numpy, the time
    and the dts."""
    pin = JaxInput.from_string(deck(name))
    pin.modify_from_cmdline(JAX_EXTRA + list(extra))
    mesh, phys, _, driver, _ = jax_main.build(pin)
    mt, _, _, st_t = _port_initialized(name, extra)
    st = jax.tree_util.tree_map(jnp.asarray, state_to_numpy(st_t))
    dt_of = _jit_o0(phys.dt_from_state)
    dt = min(driver.cfl_no * float(dt_of(st)), float(np.finfo(np.float32).max))
    # the JAX driver's cycle (driver.py:188-241 for this physics), its
    # stage compiled once with the RK coefficients traced: half the
    # compile time of the whole cycle
    stage = _jit_o0(lambda s, sv, g0, g1, bdt: phys.stage_update(
        s, sv, g0, g1, bdt)[0])
    integ, dtype = driver.integrator, st["u"].dtype
    t, dts = 0.0, [dt]
    for _ in range(ncyc):
        saved = phys.save_state(st)
        for s in range(integ.nexp_stages):
            st = stage(st, saved, *(jnp.asarray(v, dtype) for v in (
                integ.gam0[s], integ.gam1[s],
                integ.beta[s] * jnp.asarray(dt, dtype))))
        t += dt
        dt = min(2.0 * dt, driver.cfl_no * float(dt_of(st)))
        dts.append(dt)
    return (mesh, phys, mt.dt, jax.tree_util.tree_map(np.asarray, st), t,
            dts)


def _jax_run(name):
    if name not in _JAX_RUNS:
        _JAX_RUNS[name] = _jax_cycles(name)
    return _JAX_RUNS[name]


def _close(got, ref, tol, label):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()
    assert err <= tol, f"{label}: {err:g}"


@pytest.mark.parametrize("name", ["2d", "3d"])
def test_cli_matches_jax(name, monkeypatch, tmp_path):
    mj, _, dt0, sj, tj, dts = _jax_run(name)
    np.testing.assert_allclose(dt0, dts[0], rtol=1e-12)
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    path = tmp_path / "smr.athinput"
    path.write_text(deck(name) + OUTPUT)
    mesh, phys, driver, st = torch_main.cli(
        ["-i", str(path), "-d", str(tmp_path / "run"), f"time/nlim={NCYC}"])
    assert mesh.ncycle == NCYC and mesh.multilevel
    assert not phys.use_flux_dir or not st["u"].is_cuda
    mbi = mesh.mb_indcs
    assert driver.zone_cycles == NCYC * mesh.nmb_total * mbi.nx1 * mbi.nx2 \
        * mbi.nx3
    np.testing.assert_allclose(mesh.time, tj, rtol=1e-10)
    np.testing.assert_allclose(mesh.dt, dts[-1], rtol=1e-10)
    got = state_to_numpy(st)
    _close(_interior(got["u"]), _interior(sj["u"]), 1e-10, "u")
    bmax = max(float(np.abs(v).max()) for v in sj["bfc"].values())
    for c, v in sj["bfc"].items():
        err = np.abs(_interior(got["bfc"][c]) - _interior(v)).max()
        assert err <= 1e-10 * bmax, f"{c}: {err / bmax:g}"
    # the last bin dump: the tree and the interior primitives
    names = sorted(os.listdir(tmp_path / "run"))
    dump = read_binary(str(tmp_path / "run" / names[-1]))
    assert dump["cycle"] == NCYC and dump["n_mbs"] == mj.nmb_total
    np.testing.assert_array_equal(dump["mb_logical"][:, :3], mj.lloc_eachmb)
    np.testing.assert_array_equal(dump["mb_logical"][:, 3], mj.mb_lev)
    geo = np.stack([mj.mb_size[k] for k in ("x1min", "x1max", "x2min",
                                            "x2max", "x3min", "x3max")], 1)
    np.testing.assert_array_equal(dump["mb_geometry"], geo)
    ref = np.concatenate([sj["w"], sj["bcc"]], axis=1)
    for i, v in enumerate(dump["var_names"]):
        a = dump["mb_data"][v]
        b = _interior(ref[:, i:i + 1])[:, 0]
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(b).max(), 1e-300), v
    assert all(k.launches == 0 for k in kernels.ALL)
