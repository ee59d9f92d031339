"""The ported main path as a whole: the 3-D MHD blast through both packages.

The deck is ``inputs/mhd/blast.athinput`` cut to 16^3 in float64 (JAX runs
in float64 in this suite, tests/conftest.py).  The JAX side runs eagerly
(``jax.disable_jit``): the blast starts at rest and mirror-symmetric, so
the mass flux through a symmetry plane is zero only up to rounding, and
the GS07 upwind selects follow its sign.  Jitted, XLA's fused code
rounds in another order and the two packages part by 1e-2 in the face
field after one cycle; eager JAX rounds operation by operation, as torch
does, and the packages agree to 1e-10.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput  # noqa: E402
from athenak_tpu.vis.readers import read_binary  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = os.path.join(ROOT, "inputs", "mhd", "blast.athinput")
OVERRIDES = ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16",
             "mesh/nx3=16", "mesh/coalesce=false", "mesh/pencil_pack=false"]
INT = (slice(None), slice(None), slice(2, -2), slice(2, -2), slice(2, -2))
INTF = INT[1:]


def _pin(extra=()):
    pin = ParameterInput.from_file(DECK)
    pin.modify_from_cmdline(OVERRIDES + list(extra))
    return pin


def _assert_state_close(ref, got, tol, interior=True):
    """u and bfc within tol of the field maximum."""
    sl, slf = (INT, INTF) if interior else (Ellipsis, Ellipsis)
    ref_u = np.asarray(ref["u"])
    err = np.abs(got["u"][sl] - ref_u[sl]).max() / np.abs(ref_u).max()
    assert err <= tol, f"u: {err:g}"
    bmax = max(float(np.abs(np.asarray(v)).max())
               for v in ref["bfc"].values())
    for c, v in ref["bfc"].items():
        err = np.abs(got["bfc"][c][slf] - np.asarray(v)[slf]).max() / bmax
        assert err <= tol, f"{c}: {err:g}"


def test_build_initialize_parity():
    mj, pj, _, dj, sj = jax_main.build(_pin())
    mt, pt, _, dt_, st = torch_main.build(_pin(), device="cpu")
    sj = dj.initialize(sj)
    st = dt_.initialize(st)
    assert st["u"].dtype == torch.float64 and not pt.kernel_path(st["u"])
    _assert_state_close(sj, state_to_numpy(st), 1e-12, interior=False)
    np.testing.assert_allclose(mt.dt, mj.dt, rtol=1e-12)


def test_three_cycles_parity():
    mj, _, _, dj, sj = jax_main.build(_pin())
    mt, _, _, dt_, st = torch_main.build(_pin(), device="cpu")
    sj = dj.initialize(sj)
    st = dt_.initialize(st)
    cyc_j = dj.make_cycle_fn()
    cyc_t = dt_.make_cycle_fn()
    dt = mj.dt
    for n in range(3):
        with jax.disable_jit():
            sj, dn_j, _ = cyc_j(sj, jnp.asarray(dt))
        st, dn_t, counters = cyc_t(st, dt)
        _assert_state_close(sj, state_to_numpy(st), 1e-10)
        np.testing.assert_allclose(float(dn_t), float(dn_j), rtol=1e-10)
        assert set(counters) == {"neos_dfloor", "neos_efloor",
                                 "neos_tfloor"}
    # on the CPU nothing launches a CUDA kernel
    assert all(k.launches == 0 for k in kernels.ALL)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's run() with time/nlim=3 and its bin dumps
    (main.run's steps, with initialize and execute under disable_jit).
    The blast is sensitive at the ulp level: a first dt one ulp apart
    moves the state by 1e-8 within three cycles, so the first dt, too,
    must be computed eagerly."""
    from athenak_tpu.outputs import make_outputs
    d = tmp_path_factory.mktemp("jax_run")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        pin = _pin(["time/nlim=3"])
        mesh, phys, _, driver, state = jax_main.build(pin)
        outputs = make_outputs(pin, mesh, phys)
        for out in outputs:
            out.driver = driver
        with jax.disable_jit():
            state = driver.initialize(state)
            state = driver.execute(state, outputs=outputs)
    finally:
        os.chdir(cwd)
    return mesh, state, d


def test_run_parity(jax_run, monkeypatch, tmp_path):
    mj, sj, _ = jax_run
    monkeypatch.chdir(tmp_path)
    mt, _, dt_, st = torch_main.run(_pin(["time/nlim=3"]), device="cpu")
    assert mt.ncycle == mj.ncycle == 3
    np.testing.assert_allclose(mt.time, mj.time, rtol=1e-12)
    _assert_state_close(sj, state_to_numpy(st), 1e-10)
    assert dt_.zone_cycles == 3 * 16 ** 3


def test_cli_bin_output_parity(jax_run, monkeypatch, tmp_path):
    _, _, jdir = jax_run
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    assert torch_main.main(["-i", DECK, "-d", str(tmp_path / "run")]
                           + OVERRIDES + ["time/nlim=3"]) == 0
    names = sorted(f for f in os.listdir(tmp_path / "run")
                   if f.endswith(".bin"))
    assert names == ["Blast.mhd_w_bcc.00000.bin",
                     "Blast.mhd_w_bcc.00001.bin"]
    assert names == sorted(f for f in os.listdir(jdir) if f.endswith(".bin"))
    for name in names:
        got = read_binary(str(tmp_path / "run" / name))
        ref = read_binary(str(jdir / name))
        assert got["var_names"] == ref["var_names"]
        assert got["cycle"] == ref["cycle"]
        np.testing.assert_allclose(got["time"], ref["time"], rtol=1e-12)
        for key in ("mb_index", "mb_logical", "mb_geometry"):
            np.testing.assert_array_equal(got[key], ref[key])
        for v in ref["var_names"]:
            a, b = got["mb_data"][v], ref["mb_data"][v]
            scale = max(np.abs(b).max(), 1e-300)
            assert np.abs(a - b).max() <= 1e-10 * scale, v


def test_port_never_imports_jax():
    code = ("import sys; import athenak_tpu_torch, athenak_tpu_torch.main, "
            "athenak_tpu_torch.driver, athenak_tpu_torch.bvals, "
            "athenak_tpu_torch.physics.mhd, athenak_tpu_torch.ops.stage, "
            "athenak_tpu_torch.ops.fill, athenak_tpu_torch.outputs, "
            "athenak_tpu_torch.pgen.blast, athenak_tpu_torch.state, "
            "athenak_tpu_torch.kernels; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_general_path_2d_outflow_parity():
    """The general path in 2-D (corner_e/ct_update without x3) with
    outflow boundaries on cell and face arrays, two cycles."""
    extra = ["mesh/nx1=24", "mesh/nx2=20", "mesh/nx3=1",
             "mesh/ix1_bc=outflow", "mesh/ox1_bc=outflow",
             "mesh/ix2_bc=outflow", "mesh/ox2_bc=outflow"]
    mj, _, _, dj, sj = jax_main.build(_pin(extra))
    mt, pt, _, dt_, st = torch_main.build(_pin(extra), device="cpu")
    assert len(pt.dirs) == 2 and not pt.use_mega_v2
    with jax.disable_jit():
        sj = dj.initialize(sj)
    st = dt_.initialize(st)
    np.testing.assert_allclose(mt.dt, mj.dt, rtol=1e-12)
    cyc_j, cyc_t = dj.make_cycle_fn(), dt_.make_cycle_fn()
    dt = mj.dt
    for _ in range(2):
        with jax.disable_jit():
            sj, dn_j, _ = cyc_j(sj, jnp.asarray(dt))
        st, dn_t, _ = cyc_t(st, dt)
        _assert_state_close(sj, state_to_numpy(st), 1e-10, interior=False)
        np.testing.assert_allclose(float(dn_t), float(dn_j), rtol=1e-10)
