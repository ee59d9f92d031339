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

import ast
import os
import subprocess
import sys
from pathlib import Path

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


def _package_files():
    return sorted(Path(ROOT, "athenak_tpu_torch").rglob("*.py"))


def _port_files():
    return _package_files() + [Path(ROOT, "chip_smoke.py"),
                               Path(ROOT, "chip_profile.py")]


def _port_modules():
    names = []
    for path in _package_files():
        parts = list(path.relative_to(ROOT).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts.pop()
        names.append(".".join(parts))
    return names


def _jax_side(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "athenak_tpu")


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke and chip_profile as
    modules (their mains not run), in a fresh interpreter: neither jax
    nor anything of the JAX package is imported."""
    mods = _port_modules()
    for m in ("ops.stage_split", "ops.stage_v1", "ops.aux", "ops.pool_fill",
              "turb_driver", "pgen.turb", "z4c.fd", "z4c.z4c",
              "z4c.rhs_core", "ops.z4c_stage", "pgen.z4c_one_puncture",
              "refinement", "physics.mhd_smr", "ops.flux", "prng",
              "pgen.orszag_tang", "physics.hydro", "ops.rsolvers",
              "pgen.shock_tube", "pgen.kh", "pgen.shu_osher",
              "pgen.errors", "pgen.linear_wave", "pgen.linear_wave_mhd",
              "pgen.cpaw", "pgen.field_loop", "pgen.current_sheet",
              "ops.fluid", "ops.rsolvers_sr", "srcterms", "units",
              "pgen.rt", "pgen.lw_implode", "pgen.slotted_cyl",
              "pgen.advection", "amr", "amr_pool", "z4c.z4c_amr",
              "diffusion", "gravity", "multigrid", "pgen.diffusion_test",
              "pgen.shock_cloud", "pgen.jeans_wave", "pgen.binary_gravity",
              "pgen.be_collapse", "shearing_box", "particles",
              "physics.ion_neutral", "pgen.shwave", "pgen.mri2d",
              "pgen.mri3d", "pgen.twofluid", "radiation.tetrad",
              "radiation.radiation", "radiation.coupling",
              "radiation.rad_fluid", "pgen.rad_hohlraum", "pgen.rad_beam",
              "pgen.rad_snake", "pgen.rad_relax", "pgen.rad_shadow",
              "pgen.rad_linear_wave", "pgen.rad_diffusion",
              "eos_ps", "eos_ps.policies", "eos_ps.primitive_solver",
              "utils_tov", "dyngr", "pgen.dyngr_tov", "pgen.dynbbh",
              "pgen.import_id", "graphs", "parallel",
              "parallel.shard_comm", "parallel.part_comm"):
        assert f"athenak_tpu_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "import chip_profile\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'athenak_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_import_nothing_of_jax():
    """The same, read from the sources with ast: no import statement of
    the port, chip_smoke or chip_profile names jax or the JAX package."""
    found = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            found += [f"{path.name}:{node.lineno} {n}" for n in names
                      if _jax_side(n)]
    assert not found, found


@pytest.mark.parametrize("extra", [
    [],
    ["coord/special_rel=true", "mhd/rsolver=hlle",
     "mhd/gamma=1.3333333333333333"],
    ["meshblock/nx1=8", "meshblock/nx2=4", "meshblock/nx3=8",
     "mesh/ix1_bc=outflow", "mesh/ox1_bc=outflow", "mesh/ix3_bc=reflect",
     "mesh/ox3_bc=reflect"]])
def test_copied_input_and_mesh_match_jax(extra):
    """The port's copies of ParameterInput and Mesh against the JAX
    package's on the blast deck, its SR variant and a multi-block mesh
    with physical boundaries: same parameters, neighbour tables,
    physical-boundary masks, block extents and cell centres."""
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu_torch.athinput import ParameterInput as TorchInput
    from athenak_tpu_torch.mesh import Mesh as TorchMesh

    pj = _pin(extra)
    pt = TorchInput.from_file(DECK)
    pt.modify_from_cmdline(OVERRIDES + list(extra))
    assert pt.dump() == pj.dump()
    mj, mt = JaxMesh(pj), TorchMesh(pt)
    assert mt.nmb_total == mj.nmb_total
    assert (mt.nmb_total > 1) == bool(extra and "meshblock" in extra[0])
    np.testing.assert_array_equal(mt.lloc_eachmb, mj.lloc_eachmb)
    assert set(mt.nbr_gid) == set(mj.nbr_gid)
    for key in mj.nbr_gid:
        np.testing.assert_array_equal(mt.nbr_gid[key], mj.nbr_gid[key])
        np.testing.assert_array_equal(mt.phys_bc_mask[key],
                                      mj.phys_bc_mask[key])
    for key in ("x1min", "x1max", "x2min", "x2max", "x3min", "x3max"):
        np.testing.assert_array_equal(mt.mb_size[key], mj.mb_size[key])
    for gid in range(mj.nmb_total):
        for a, b in zip(mt.cell_centers(gid), mj.cell_centers(gid)):
            np.testing.assert_array_equal(a, b)


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
