"""The statically refined MHD slice, continued (the decks and helpers of
``test_torch_smr_slice.py``, split off so that the two files' JAX
compilations run on different workers).

  * The port alone, several cycles: div(B) below 1e-11 on both levels,
    mass and energy conserved to 1e-12.
  * ``inputs/mhd/blast_smr.athinput`` through the CLI for two cycles, and
    ``-m`` printing the leaf tree as the JAX CLI does.
  * The kernel route: the 2-D deck in float32 with the kernel gate opened
    for CPU tensors, so the fluxes go through kernel J's plain version
    (face floors on), against JAX with ``mhd/use_pallas = true`` and the
    Pallas flux kernel in interpret mode, under the two-tier bound of
    ``test_pallas_parity.py``.
  * Adaptive refinement and prolongation in primitives raise; an SR deck
    on a refined mesh keeps its SR solver and never reaches kernel J.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.ops import pallas_flux  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.ops import flux as torch_flux  # noqa: E402
from athenak_tpu_torch.physics import mhd as torch_mhd  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_torch_refinement import deck, one_torch_thread  # noqa: E402,F401
from test_torch_smr_slice import (BLAST_SMR, _interior,  # noqa: E402
                                  _jax_cycles, _port_initialized)


def _divb_by_level(mesh, bfc):
    """max |div B| over the interior cells of each level."""
    ks = slice(2, -2) if mesh.mb_indcs.nx3 > 1 else slice(None)
    b1, b2, b3 = (bfc[c].numpy() for c in ("x1f", "x2f", "x3f"))
    ms = mesh.mb_size
    div = ((b1[..., 1:] - b1[..., :-1]) / ms["dx1"][:, None, None, None]
           + (b2[:, :, 1:] - b2[:, :, :-1]) / ms["dx2"][:, None, None, None])
    if mesh.mb_indcs.nx3 > 1:
        div = div + (b3[:, 1:] - b3[:, :-1]) / ms["dx3"][:, None, None, None]
    div = np.abs(div[:, ks, 2:-2, 2:-2])
    return [float(div[mesh.mb_lev == lev].max())
            for lev in range(mesh.max_level + 1)]


def _totals(mesh, u):
    """Volume integrals of the conserved variables over the interiors."""
    ks = slice(2, -2) if mesh.mb_indcs.nx3 > 1 else slice(None)
    act = u.numpy()[:, :, ks, 2:-2, 2:-2]
    dv = mesh.mb_size["dx1"] * mesh.mb_size["dx2"]
    if mesh.mb_indcs.nx3 > 1:
        dv = dv * mesh.mb_size["dx3"]
    return (act.sum(axis=(2, 3, 4)) * dv[:, None]).sum(axis=0)


@pytest.mark.parametrize("name,ncyc", [("2d", 10), ("3d", 4)])
def test_divb_and_conservation(name, ncyc):
    pin = ParameterInput.from_string(deck(name))
    pin.modify_from_cmdline([f"time/nlim={ncyc}"])
    mesh, _, _, driver, st = torch_main.build(pin, device="cpu")
    st = driver.initialize(st)
    assert max(_divb_by_level(mesh, st["bfc"])) < 1e-11
    tot0 = _totals(mesh, st["u"])
    st = driver.execute(st)
    assert mesh.ncycle == ncyc
    divb = _divb_by_level(mesh, st["bfc"])
    assert len(divb) == 2 and max(divb) < 1e-11, divb
    tot1 = _totals(mesh, st["u"])
    for i in (0, 4):
        assert abs(tot1[i] - tot0[i]) <= 1e-12 * abs(tot0[i]), i
    assert bool(torch.isfinite(st["u"]).all())
    # the flow crossed the level boundaries
    assert float(st["w"][:, 1:4].abs().max()) > 0.1


def test_blast_smr_deck_runs_on_cpu(monkeypatch, tmp_path, capsys):
    """The shipped deck through the CLI, two cycles; ``-m`` prints the
    leaf tree with levels as the JAX CLI does."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    assert jax_main.main(["-i", BLAST_SMR, "-m"]) == 0
    ref = capsys.readouterr().out
    assert torch_main.main(["-i", BLAST_SMR, "-m"]) == 0
    assert capsys.readouterr().out == ref
    assert "level=1" in ref and "level=0" in ref
    mesh, phys, driver, st = torch_main.cli(
        ["-i", BLAST_SMR, "-d", str(tmp_path / "run"), "time/nlim=2"])
    assert mesh.ncycle == 2 and mesh.nmb_total == 120
    assert max(_divb_by_level(mesh, st["bfc"])) < 1e-11
    assert bool(torch.isfinite(st["u"]).all())
    assert sorted(os.listdir(tmp_path / "run")) == [
        "BlastSMR.mhd_w_bcc.00000.bin", "BlastSMR.mhd_w_bcc.00001.bin"]


@pytest.fixture
def f32_interpret():
    """float32 + Pallas interpret mode for the JAX flux kernel."""
    jax.config.update("jax_enable_x64", False)
    pallas_flux.INTERPRET = True
    yield
    pallas_flux.INTERPRET = False
    jax.config.update("jax_enable_x64", True)


def _tiers(got, ref, scale, label):
    """Two-tier float32 parity (``test_pallas_parity.py:132-165``)."""
    err = np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64))
    err = err / scale
    frac = float((err < 3e-5).mean())
    assert frac > 0.95, f"{label}: only {frac:.4f} of cells within 3e-5"
    assert err.max() < 5e-3, f"{label}: max scale-relative err {err.max():g}"


def test_kernel_route_matches_pallas(f32_interpret, monkeypatch):
    """The 2-D SMR deck in float32: the port with kernel J's route (its
    plain version on the CPU) against JAX with use_pallas = true."""
    extra = ["job/precision=single"]
    _, pj, _, sj, _, dts = _jax_cycles(
        "2d", extra + ["mhd/use_pallas=true"], 2)
    assert pj.use_pallas and not pj.use_fused_stage
    calls = []
    plain = torch_flux.fused_flux_dir

    def spy(*args):
        calls.append(args[4])
        return plain(*args)

    monkeypatch.setattr(torch_mhd, "kernel_dtype_ok", lambda t: True)
    monkeypatch.setattr(torch_flux, "fused_flux_dir", spy)
    mt, pt, dt_, st = _port_initialized("2d", extra)
    assert pt.use_flux_dir and st["u"].dtype == torch.float32
    cyc_t = dt_.make_cycle_fn()
    for dt in dts[:2]:
        st, _, _ = cyc_t(st, dt)
    assert calls == ["x1", "x2"] * 4
    got = state_to_numpy(st)
    ref_u = _interior(sj["u"])
    # per channel; the 2-D vortex has no x3 momentum in either package
    scale = np.abs(ref_u).max(axis=(0, 2, 3, 4), keepdims=True)
    np.testing.assert_array_equal(_interior(got["u"])[:, 3], 0.0)
    _tiers(_interior(got["u"]), ref_u, np.where(scale > 0, scale, 1.0),
           "u")
    bscale = max(float(np.abs(sj["bfc"][c]).max()) for c in ("x1f", "x2f"))
    for c in ("x1f", "x2f"):
        _tiers(_interior(got["bfc"][c]), _interior(sj["bfc"][c]),
               bscale, c)


@pytest.mark.parametrize("case", ["adaptive", "prolong_primitives", "sr"])
def test_unported_options(case, monkeypatch):
    """Adaptive refinement and prolongation in primitives, which raised
    before they were ported, build (``test_torch_amr_*.py`` hold them
    against JAX); an SR deck on a refined mesh builds, keeps its SR
    solver on the general path and never reaches kernel J, even with the
    kernel gate open."""
    text = deck("2d")
    if case == "adaptive":
        text = text.replace("refinement = static", "refinement = adaptive")
    elif case == "prolong_primitives":
        text = text.replace("refinement = static",
                            "refinement = static\nprolong_primitives = true")
    else:
        text = text.replace("<mhd>", "<coord>\nspecial_rel = true\n<mhd>") \
            .replace("rsolver = hlld", "rsolver = hlle") \
            .replace("gamma = 1.6666666666666667",
                     "gamma = 1.3333333333333333")
    if case != "sr":
        text += "<amr_criterion1>\nmethod = location\n"
        mesh, phys, _, driver, _ = torch_main.build(
            ParameterInput.from_string(text), device="cpu")
        if case == "adaptive":
            assert mesh.adaptive and driver.pamr is not None
            assert mesh.amr_pool and phys.multilevel
        else:
            assert not mesh.adaptive and phys.bvals.prolong_prims
        return
    pin = ParameterInput.from_string(text)
    calls = []
    monkeypatch.setattr(torch_mhd, "kernel_dtype_ok", lambda t: True)
    monkeypatch.setattr(torch_flux, "fused_flux_dir",
                        lambda *a: calls.append(a) or None)
    mesh, phys, _, driver, st = torch_main.build(pin, device="cpu")
    assert phys.is_sr and mesh.multilevel and not phys.use_flux_dir
    st = driver.initialize(st)
    st, _, _ = driver.make_cycle_fn()(st, mesh.dt)
    assert not calls
    assert bool(torch.isfinite(st["u"]).all())
