"""First-order flux correction through both packages, and the kernel
gates it and the source terms close.

  * The poked cycle of ``tests/test_fofc.py``: a 2-D 32^2 and a 3-D 16^3
    blast with ``fofc = true``, one cell's total energy scaled by 1e-12
    after initialisation so that its update would floor, then one RK2
    cycle at dt = 1e-3, for hydro HLLC and MHD HLLD, in float64.  The
    port's ``nfofc`` (summed over both stages) equals the JAX package's
    and is positive, and the state after the cycle agrees to 1e-10 of
    each field's scale.  The JAX cycle runs under ``jax.jit`` at XLA's
    backend optimisation level 0.
  * ``inputs/turb/turb.athinput`` (hydro PLM + HLLC, FOFC, driven, one
    ``hst`` output) at 16^3 in float64: three cycles through the port's
    ``main.run`` and the JAX jitted forcing and stage
    (``torch_deck_parity.DeckPair``; the port draws the JAX package's
    own threefry stream), to 1e-10, ``nfofc`` counted.
  * Gates: on a 3-D MHD deck with ``mhd/fofc = true`` or an
    ``<mhd_srcterms>`` block, the port's stage kernels A, C and E are
    off, and kernel D's and kernel J's flags equal the JAX package's
    built with its TPU gate on (``test_torch_mhd_tail._jax_gate``); an
    SR deck keeps its SR solver (J off in the port, ROADMAP F1).  With
    the kernel gate opened for CPU tensors, the FOFC stage hands kernel
    D the corrected mass flux.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.main import build as jax_build  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.ops import stage_split  # noqa: E402
from athenak_tpu_torch.physics import mhd as torch_mhd  # noqa: E402
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402
from test_fofc import BLAST  # noqa: E402
from test_torch_mhd_tail import _GATE_DECK, _SMALL, _jax_gate  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (DeckPair, assert_states_close,  # noqa: E402
                               check_pair, deck_text, jit_o0)

CASES = {"hydro 2d": ("hydro", "hllc", 0.0, 2),
         "hydro 3d": ("hydro", "hllc", 0.0, 3),
         "mhd 2d": ("mhd", "hlld", 1.0, 2),
         "mhd 3d": ("mhd", "hlld", 1.0, 3)}
DT = 1e-3


def _deck(case):
    phys, rsolver, b_amb, ndim = CASES[case]
    text = BLAST.format(phys=phys, rsolver=rsolver, b_amb=b_amb)
    extra = [] if ndim == 2 else ["mesh/nx1=16", "mesh/nx2=16",
                                  "mesh/nx3=16", "mesh/x3min=-0.5",
                                  "mesh/x3max=0.5"]
    return text, extra


def _poke(u, mesh, xp):
    """The energy of the cell at the blast's centre scaled by 1e-12."""
    mbi = mesh.mb_indcs
    k = mbi.ks + (mbi.nx3 // 2 if mbi.nx3 > 1 else 0)
    idx = (0, 4, k, mbi.js + mbi.nx2 // 2, mbi.is_ + mbi.nx1 // 2)
    if xp == "jax":
        return u.at[idx].set(u[idx] * 1e-12)
    u = u.clone()
    u[idx] = u[idx] * 1e-12
    return u


def _jax_poked(text, extra):
    pin = JaxInput.from_string(text)
    pin.modify_from_cmdline(extra + ["mesh/coalesce=false",
                                     "mesh/pencil_pack=false"])
    mesh, phys, _, driver, st = jax_build(pin)
    st = jit_o0(phys.init_ghosts)(st)
    u = _poke(st["u"], mesh, "jax")
    if phys.is_mhd:
        w, u, _ = phys.cons_to_prim(u, st["bcc"])
    else:
        w, u, _ = phys.cons_to_prim(u)
    st = dict(st, u=u, w=w)
    s1, _, counters = jit_o0(driver.make_cycle_fn())(
        st, jnp.asarray(DT, dtype=u.dtype))
    return jax.tree_util.tree_map(np.asarray, s1), int(counters["nfofc"])


def _port_poked(text, extra):
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(extra)
    mesh, phys, _, driver, st = torch_main.build(pin, device="cpu")
    st = driver.initialize(st)
    u = _poke(st["u"], mesh, "torch")
    if phys.is_mhd:
        w, u, _ = phys.cons_to_prim(u, st["bcc"])
    else:
        w, u, _ = phys.cons_to_prim(u)
    st = dict(st, u=u, w=w)
    s1, _, counters = driver.make_cycle_fn()(st, DT)
    return phys, state_to_numpy(s1), int(counters["nfofc"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_poked_cycle_matches_jax(case):
    text, extra = _deck(case)
    ref, nref = _jax_poked(text, extra)
    phys, got, n = _port_poked(text, extra)
    assert phys.use_fofc and phys.is_mhd == case.startswith("mhd")
    assert n == nref and n > 0
    assert_states_close(got, ref, 1e-10)
    assert np.isfinite(got["u"]).all() and (got["w"][:, 0] > 0).all()
    assert all(k.launches == 0 for k in kernels.ALL)


def test_turb_deck_matches_jax(tmp_path):
    p = check_pair(DeckPair(
        deck_text("inputs/turb/turb.athinput"),
        ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16",
         "mesh/nx3=16"], rundir=str(tmp_path)))
    assert p.phys.use_fofc and p.phys.pturb is not None
    assert p.phys.rsolver == "hllc" and not p.phys.is_mhd
    np.testing.assert_array_equal(p.state["turb_key"],
                                  p.jax_state["turb_key"])
    assert "nfofc" in p.driver.ecounters
    # the deck's one output: a history row at t = 0 and one at the end
    rows = (tmp_path / "Turb.hst").read_text().splitlines()
    assert rows[0] == "# Athena++ history data" and len(rows) == 4


# ------------------------------------------------------------------ gates
GATE_CASES = {
    "fofc": ["mhd/fofc=true"],
    "srcterms": ["mhd_srcterms/const_accel=true",
                 "mhd_srcterms/const_accel_val=-0.1",
                 "mhd_srcterms/const_accel_dir=2"],
    "sr fofc": ["mhd/fofc=true", "coord/special_rel=true",
                "mhd/rsolver=hlle"],
    "fofc llf": ["mhd/fofc=true", "mhd/rsolver=llf"],
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_kernel_gates_follow_jax(case):
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    extra = GATE_CASES[case]
    jp = _jax_gate(extra)
    pin = ParameterInput.from_string(deck_text(_GATE_DECK))
    pin.modify_from_cmdline(_SMALL + extra)
    mesh = Mesh(pin)
    tp = torch_mhd.MHD(pin, mesh, BoundaryValues(mesh), "cpu", torch.float32)
    assert not (tp.use_mega_v2 or tp.use_mega_stage or tp.use_fused_stage)
    assert not (jp.use_mega_v2 or jp.use_mega_stage or jp.use_fused_stage)
    assert tp.use_fused_ct == jp.use_fused_ct
    assert tp.use_fused_ct == (case != "fofc llf")
    if tp.is_sr:
        assert jp.use_pallas and not tp.use_flux_dir
    else:
        assert tp.use_flux_dir == jp.use_pallas == (case != "fofc llf")
    assert (tp.srcterms is not None) == (case == "srcterms")


def test_fofc_feeds_kernel_d_the_corrected_mass_flux(monkeypatch):
    """A poked 3-D MHD FOFC cycle with the kernel gate opened for CPU
    tensors: the stage takes J's and D's wrappers (their plain versions
    on the CPU), D reads the FOFC-corrected mass flux, and no stage
    kernel runs."""
    calls = []
    monkeypatch.setattr(torch_mhd, "kernel_dtype_ok", lambda t: True)
    orig = stage_split.fused_ct3d
    monkeypatch.setattr(stage_split, "fused_ct3d", lambda *a, **k: (
        calls.append(a[2]), orig(*a, **k))[1])
    text, extra = _deck("mhd 3d")
    pin = ParameterInput.from_string(text)
    pin.modify_from_cmdline(extra)
    mesh, phys, _, driver, st = torch_main.build(pin, device="cpu")
    assert phys.use_fused_ct and phys.use_flux_dir and not phys.use_mega_v2
    st = driver.initialize(st)
    u = _poke(st["u"], mesh, "torch")
    w, u, _ = phys.cons_to_prim(u, st["bcc"])
    st = dict(st, u=u, w=w)
    flx, emf = phys.fluxes(w, st["bcc"], st["bfc"])
    saved = phys.save_state(st)
    fixed, _, nfofc = phys._apply_fofc(u, saved["u1"], w, st["bcc"],
                                       st["bfc"], flx, emf, 0.0, 1.0, DT)
    assert int(nfofc) > 0
    _, counters = phys.stage_update(st, saved, 0.0, 1.0, DT)
    assert int(counters["nfofc"]) == int(nfofc) and len(calls) == 1
    for n in ("x1", "x2", "x3"):
        np.testing.assert_array_equal(calls[0][n].numpy(),
                                      fixed[n][:, 0].numpy())
        assert not torch.equal(fixed[n][:, 0], flx[n][:, 0])
