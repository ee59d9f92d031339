"""The ion-neutral two-fluid of the port
(``athenak_tpu_torch/physics/ion_neutral.py``, the ImEx cycle,
``pgen/twofluid.py``) against the JAX package, float64 on the CPU.

  * Three cycles of ``inputs/ion-neutral/drag`` under imex2, imex2+ and
    imex3, with the drag as shipped and at 1e6 (the stiff limit of
    ``tests/test_ion_neutral.py``), through both packages' ImEx cycles:
    the neutrals, the ions, the face field and the stiff residuals
    ``ru`` to 1e-10, the initial states to 1e-12.
  * ``_stiff_residual`` and ``_imp_update`` (every implicit stage of
    imex2, imex2+ and imex3, with ionisation and recombination on) on
    random states to 1e-12.
  * The JAX tests' drag bars on the port: relaxation at
    gamma_d (rho_i + rho_n) within 0.03 dv0 with momentum to 1e-12, and
    the stiff drag's equilibration.
  * A ``-r`` restart of the deck bitwise against a straight run.
"""

import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.driver import make_integrator as jax_integ  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.driver import make_integrator  # noqa: E402
from athenak_tpu_torch.indices import IDN, IVX  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_cycle_parity import CyclePair  # noqa: E402
from torch_deck_parity import assert_close, deck_text, jit_o0  # noqa: E402

DRAG = "inputs/ion-neutral/drag.athinput"
CASES = {"imex2": ["time/integrator=imex2"],
         "imex2+": ["time/integrator=imex2+"],
         "imex3": ["time/integrator=imex3"],
         "stiff": ["time/integrator=imex2", "ion-neutral/drag_coeff=1e6",
                   "time/tlim=0.05"]}


@pytest.mark.parametrize("case", sorted(CASES))
def test_drag_three_cycles(case, tmp_path):
    pair = CyclePair(deck_text(DRAG), CASES[case], rundir=str(tmp_path))
    pair.check(extra=("ui", "wi", "ru"))
    assert pair.driver.integrator.name == CASES[case][0].split("=")[1]
    # the coupling moved the two fluids toward each other
    vi = pair.state["wi"][:, IVX, 0, 0, 2:-2]
    vn = pair.state["w"][:, IVX, 0, 0, 2:-2]
    assert np.abs(vi - vn).max() < 0.2


def _physics():
    """Both packages' IonNeutral on the shipped deck, with ionisation and
    recombination switched on (float64)."""
    extra = ["ion-neutral/ionization_coeff=0.3",
             "ion-neutral/recombination_coeff=0.7"]
    pj = JaxInput.from_string(deck_text(DRAG))
    pj.modify_from_cmdline(extra)
    pt = ParameterInput.from_string(deck_text(DRAG))
    pt.modify_from_cmdline(extra)
    jp = jax_main.build(pj)[1]
    tp = torch_main.build(pt, device="cpu")[1]
    return jp, tp


def _random_state(tp, rng):
    mbi = tp.mesh.mb_indcs
    shape = (tp.mesh.nmb_total, 5, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    st = {}
    for k in ("u", "ui"):
        a = rng.normal(size=shape)
        a[:, IDN] = rng.uniform(0.5, 2.0, size=a[:, IDN].shape)
        st[k] = a
    st["ru"] = rng.normal(size=(shape[0], 4, 8) + shape[2:])
    return st


def test_stiff_residual_random():
    jp, tp = _physics()
    st = _random_state(tp, np.random.default_rng(5))
    ref = np.asarray(jit_o0(jp._stiff_residual)(jnp.asarray(st["ui"]),
                                                 jnp.asarray(st["u"])))
    got = tp._stiff_residual(torch.as_tensor(st["ui"]),
                             torch.as_tensor(st["u"])).numpy()
    assert_close(got, ref, 1e-12, "R")


@pytest.mark.parametrize("name", ["imex2", "imex2+", "imex3"])
def test_implicit_update_random(name):
    """Every implicit stage on random states, dt 0.07: ui, u (the
    neutrals) and ru to 1e-12."""
    jp, tp = _physics()
    st = _random_state(tp, np.random.default_rng(6))
    ji, ti = jax_integ(name), make_integrator(name)
    dt = 0.07
    for istage in range(1, ti.nimp_stages + 2):
        ref = jit_o0(lambda s: jp._imp_update(s, istage, ji, dt))(
            {k: jnp.asarray(v) for k, v in st.items()})
        got = tp._imp_update({k: torch.as_tensor(v) for k, v in st.items()},
                             istage, ti, torch.tensor(dt,
                                                      dtype=torch.float64))
        for k in ("ui", "u", "ru"):
            assert_close(got[k].numpy(), np.asarray(ref[k]), 1e-12,
                         f"{k} stage {istage}")


def _run(integ, drag, tlim, tmp_path):
    pin = ParameterInput.from_string(deck_text(DRAG))
    pin.modify_from_cmdline([f"time/integrator={integ}",
                             f"ion-neutral/drag_coeff={drag}",
                             f"time/tlim={tlim}", "mesh/nx1=16"])
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        return torch_main.run(pin, device="cpu")
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("integ", ["imex2", "imex3"])
def test_drag_relaxation_bar(integ, tmp_path):
    """``tests/test_ion_neutral.py::test_drag_relaxation`` on the port:
    dv(t) = dv0 exp(-gamma (d_i + d_n) t) within 0.03 dv0, total
    momentum to 1e-12."""
    drag = 4.0
    mesh, phys, _, st = _run(integ, drag, 0.4, tmp_path)
    mbi = mesh.mb_indcs
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    ui, un = st["ui"].numpy(), st["u"].numpy()
    vi = (ui[:, 1][act] / ui[:, IDN][act]).mean()
    vn = (un[:, 1][act] / un[:, IDN][act]).mean()
    di, dn, dv0 = 0.4, 1.2, 0.2
    dv = dv0 * math.exp(-drag * (di + dn) * mesh.time)
    vcom = (di * 0.1 + dn * (-0.1)) / (di + dn)
    assert abs((vi - vn) - dv) < 0.03 * dv0
    assert abs(ui[:, 1][act].mean() + un[:, 1][act].mean()
               - (di * 0.1 + dn * (-0.1))) < 1e-12
    assert abs(vi - (vcom + dn / (di + dn) * dv)) < 0.03 * dv0


def test_stiff_drag_bar(tmp_path):
    """``tests/test_ion_neutral.py::test_stiff_drag_stable`` on the port."""
    _, _, _, st = _run("imex2", 1.0e6, 0.05, tmp_path)
    ui, un = st["ui"].numpy(), st["u"].numpy()
    assert np.isfinite(ui).all() and np.isfinite(un).all()
    vcom = (0.4 * 0.1 + 1.2 * (-0.1)) / 1.6
    np.testing.assert_allclose(ui[:, 1] / ui[:, IDN], vcom, atol=0.01)
    np.testing.assert_allclose(un[:, 1] / un[:, IDN], vcom, atol=0.01)
    assert abs(ui[:, 1].mean() + un[:, 1].mean()
               - (0.4 * 0.1 + 1.2 * (-0.1))) < 1e-12


def test_drag_restart_is_bitwise(tmp_path, monkeypatch):
    """The drag deck: six cycles straight against three, a ``.rst``
    (with ui, wi and ru), then ``-r`` and three more; every state entry
    bitwise equal."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    deck = tmp_path / "drag.athinput"
    deck.write_text(deck_text(DRAG)
                    + "\n<output9>\nfile_type = rst\ndcycle = 3\n")
    cwd = os.getcwd()
    try:
        _, _, _, s1 = torch_main.cli(["-i", str(deck), "-d",
                                      str(tmp_path / "straight"),
                                      "time/nlim=6"])
        os.chdir(cwd)
        torch_main.cli(["-i", str(deck), "-d", str(tmp_path / "first"),
                        "time/nlim=3"])
        os.chdir(cwd)
        rst = str(tmp_path / "first" / "indrag.00001.rst")
        from athenak_tpu_torch.outputs import load_restart
        stored = load_restart(rst)[4]
        assert {"ui", "wi", "ru"} <= set(stored)
        assert np.abs(stored["ru"]).max() > 0.0
        m2, _, _, s2 = torch_main.cli(["-r", rst, "-d",
                                       str(tmp_path / "first"),
                                       "time/nlim=6"])
    finally:
        os.chdir(cwd)
    assert m2.ncycle == 6
    for k in ("u", "w", "ui", "wi", "ru"):
        assert torch.equal(s1[k], s2[k]), k
    for c in s1["bfc"]:
        assert torch.equal(s1["bfc"][c], s2["bfc"][c]), c
