"""The SR MHD slice as a whole: the SR blast through both packages.

The deck is the ``sr`` case of ``bench.py`` (``SR_DECK``: PLM, SR HLLE,
RK2, gamma 4/3, blast with prat 5 and b_amb 0.1) cut to 16^3 in float64.
The JAX side runs eagerly (``jax.disable_jit``), as in
``test_torch_mhd_slice.py``: the blast starts at rest and
mirror-symmetric, and eager JAX rounds operation by operation as torch
does.  State and dt agree to 1e-10 of the field maximum after
initialisation and after each of 3 cycles; on the CPU the port runs its
general path and launches no kernel.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.ops.rsolvers_srmhd import (  # noqa: E402
    SR_MHD_RSOLVER_FNS)
from athenak_tpu_torch.state import state_to_numpy  # noqa: E402

NX = 16
INT = (slice(None), slice(None), slice(2, -2), slice(2, -2), slice(2, -2))
INTF = INT[1:]
DECK = f"""
<job>
basename = srblast
precision = double
<mesh>
nghost = 2
nx1 = {NX}
x1min = -1.0
x1max = 1.0
nx2 = {NX}
x2min = -1.0
x2max = 1.0
nx3 = {NX}
x3min = -1.0
x3max = 1.0
<coord>
special_rel = true
<time>
evolution = dynamic
integrator = rk2
cfl_number = 0.25
tlim = 10.0
<mhd>
eos = ideal
gamma = 1.3333333333333333
reconstruct = plm
rsolver = hlle
<problem>
pgen_name = blast
inner_radius = 0.1
outer_radius = 0.25
prat = 5.0
b_amb = 0.1
"""


def _decks(rsolver="hlle", extra=()):
    text = DECK.replace("rsolver = hlle", f"rsolver = {rsolver}")
    pins = []
    for cls in (JaxInput, ParameterInput):
        pin = cls.from_string(text)
        pin.modify_from_cmdline(list(extra))
        pins.append(pin)
    return pins


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


def test_sr_build_initialize_parity():
    """The SR blast goes through the SR p2c: the initial conserved state
    and the first dt agree with the JAX package's."""
    pj, pt = _decks()
    mj, phj, _, dj, sj = jax_main.build(pj)
    mt, pht, _, dt_, st = torch_main.build(pt, device="cpu")
    assert pht.is_sr and phj.is_sr
    assert pht._solve is SR_MHD_RSOLVER_FNS["hlle"]
    assert pht.stage_solver == "sr_hlle"
    assert pht.use_fused_stage and pht.use_fused_ct and not pht.use_mega_v2
    _assert_state_close(sj, state_to_numpy(st), 1e-12, interior=False)
    with jax.disable_jit():
        sj = dj.initialize(sj)
    st = dt_.initialize(st)
    _assert_state_close(sj, state_to_numpy(st), 1e-12, interior=False)
    np.testing.assert_allclose(mt.dt, mj.dt, rtol=1e-12)


@pytest.mark.parametrize("rsolver", ["hlle", "llf"])
def test_sr_three_cycles_parity(rsolver):
    pj, pt = _decks(rsolver)
    mj, _, _, dj, sj = jax_main.build(pj)
    mt, pht, _, dt_, st = torch_main.build(pt, device="cpu")
    assert pht._solve is SR_MHD_RSOLVER_FNS[rsolver]
    with jax.disable_jit():
        sj = dj.initialize(sj)
    st = dt_.initialize(st)
    cyc_j, cyc_t = dj.make_cycle_fn(), dt_.make_cycle_fn()
    dt = mj.dt
    for _ in range(3):
        with jax.disable_jit():
            sj, dn_j, cj = cyc_j(sj, jnp.asarray(dt))
        st, dn_t, ct = cyc_t(st, dt)
        _assert_state_close(sj, state_to_numpy(st), 1e-10)
        np.testing.assert_allclose(float(dn_t), float(dn_j), rtol=1e-10)
        assert set(ct) == {"neos_dfloor", "neos_efloor", "nc2p_fail"}
        assert {k: int(v) for k, v in ct.items()} == \
            {k: int(v) for k, v in cj.items()}
        dt = 0.25 * float(dn_j)
    assert all(k.launches == 0 for k in kernels.ALL)


def test_sr_run_counts_c2p_failures(monkeypatch, tmp_path):
    """run() through the driver: the SR counters, nc2p_fail among them,
    are summed over the cycles."""
    monkeypatch.chdir(tmp_path)
    _, pt = _decks(extra=["time/nlim=2"])
    mesh, phys, driver, state = torch_main.run(pt, device="cpu")
    assert mesh.ncycle == 2
    assert set(driver.ecounters) == {"neos_dfloor", "neos_efloor",
                                     "nc2p_fail"}
    assert driver.ecounters["nc2p_fail"] == 0
    assert bool(torch.isfinite(state["u"]).all())
