"""The port's SR hydro against the JAX package, in float64 on the CPU.

  * ``ops/eos_sr.py``: the SR hydro p2c and the SR sound speeds to 1e-12
    of each field's scale on random states; the c2p (the Illinois root
    find on z = gamma v) of states made by p2c, with and without floors
    and failures firing, to 1e-12, the floored conserved state and the
    counters ``neos_dfloor``, ``neos_efloor`` and ``nc2p_fail`` equal;
  * ``ops/rsolvers_sr.py``: LLF, HLLE and HLLC in each direction, with a
    passive scalar riding along, to 1e-13;
  * three cycles of ``inputs/srhydro/mb1`` (at its shipped 256 cells),
    ``kh_srhyd1`` and ``blast_srhyd`` (at 16^2) through the port's
    ``main.run`` and the JAX package's jitted stage
    (``torch_deck_parity.DeckPair``) to 1e-10, the EOS counters equal;
    the SR hydro decks ``mb2``-``mb4`` through the port's CLI.

The JAX side of the ops runs eagerly, operation by operation.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from athenak_tpu.ops import eos_sr as jsr  # noqa: E402
from athenak_tpu.ops import rsolvers_sr as jrs  # noqa: E402
from athenak_tpu.ops.eos import EOSData as JEOS  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.ops import eos_sr as tsr  # noqa: E402
from athenak_tpu_torch.ops import rsolvers_sr as trs  # noqa: E402
from athenak_tpu_torch.ops.eos import EOSData as TEOS  # noqa: E402
from athenak_tpu_torch.state import state_from_numpy  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (ROOT, DeckPair, check_pair,  # noqa: E402
                               deck_text)

SHAPE = (2, 6, 5, 7)   # [nmb, n3, n2, n1]
GAMMA = 4.0 / 3.0


def _prims(rng, nvar=5, umax=2.0):
    """Random SR primitives (rho, u^i, e) and scalars."""
    chans = [rng.uniform(0.5, 1.5, SHAPE)]
    chans += [rng.uniform(-umax, umax, SHAPE) for _ in range(3)]
    chans += [rng.uniform(0.05, 2.0, SHAPE)]
    chans += [rng.uniform(0.0, 1.0, SHAPE) for _ in range(nvar - 5)]
    return np.stack(chans, axis=1)


def _rel(got, ref):
    """max |got - ref| over each field's max |ref| (channel axis 1)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max(axis=(-3, -2, -1), keepdims=True)
    return float((np.abs(got - ref) / np.maximum(scale, 1e-300)).max())


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("seed", [0, 1])
def test_prim_to_cons_and_sound_speeds(seed):
    w = _prims(np.random.default_rng(seed), nvar=6)
    jeos, teos = JEOS(gamma=GAMMA), TEOS(gamma=GAMMA)
    ref = jsr.prim_to_cons_sr_hydro(jnp.asarray(w), jeos)
    assert _rel(tsr.prim_to_cons_sr_hydro(_t(w), teos).numpy(), ref) <= 1e-12
    lor = np.sqrt(1.0 + (w[:, 1:4] ** 2).sum(axis=1))
    p = (GAMMA - 1.0) * w[:, 4]
    for c in (1, 2, 3):
        jl = jsr.sr_hydro_sound_speeds(jeos, jnp.asarray(w[:, 0]),
                                       jnp.asarray(p), jnp.asarray(w[:, c]),
                                       jnp.asarray(lor))
        tl = tsr.sr_hydro_sound_speeds(teos, _t(w[:, 0]), _t(p),
                                       _t(w[:, c]), _t(lor))
        for a, r in zip(tl, jl):
            assert _rel(a.numpy()[:, None], np.asarray(r)[:, None]) <= 1e-12


@pytest.mark.parametrize("case", ["plain", "floors", "failures"])
def test_cons_to_prim(case):
    """The c2p on states made by p2c (a round trip to the primitives),
    and with density, energy floors and root-find failures firing: the
    primitives, the floored conserved state and every counter agree."""
    rng = np.random.default_rng({"plain": 3, "floors": 4, "failures": 5}
                                [case])
    w = _prims(rng, nvar=6)
    eos_kw = {"gamma": GAMMA}
    u = np.array(jsr.prim_to_cons_sr_hydro(jnp.asarray(w), JEOS(**eos_kw)))
    if case == "floors":
        eos_kw.update(dfloor=0.8, pfloor=0.3)
        u[:, 4, 0] = -0.5                          # tau below its floor
    elif case == "failures":
        # momenta far beyond what the energy allows: no root in the
        # bracket within the iteration budget for some cells
        u[:, 1:4, 1] *= 1e6
    wj, uj, cj = jsr.cons_to_prim_sr_hydro(jnp.asarray(u), JEOS(**eos_kw))
    wt, ut, ct = tsr.cons_to_prim_sr_hydro(_t(u), TEOS(**eos_kw))
    assert _rel(wt.numpy(), wj) <= 1e-12
    assert _rel(ut.numpy(), uj) <= 1e-12
    assert {k: int(v) for k, v in ct.items()} == \
        {k: int(v) for k, v in cj.items()}
    if case == "plain":
        assert _rel(wt.numpy(), w) <= 1e-12
        assert all(int(v) == 0 for v in ct.values())
    else:
        assert sum(int(v) for v in ct.values()) > 0


@pytest.mark.parametrize("ivx", [1, 2, 3])
@pytest.mark.parametrize("solver", ["llf", "hlle", "hllc"])
def test_solver_matches_jax(solver, ivx):
    rng = np.random.default_rng(10 + ivx)
    wl, wr = _prims(rng, nvar=6), _prims(rng, nvar=6)
    wr[:, :, 1::2] = wl[:, :, 1::2]               # some faces at rest
    ref = jrs.SR_HYDRO_RSOLVER_FNS[solver](jnp.asarray(wl), jnp.asarray(wr),
                                           JEOS(gamma=GAMMA), ivx)
    got = trs.SR_HYDRO_RSOLVER_FNS[solver](_t(wl), _t(wr), TEOS(gamma=GAMMA),
                                           ivx)
    assert _rel(got.numpy(), ref) <= 1e-13
    assert set(trs.SR_HYDRO_RSOLVER_FNS) == set(jrs.SR_HYDRO_RSOLVER_FNS)


# ------------------------------------------------------------------ decks
DECKS = {
    "mb1": ("inputs/srhydro/mb1.athinput", []),
    "kh_srhyd1": ("inputs/srhydro/kh_srhyd1.athinput",
                  ["mesh/nx1=16", "mesh/nx2=16"]),
    "blast_srhyd": ("inputs/srhydro/blast_srhyd.athinput",
                    ["mesh/nx1=16", "mesh/nx2=16"]),
}
_PAIRS = {}


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    return tmp_path_factory.mktemp("sr_hydro")


def pair(name, rundir):
    if name not in _PAIRS:
        path, extra = DECKS[name]
        _PAIRS[name] = DeckPair(deck_text(path), extra,
                                rundir=str(rundir / name))
    return _PAIRS[name]


@pytest.mark.parametrize("name", sorted(DECKS))
def test_deck_matches_jax(name, rundir):
    p = check_pair(pair(name, rundir))
    assert p.phys.is_sr and not p.phys.is_mhd and p.phys.nvar == 5
    assert p.phys.rsolver == "hllc"
    # the flow moved, the EOS counters are JAX's, and nothing launched
    assert np.abs(p.state["u"] - p.port_ready["u"]).max() > 0.0
    assert set(p.driver.ecounters) == {"neos_dfloor", "neos_efloor",
                                       "nc2p_fail"}
    assert all(k.launches == 0 for k in kernels.ALL)


def test_counters_match_jax(rundir):
    """The EOS counters of a cycle on the blast: the JAX stage's and the
    port's stage's, from the same state."""
    p = pair("blast_srhyd", rundir)
    jst, jphys = p.jax_ready, p.jax_phys
    _, jc = jax.jit(lambda s: jphys.stage_update(
        s, jphys.save_state(s), 0.0, 1.0, 1e-3))(
        jax.tree_util.tree_map(jnp.asarray, jst))
    st = state_from_numpy(jst, "cpu", torch.float64)
    _, tc = p.phys.stage_update(st, p.phys.save_state(st), 0.0, 1.0, 1e-3)
    assert {k: int(v) for k, v in tc.items()} == \
        {k: int(v) for k, v in jc.items()}


@pytest.mark.parametrize("deck", ["mb2", "mb3", "mb4"])
def test_sr_shock_tubes_run(deck, tmp_path, monkeypatch):
    """The other SR shock tubes through the port's CLI (5 cycles)."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    monkeypatch.chdir(tmp_path)
    mesh, phys, driver, st = torch_main.cli([
        "-i", os.path.join(ROOT, "inputs", "srhydro", f"{deck}.athinput"),
        "time/nlim=5"])
    assert phys.is_sr and mesh.ncycle == 5
    assert bool(torch.isfinite(st["u"]).all())
    assert driver.ecounters["nc2p_fail"] == 0
