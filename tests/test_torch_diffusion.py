"""Viscosity, conduction and Ohmic and ambipolar resistivity
(``athenak_tpu_torch/diffusion.py``), the inflow boundary, the kernel
gates the diffusion modules and self-gravity close, against the JAX
package, float64 on the CPU.

  * Every operator on random states, 3-D and 2-D, on one level and on a
    statically refined mesh (per-block cell sizes): the viscous, heat
    and resistive fluxes, the resistive EMFs and each module's
    ``new_dt``, to 1e-12 of their scale.
  * Three cycles of the shipped diffusion decks (``inputs/hydro/
    viscosity``, ``inputs/mhd/resistivity``), of the conductive and the
    ambipolar decay problems, of ``inputs/hydro/shock_cloud`` at
    32 x 16 x 16 (the inflow ghosts held at the generator's state) and
    of the 3-D blast at 16^3 with viscosity, Ohmic resistivity and
    conduction, on the general path and on kernel J's route (its plain
    version; the JAX package's own J route leaves the diffusive fluxes
    out, ROADMAP F16, so both are held against its general path), and
    with ambipolar diffusion moved by 0.3 of a cell (the blast at rest
    centred on cell faces meets ROADMAP F4 there): the initial
    state to 1e-12, the cycles to 1e-10.
  * The gates: each of viscosity, conduction, resistivity and
    self-gravity closes kernels A, C, E and F on a 3-D single-level
    float32 deck; resistivity closes D and the others leave it open; J
    stays open; the JAX package's gate functions agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu import main as jax_main  # noqa: E402
from athenak_tpu.bvals import BoundaryValues as JaxBV  # noqa: E402
from athenak_tpu.mesh import Mesh as JaxMesh  # noqa: E402
from athenak_tpu_torch import main as torch_main  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.bvals import BoundaryValues  # noqa: E402
from athenak_tpu_torch.mesh import Mesh  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (JAX_EXTRA, DeckPair, JaxInput,  # noqa: E402
                               assert_close, check_pair, deck_text,
                               port_run, assert_states_close)

BLAST = "inputs/mhd/blast.athinput"
BLAST_SMR = "inputs/mhd/blast_smr.athinput"
OT = "inputs/mhd/orszag_tang.athinput"
COEFS = ["mhd/nu_iso=0.01", "mhd/alpha_iso=0.02", "mhd/eta_ohm=0.03",
         "mhd/eta_ad=0.04"]
OPS_DECKS = {
    "3d": (BLAST, ["job/precision=double", "mesh/nx1=8", "mesh/nx2=8",
                   "mesh/nx3=8", "meshblock/nx1=8", "meshblock/nx2=8",
                   "meshblock/nx3=4"]),
    "2d": (OT, ["mesh/nx1=16", "mesh/nx2=8", "meshblock/nx1=8",
                "meshblock/nx2=8"]),
    "smr": (BLAST_SMR, ["job/precision=double", "mesh/nx1=16",
                        "mesh/nx2=16", "mesh/nx3=16", "meshblock/nx1=8",
                        "meshblock/nx2=8", "meshblock/nx3=8"]),
}
NCYC = 3


def _physics(deck, extra):
    """(JAX physics, port physics) of one deck with every diffusion
    coefficient set."""
    text = deck_text(deck)
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + extra + COEFS)
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(extra + COEFS)
    jm = JaxMesh(pj)
    jp = jax_main.make_physics(pj, jm, JaxBV(jm))
    tm = Mesh(pt)
    tp = torch_main.make_physics(pt, tm, BoundaryValues(tm), "cpu",
                                 torch.float64)
    return jp, tp


def _random(shape, rng, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, size=shape)


@pytest.fixture(scope="module", params=sorted(OPS_DECKS))
def ops(request):
    """The two packages' physics and a random state of one deck."""
    deck, extra = OPS_DECKS[request.param]
    jp, tp = _physics(deck, extra)
    rng = np.random.default_rng(16)
    mbi = tp.mesh.mb_indcs
    shape = (tp.mesh.nmb_total, tp.nvar, mbi.ncells3, mbi.ncells2,
             mbi.ncells1)
    w = _random(shape, rng)
    w[:, 0] = rng.uniform(0.5, 2.0, size=shape[:1] + shape[2:])
    w[:, 4] = rng.uniform(0.5, 2.0, size=shape[:1] + shape[2:])
    bfc = {k: _random(s, rng) for k, s in tp.fc_shapes.items()}
    bcc = _random((shape[0], 3) + shape[2:], rng)
    flx = {d[0]: _random(shape, rng) for d in tp.dirs}
    emf = [_random((shape[0],) + shape[2:], rng) for _ in range(3)]
    return request.param, jp, tp, dict(w=w, bfc=bfc, bcc=bcc, flx=flx,
                                       emf=emf)


def _t(a):
    return {k: _t(v) for k, v in a.items()} if isinstance(a, dict) \
        else [_t(v) for v in a] if isinstance(a, list) \
        else torch.as_tensor(a)


def _j(a):
    return {k: _j(v) for k, v in a.items()} if isinstance(a, dict) \
        else [_j(v) for v in a] if isinstance(a, list) \
        else jnp.asarray(a)


def _close_dicts(got, ref, tol, label):
    for k in ref:
        assert_close(np.asarray(got[k]), np.asarray(ref[k]), tol,
                     f"{label} {k}")


def test_viscous_flux(ops):
    name, jp, tp, s = ops
    got = tp.pvisc.add_viscous_flux(_t(s["w"]), _t(s["flx"]), tp.dirs)
    ref = jp.pvisc.add_viscous_flux(_j(s["w"]), _j(s["flx"]), jp.dirs)
    _close_dicts(got, ref, 1e-12, f"{name} viscous")


def test_heat_flux(ops):
    name, jp, tp, s = ops
    got = tp.pcond.add_heat_flux(_t(s["w"]), _t(s["flx"]), tp.dirs)
    ref = jp.pcond.add_heat_flux(_j(s["w"]), _j(s["flx"]), jp.dirs)
    _close_dicts(got, ref, 1e-12, f"{name} heat")


def test_resistive_flux(ops):
    name, jp, tp, s = ops
    nd = len(tp.dirs)
    got = tp.presist.add_resistive_flux(_t(s["bfc"]), _t(s["bcc"]),
                                        _t(s["flx"]), tp.dirs, nd)
    ref = jp.presist.add_resistive_flux(_j(s["bfc"]), _j(s["bcc"]),
                                        _j(s["flx"]), jp.dirs, nd)
    _close_dicts(got, ref, 1e-12, f"{name} resistive flux")


def test_resistive_emf(ops):
    name, jp, tp, s = ops
    nd = len(tp.dirs)
    got = tp.presist.add_resistive_emf(_t(s["bfc"]), _t(s["bcc"]),
                                       *_t(s["emf"]), nd)
    ref = jp.presist.add_resistive_emf(_j(s["bfc"]), _j(s["bcc"]),
                                       *_j(s["emf"]), nd)
    for c, (g, r) in enumerate(zip(got, ref)):
        assert_close(np.asarray(g), np.asarray(r), 1e-12, f"{name} e{c + 1}")


def test_new_dt(ops):
    name, jp, tp, s = ops
    nd = len(tp.dirs)
    like = torch.zeros((), dtype=torch.float64)
    for got, ref in (
            (tp.pvisc.new_dt(nd, like), jp.pvisc.new_dt(nd, jnp.float64)),
            (tp.pcond.new_dt(nd, like), jp.pcond.new_dt(nd, jnp.float64)),
            (tp.presist.new_dt(_t(s["bcc"]), nd, like),
             jp.presist.new_dt(_j(s["bcc"]), nd, jnp.float64))):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-14)


# ---------------------------------------------------------------------------
# decks
# ---------------------------------------------------------------------------
VISC = "inputs/hydro/viscosity.athinput"
RESIST = "inputs/mhd/resistivity.athinput"
SHOCK = "inputs/hydro/shock_cloud.athinput"
DECKS = {
    "viscosity": (VISC, []),
    "resistivity": (RESIST, []),
    "conduction": (VISC, ["problem/perturb=temp", "hydro/alpha_iso=0.02"]),
    "ambipolar": (RESIST, ["problem/perturb=bz_pb", "problem/b0=0.1",
                           "mhd/eta_ad=2.0"]),
    "shock_cloud": (SHOCK, ["mesh/nx1=32", "mesh/nx2=16", "mesh/nx3=16"]),
}
SHIFT = ["mesh/x1min=-0.9625", "mesh/x1max=1.0375", "mesh/x2min=-0.9625",
         "mesh/x2max=1.0375", "mesh/x3min=-0.9625", "mesh/x3max=1.0375"]
DBLAST = ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16",
          "mesh/nx3=16", "meshblock/nx1=16", "meshblock/nx2=16",
          "meshblock/nx3=16", "mhd/nu_iso=1e-3", "mhd/eta_ohm=1e-3",
          "mhd/alpha_iso=1e-3"]
DBLAST_AD = ["job/precision=double", "mesh/nx1=16", "mesh/nx2=16",
             "mesh/nx3=16", "meshblock/nx1=16", "meshblock/nx2=16",
             "meshblock/nx3=16", "mhd/nu_iso=1e-3", "mhd/eta_ad=1e-3",
             "mhd/alpha_iso=1e-3"] + SHIFT


@pytest.mark.parametrize("name", sorted(DECKS))
def test_deck_three_cycles(name, tmp_path):
    deck, extra = DECKS[name]
    pair = check_pair(DeckPair(deck_text(deck), extra, ncyc=NCYC,
                               rundir=str(tmp_path)))
    if name == "shock_cloud":
        # the inner-x1 ghosts hold the post-shock inflow state
        st = pair.state["u"]
        uin = pair.phys.bvals.inflow_state["x1m"].numpy()
        ng = pair.mesh.mb_indcs.ng
        assert np.array_equal(st[0, :, ng:-ng, ng:-ng, :ng],
                              np.broadcast_to(uin[:, None, None, None],
                                              st[0, :, ng:-ng, ng:-ng,
                                                 :ng].shape))
        assert np.allclose(uin, pair.jax_phys.bvals.inflow_state["x1m"],
                           rtol=1e-15)


@pytest.fixture(scope="module")
def dblast(tmp_path_factory):
    return DeckPair(deck_text(BLAST), DBLAST, ncyc=NCYC,
                    rundir=str(tmp_path_factory.mktemp("dblast")))


def test_diffusive_blast_general_path(dblast):
    check_pair(dblast)
    phys = dblast.phys
    assert phys.pvisc and phys.presist and phys.pcond
    assert not (phys.use_mega_v2 or phys.use_mega_stage
                or phys.use_fused_stage or phys.use_fused_ct)


def test_diffusive_blast_flux_kernel_route(dblast, tmp_path, monkeypatch):
    """The J route's plain version (``fused_flux_dir`` on CPU tensors)
    with the diffusive fluxes added after it, against the JAX package's
    general path: J's face floors do not fire on the blast."""
    from athenak_tpu_torch.ops import flux
    from athenak_tpu_torch.physics import mhd as pm
    calls = []
    orig = flux.fused_flux_dir

    def counted(*a, **k):
        calls.append(a[3])
        return orig(*a, **k)

    monkeypatch.setattr(pm, "kernel_dtype_ok", lambda t: True)
    monkeypatch.setattr(flux, "fused_flux_dir", counted)
    mesh, phys, _, st = port_run(deck_text(BLAST), DBLAST, ncyc=NCYC,
                                 rundir=str(tmp_path))
    assert phys.use_flux_dir and len(calls) == 3 * 2 * NCYC
    assert_states_close(st, dblast.jax_state, 1e-10)


def test_ambipolar_blast(tmp_path):
    check_pair(DeckPair(deck_text(BLAST), DBLAST_AD, ncyc=NCYC,
                        rundir=str(tmp_path)))


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------
GATE_DECK = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]   # f32, 1 block
MODULES = {"pvisc": ["mhd/nu_iso=1e-3"], "pcond": ["mhd/alpha_iso=1e-3"],
           "presist": ["mhd/eta_ohm=1e-3"],
           "pgrav": ["gravity/four_pi_G=1.0"]}


@pytest.fixture(scope="module")
def gated():
    """The port's and the JAX package's MHD physics of the f32 blast with
    each module (and with none)."""
    out = {}
    for mod, extra in [("none", [])] + sorted(MODULES.items()):
        text = deck_text(BLAST)
        pt = ParameterInput.from_string(text)
        pt.modify_from_cmdline(GATE_DECK + extra)
        tm = Mesh(pt)
        tp = torch_main.make_physics(pt, tm, BoundaryValues(tm), "cpu",
                                     torch.float32)
        pj = JaxInput.from_string(text)
        pj.modify_from_cmdline(JAX_EXTRA + GATE_DECK + extra)
        jm = JaxMesh(pj)
        jp = jax_main.make_physics(pj, jm, JaxBV(jm))
        out[mod] = (tp, tm, jp, jm)
    return out


def test_gates_open_without_the_modules(gated):
    tp = gated["none"][0]
    assert tp.use_mega_v2 and tp.use_fused_ct
    assert tp.pvisc is None and tp.pgrav is None


@pytest.mark.parametrize("gate", ["A", "C", "E", "F"])
@pytest.mark.parametrize("mod", sorted(MODULES))
def test_module_closes_stage_kernels(gated, mod, gate):
    """Kernel A (``supports_mega_v2``), C (``supports_fused_stage``), E and
    F (``supports_mega_stage``: F runs on E's route only) close with the
    module, as the JAX package's gates (``pallas_stage.py:176-182,
    564-573``) do."""
    from athenak_tpu.ops import pallas_stage as jps
    from athenak_tpu_torch.ops import stage, stage_split
    tp, tm, jp, jm = gated[mod]
    assert getattr(tp, mod) is not None
    port, jax_gate = {
        "A": (stage.supports_mega_v2, jps.supports_mega_v2),
        "C": (stage_split.supports_fused_stage, jps.supports_fused_stage),
        "E": (stage.supports_mega_stage, jps.supports_mega_stage),
        "F": (stage.supports_mega_stage, jps.supports_mega_stage)}[gate]
    assert not port(tp, tm)
    assert not jax_gate(jp, jm)
    flag = {"A": "use_mega_v2", "C": "use_fused_stage",
            "E": "use_mega_stage", "F": "use_mega_stage"}[gate]
    assert not getattr(tp, flag)


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_kernel_d_gate(gated, mod):
    """Resistivity closes D (its corner EMFs have no resistive part); the
    other three leave it open, as the JAX ``supports_fused_ct``."""
    from athenak_tpu.ops import pallas_stage as jps
    from athenak_tpu_torch.ops import stage_split
    tp, tm, jp, jm = gated[mod]
    want = mod != "presist"
    assert stage_split.supports_fused_ct(tp, tm) == want
    assert jps.supports_fused_ct(jp, jm) == want
    assert tp.use_fused_ct == want


@pytest.mark.parametrize("mod", sorted(MODULES))
def test_kernel_j_stays_open(gated, mod):
    """J's gate reads the solver physics alone: with A, C and E closed the
    general path forms its fluxes with J."""
    from athenak_tpu_torch.ops import flux
    tp = gated[mod][0]
    assert flux.supports_flux_dir(tp) and tp.use_flux_dir


def test_fft_gravity_with_refinement_raises():
    pt = ParameterInput.from_string(deck_text(BLAST_SMR))
    pt.modify_from_cmdline(["gravity/four_pi_G=1.0", "gravity/solver=fft"])
    tm = Mesh(pt)
    with pytest.raises(NotImplementedError, match="fft"):
        torch_main.make_physics(pt, tm, BoundaryValues(tm), "cpu",
                                torch.float64)


def test_spitzer_conduction_raises():
    pt = ParameterInput.from_string(deck_text(VISC))
    pt.modify_from_cmdline(["hydro/alpha_spitzer=true"])
    tm = Mesh(pt)
    with pytest.raises(NotImplementedError, match="Spitzer"):
        torch_main.make_physics(pt, tm, BoundaryValues(tm), "cpu",
                                torch.float64)
