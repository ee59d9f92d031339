"""The Newtonian MHD test-problem tail through both packages.

  * Ops, float64, seeded random states, to 1e-12 of each output's
    scale: the MHD Riemann solvers LLF, HLLE, HLLD and advection for the
    ideal and the isothermal gas in each direction (a passive scalar's
    flux slot left zero by both; isothermal HLLD is HLLE in both), and
    the isothermal and passive-scalar c2p/p2c with the floors firing,
    counters equal.
  * Gates: for each new combination of physics (isothermal, scalars,
    LLF/HLLE/advect, DC and the PPM/WENO family, 1-D and 2-D, SR) the
    port's kernel D gate equals the JAX package's
    ``use_pallas and supports_fused_ct`` (built with
    ``mhd/use_pallas=true`` in float32 mode, so that JAX evaluates its
    TPU gate), and the port's stage-kernel flags (A, C, E, J) stay off
    outside the ideal Newtonian PLM+HLLD decks.
  * Decks, three cycles through the port's ``main.run`` against the JAX
    package's jitted stage (``torch_deck_parity.DeckPair``) at 1e-10 of
    each field's scale: ``bw``, ``mub1`` (SR, held against JAX's jnp
    path), ``linear_wave_mhd`` (ideal, isothermal, one scalar),
    ``cpaw3d``, ``field_loop3d``, ``current_sheet`` and
    ``kh2d-lecoanet-mhd``, the 3-D ones at 16x8x8 and the 2-D ones at
    32x16 or 32^2; the wave tests' error files as JAX writes them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from athenak_tpu.ops import eos as jeos  # noqa: E402
from athenak_tpu.ops import rsolvers_mhd as jrs  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch.ops import eos as teos  # noqa: E402
from athenak_tpu_torch.ops import rsolvers_mhd as trs  # noqa: E402
from test_torch_hydro_ops import SHAPE, close, eos_pair, prims  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (DeckPair, check_pair,  # noqa: E402
                               deck_text)


def _fields(rng):
    bl = rng.uniform(-1.0, 1.0, (SHAPE[0], 3) + SHAPE[1:])
    br = rng.uniform(-1.0, 1.0, bl.shape)
    bx = rng.uniform(-1.0, 1.0, (SHAPE[0],) + SHAPE[1:])
    bx[:, :2] = 0.0                               # the degenerate branch
    return bl, br, bx


@pytest.mark.parametrize("ivx", [1, 2, 3])
@pytest.mark.parametrize("ideal", [True, False], ids=["ideal", "isothermal"])
@pytest.mark.parametrize("solver", ["llf", "hlle", "hlld", "advect"])
def test_mhd_solver_matches_jax(solver, ideal, ivx):
    rng = np.random.default_rng(31 + ivx)
    wl, wr = prims(rng, ideal), prims(rng, ideal)
    bl, br, bx = _fields(rng)
    je, te = eos_pair(ideal)
    outj = jrs.MHD_RSOLVER_FNS[solver](*map(jnp.asarray, (wl, wr, bl, br,
                                                          bx)), je, ivx)
    outt = trs.MHD_RSOLVER_FNS[solver](*map(torch.from_numpy, (
        wl, wr, bl, br, bx)), te, ivx)
    for name, a, b in zip(("flux", "ey", "ez"), outt, outj):
        close(a, b, f"{solver} {name}")
    assert not outt[0][:, -1].any()
    assert set(trs.MHD_RSOLVER_FNS) == set(jrs.MHD_RSOLVER_FNS)


@pytest.mark.parametrize("ideal", [True, False], ids=["ideal", "isothermal"])
def test_mhd_c2p_p2c_scalars_match_jax(ideal):
    rng = np.random.default_rng(41)
    w = prims(rng, ideal, nscalars=2)
    bcc = rng.uniform(-1.0, 1.0, (SHAPE[0], 3) + SHAPE[1:])
    je, te = eos_pair(ideal, dfloor=0.5, pfloor=0.3, tfloor=0.2)
    uj = jeos.prim_to_cons_mhd(jnp.asarray(w), jnp.asarray(bcc), je)
    ut = teos.prim_to_cons_mhd(torch.from_numpy(w), torch.from_numpy(bcc),
                               te)
    close(ut, uj, "p2c")
    u = np.array(uj)
    if ideal:
        u[:, 4] -= rng.uniform(0.0, 0.6, u[:, 4].shape)
    u[:, -1] -= 0.4
    wj, ufj, cj = jeos.cons_to_prim_mhd(jnp.asarray(u), jnp.asarray(bcc), je)
    wt, uft, ct = teos.cons_to_prim_mhd(torch.from_numpy(u),
                                        torch.from_numpy(bcc), te)
    close(wt, wj, "c2p w")
    close(uft, ufj, "c2p u_fixed")
    assert set(ct) == set(cj)
    for k in cj:
        assert int(ct[k]) == int(cj[k]) > 0, k


# ------------------------------------------------------------------ gates
_GATE_DECK = "inputs/tests/linear_wave_mhd.athinput"
_SMALL = ["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8"]
GATE_CASES = {
    "plm hlld": [],
    "isothermal": ["mhd/eos=isothermal"],
    "scalar": ["mhd/nscalars=1"],
    "llf": ["mhd/rsolver=llf"],
    "hlle": ["mhd/rsolver=hlle"],
    "advect": ["mhd/rsolver=advect"],
    "dc": ["mhd/reconstruct=dc"],
    "ppm4": ["mhd/reconstruct=ppm4", "mesh/nghost=3"],
    "wenoz": ["mhd/reconstruct=wenoz", "mesh/nghost=3"],
    "2d": ["mesh/nx3=1"],
    "sr hlle": ["coord/special_rel=true", "mhd/rsolver=hlle"],
    "sr llf": ["coord/special_rel=true", "mhd/rsolver=llf"],
    "sr hlld": ["coord/special_rel=true", "mhd/rsolver=hlld"],
}


def _jax_gate(extra):
    """The JAX package's MHD flags with its Pallas gate evaluated: the
    TPU route forced on and x64 off while the object is built."""
    from athenak_tpu.athinput import ParameterInput as JaxInput
    from athenak_tpu.bvals import BoundaryValues as JaxBvals
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu.physics.mhd import MHD as JaxMHD
    pin = JaxInput.from_string(deck_text(_GATE_DECK))
    pin.modify_from_cmdline(_SMALL + extra + ["mhd/use_pallas=true"])
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        mesh = JaxMesh(pin)
        return JaxMHD(pin, mesh, JaxBvals(mesh))
    finally:
        jax.config.update("jax_enable_x64", x64)


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_kernel_gates_follow_jax(case):
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    from athenak_tpu_torch.physics.mhd import MHD
    extra = GATE_CASES[case]
    if case == "sr hlld":
        with pytest.raises(ValueError):
            _jax_gate(extra)
    jp = None if case == "sr hlld" else _jax_gate(extra)
    pin = ParameterInput.from_string(deck_text(_GATE_DECK))
    pin.modify_from_cmdline(_SMALL + extra)
    mesh = Mesh(pin)
    if case == "sr hlld":
        with pytest.raises(ValueError):
            MHD(pin, mesh, BoundaryValues(mesh), "cpu", torch.float32)
        return
    tp = MHD(pin, mesh, BoundaryValues(mesh), "cpu", torch.float32)
    assert tp.use_fused_ct == jp.use_fused_ct, case
    admitted = case in ("plm hlld", "sr hlle", "sr llf")
    assert tp.use_fused_ct == (admitted and case != "2d")
    newtonian_3d = case == "plm hlld"
    assert tp.use_mega_v2 == newtonian_3d
    assert tp.use_fused_stage == (case in ("sr hlle", "sr llf"))
    assert not tp.use_mega_stage
    assert tp.use_flux_dir == (case == "2d")
    assert tp.nvar == {"isothermal": 4, "scalar": 6}.get(case, 5)


# ------------------------------------------------------------------ decks
CUT3 = ["mesh/nx1=16", "mesh/nx2=8", "mesh/nx3=8"]
DECKS = {
    "bw": ("inputs/mhd/bw.athinput", []),
    "mub1": ("inputs/srmhd/mub1.athinput", ["mesh/nx1=128"]),
    "linear_wave_mhd": (_GATE_DECK, CUT3),
    "linear_wave_mhd isothermal": (_GATE_DECK, CUT3 + ["mhd/eos=isothermal"]),
    "linear_wave_mhd scalar": (_GATE_DECK, CUT3 + ["mhd/nscalars=1"]),
    "cpaw3d": ("inputs/tests/cpaw3d.athinput", CUT3),
    "field_loop3d": ("inputs/mhd/field_loop3d.athinput", CUT3),
    "current_sheet": ("inputs/mhd/current_sheet.athinput",
                      ["mesh/nx1=32", "mesh/nx2=16"]),
    "kh2d-lecoanet-mhd": ("inputs/mhd/kh2d-lecoanet-mhd.athinput",
                          ["mesh/nx1=32", "mesh/nx2=32"]),
}
ERRS = {"linear_wave_mhd": "linear_wave_mhd-errs.dat",
        "linear_wave_mhd isothermal": "linear_wave_mhd-errs.dat",
        "linear_wave_mhd scalar": "linear_wave_mhd-errs.dat",
        "cpaw3d": "cpaw3d-errs.dat"}
_PAIRS = {}


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    return tmp_path_factory.mktemp("mhd_tail")


def pair(name, rundir):
    if name not in _PAIRS:
        path, extra = DECKS[name]
        _PAIRS[name] = DeckPair(deck_text(path), extra,
                                rundir=str(rundir / name.replace(" ", "_")))
    return _PAIRS[name]


def _div_b(bfc, mesh):
    """div B on the interior cells of the face field."""
    mbi = mesh.mb_indcs
    ms = mesh.mesh_size
    ks, js, is_ = mbi.ks, mbi.js, mbi.is_
    ke, je, ie = mbi.ke + 1, mbi.je + 1, mbi.ie + 1
    b1 = bfc["x1f"][:, ks:ke, js:je]
    d = (b1[..., is_ + 1:ie + 1] - b1[..., is_:ie]) / ms.dx1
    if mbi.nx2 > 1:
        b2 = bfc["x2f"][:, ks:ke, :, is_:ie]
        d = d + (b2[:, :, js + 1:je + 1] - b2[:, :, js:je]) / ms.dx2
    if mbi.nx3 > 1:
        b3 = bfc["x3f"][:, :, js:je, is_:ie]
        d = d + (b3[:, ks + 1:ke + 1] - b3[:, ks:ke]) / ms.dx3
    return d


@pytest.mark.parametrize("name", sorted(DECKS))
def test_deck_matches_jax(name, rundir, tmp_path):
    p = check_pair(pair(name, rundir))
    assert p.phys.is_mhd and p.phys.is_sr == (name == "mub1")
    # CT keeps div B where the initial field put it (zero up to
    # round-off for the curl-of-A decks; the current sheet's analytic
    # field is not discretely solenoidal)
    bmax = max(float(np.abs(v).max()) for v in p.state["bfc"].values())
    ddiv = _div_b(p.state["bfc"], p.mesh) - _div_b(p.port_ready["bfc"],
                                                  p.mesh)
    assert np.abs(ddiv).max() <= 1e-12 * max(bmax, 1.0) / p.mesh.mesh_size.dx1
    if name not in ("current_sheet",):
        assert np.abs(_div_b(p.state["bfc"], p.mesh)).max() <= \
            1e-12 * max(bmax, 1.0) / p.mesh.mesh_size.dx1
    assert np.abs(p.state["u"] - p.port_ready["u"]).max() > 0.0
    assert all(k.launches == 0 for k in kernels.ALL)
    if name in ERRS:
        p.jax_final(str(tmp_path))
        got = (rundir / name.replace(" ", "_") / ERRS[name]).read_text()
        ref = (tmp_path / ERRS[name]).read_text()
        g, r = got.splitlines(), ref.splitlines()
        assert len(g) == len(r) == 2 and g[0] == r[0]
        assert g[1].split()[:4] == r[1].split()[:4]
        np.testing.assert_allclose([float(x) for x in g[1].split()[4:]],
                                   [float(x) for x in r[1].split()[4:]],
                                   rtol=2e-6)
