"""Source terms and their problem generators through both packages.

  * ``srcterms.ism_cool_fn`` across its three branches (the Koyama &
    Inutsuka fit, the SPEX table, the CGOLS power law and the branch
    edges) and ``units.Units`` (the cgs scales, derived units and
    constants, with and without GR units) against the JAX package's to
    1e-13; ``SourceTerms.apply`` and ``new_dt`` with every source on,
    on random states, to 1e-13.
  * Three cycles of ``inputs/hydro/rt2d`` and ``inputs/mhd/rt2d-mhd``
    (constant gravity; 16 x 48), ``inputs/hydro/lw_implode`` (32^2),
    ``inputs/hydro/slotted_cyl`` and ``inputs/tests/advect_hyd``
    (kinematic, the advect solver and a passive scalar; 32^2 and 32 x
    16) through the port's ``main.run`` and the JAX package's jitted
    stage (``torch_deck_parity.DeckPair``) to 1e-10 of each field's
    scale, in float64.  The JAX ``rt`` generator builds no MHD state (it
    calls the one-argument hydro p2c); for ``rt2d-mhd`` the JAX side
    starts from its own primitives with the uniform x1 field
    ``problem/b0`` on the faces, through its ``state_from_prims``.
    ``rt2d-mhd`` meets ROADMAP F4 twice: the mass flux through its
    reflecting x2 walls and through the face at x = 0, the plane its
    seed is symmetric about, is zero up to rounding, and the corner
    EMFs' upwind selects follow the sign of that noise (after two
    cycles the face fields of the packages part by 1e-6 at the walls).
    The shipped deck is therefore held whole for one cycle, and for
    three cycles with periodic x2 boundaries and the domain shifted by a
    quarter cell in x1, as the SMR tests shift theirs; and for three
    cycles as shipped, u, w and the time whole and the face fields off
    the two cells next to each wall (``test_rt2d_mhd_three_cycles``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from athenak_tpu import srcterms as jsrc  # noqa: E402
from athenak_tpu import units as junits  # noqa: E402
from athenak_tpu.athinput import ParameterInput as JaxInput  # noqa: E402
from athenak_tpu.ops.eos import EOSData as JEOS  # noqa: E402
from athenak_tpu.pgen import rt as jax_rt  # noqa: E402
from athenak_tpu.pgen import state_from_prims as jax_from_prims  # noqa: E402
from athenak_tpu_torch import kernels  # noqa: E402
from athenak_tpu_torch import srcterms as tsrc  # noqa: E402
from athenak_tpu_torch import units as tunits  # noqa: E402
from athenak_tpu_torch.athinput import ParameterInput  # noqa: E402
from athenak_tpu_torch.ops.eos import EOSData as TEOS  # noqa: E402
from test_torch_refinement import one_torch_thread  # noqa: E402,F401
from torch_deck_parity import (DeckPair, assert_states_close,  # noqa: E402
                               check_pair, deck_text, interior)

TOL = 1e-13
_JAX_RT_INIT = jax_rt.init


def _close(got, ref, label):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, label
    err = float(np.abs(got - ref).max())
    assert err <= TOL * float(np.abs(ref).max()), f"{label}: {err:g}"


def test_ism_cool_fn_branches():
    """log T from 0 to 10 on a fine grid, the branch edges 4.2 and 8.15
    and their neighbours, the table's nodes, and T = 0 (the floor)."""
    logt = np.concatenate([
        np.linspace(0.0, 10.0, 4001), [4.2, 8.15, 4.12, 8.16],
        np.nextafter(4.2, [0.0, 10.0]), np.nextafter(8.15, [0.0, 10.0]),
        4.12 + 0.04 * np.arange(102)])
    temp = np.concatenate([10.0 ** logt, [0.0, 1e-300]])
    ref = np.asarray(jsrc.ism_cool_fn(jnp.asarray(temp)))
    got = tsrc.ism_cool_fn(torch.tensor(temp, dtype=torch.float64)).numpy()
    # the three branches are each exercised
    assert (logt <= 4.2).any() and (logt > 8.15).any()
    assert ((logt > 4.2) & (logt <= 8.15)).any()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=0.0)


UNIT_DECKS = {
    "plain": "",
    "scaled": "<units>\nlength_cgs = 3.0856775809623245e+18\n"
              "mass_cgs = 4.9e31\ntime_cgs = 3.15576e+13\nmu = 0.62\n",
    "gr": "<coord>\ngeneral_rel = true\n<units>\ndensity_cgs = 1e-10\n"
          "bhmass_msun = 6.5e9\n",
}
UNIT_NAMES = ("length_cgs", "mass_cgs", "time_cgs", "mu", "velocity_cgs",
              "density_cgs", "energy_cgs", "pressure_cgs",
              "temperature_cgs", "k_boltzmann", "grav_constant",
              "speed_of_light")


@pytest.mark.parametrize("case", sorted(UNIT_DECKS))
def test_units_match_jax(case):
    text = "<job>\nbasename = u\n" + UNIT_DECKS[case]
    uj = junits.Units(JaxInput.from_string(text))
    ut = tunits.Units(ParameterInput.from_string(text))
    for name in UNIT_NAMES:
        a, b = getattr(ut, name), getattr(uj, name)
        assert abs(a - b) <= TOL * abs(b), name


SRC_DECK = """
<job>
basename = s
<mesh>
nghost = 2
nx1 = 8
x1min = 0.0
x1max = 1.0
nx2 = 6
x2min = 0.0
x2max = 1.0
nx3 = 4
x3min = 0.0
x3max = 1.0
<hydro_srcterms>
const_accel = true
const_accel_val = -0.3
const_accel_dir = {direction}
ism_cooling = true
hrate = 2.0e-26
rel_cooling = true
crate_rel = 0.7
cpower_rel = 1.5
<units>
length_cgs = 3.0856775809623245e+18
mass_cgs = 4.9e31
time_cgs = 3.15576e+13
mu = 0.62
"""


@pytest.mark.parametrize("direction", [1, 2, 3])
def test_source_terms_match_jax(direction):
    """Every source at once on random states, then the cooling dt."""
    from athenak_tpu.mesh import Mesh as JMesh
    from athenak_tpu_torch.mesh import Mesh as TMesh
    text = SRC_DECK.format(direction=direction)
    pj, pt = JaxInput.from_string(text), ParameterInput.from_string(text)
    sj = jsrc.SourceTerms("hydro_srcterms", pj, JMesh(pj), JEOS())
    st = tsrc.SourceTerms("hydro_srcterms", pt, TMesh(pt), TEOS())
    rng = np.random.default_rng(direction)
    shape = (1, 5, 8, 10, 12)
    w = rng.uniform(0.2, 2.0, shape)
    w[:, 1:4] = rng.uniform(-1.0, 1.0, (1, 3) + shape[2:])
    w[:, 4] *= 10.0 ** rng.uniform(-4.0, 4.0, shape[2:])  # every branch
    u = rng.uniform(-1.0, 1.0, shape)
    ref = sj.apply(jnp.asarray(u), jnp.asarray(w), jnp.asarray(0.01))
    got = st.apply(torch.tensor(u), torch.tensor(w), 0.01)
    _close(got.numpy(), ref, "apply")
    _close(st.new_dt(torch.tensor(w)).numpy(), sj.new_dt(jnp.asarray(w)),
           "new_dt")
    assert st.any_enabled and sj.any_enabled


# ------------------------------------------------------------------ decks
DECKS = {
    "rt2d": ("inputs/hydro/rt2d.athinput", ["mesh/nx1=16", "mesh/nx2=48"]),
    "rt2d-mhd": ("inputs/mhd/rt2d-mhd.athinput",
                 ["mesh/nx1=16", "mesh/nx2=48"]),
    "rt2d-mhd shifted": ("inputs/mhd/rt2d-mhd.athinput",
                         ["mesh/nx1=16", "mesh/nx2=48",
                          "mesh/ix2_bc=periodic", "mesh/ox2_bc=periodic",
                          f"mesh/x1min={-0.25 + 0.5 / 64!r}",
                          f"mesh/x1max={0.25 + 0.5 / 64!r}"]),
    "lw_implode": ("inputs/hydro/lw_implode.athinput",
                   ["mesh/nx1=32", "mesh/nx2=32", "meshblock/nx1=32",
                    "meshblock/nx2=32"]),
    "slotted_cyl": ("inputs/hydro/slotted_cyl.athinput",
                    ["mesh/nx1=32", "mesh/nx2=32"]),
    "advect_hyd": ("inputs/tests/advect_hyd.athinput",
                   ["mesh/nx1=32", "mesh/nx2=16"]),
}
_PAIRS = {}


def _jax_rt_mhd(pin, mesh, phys):
    """The JAX ``rt`` primitives with the uniform x1 field ``b0``, built
    through the JAX package's ``state_from_prims``."""
    class Capture:
        eos, nvar = phys.eos, phys.nvar

        def prim_to_cons(self, w):
            return None

        def make_state(self, u, w):
            return w

    w = np.asarray(_JAX_RT_INIT(pin, mesh, Capture()))
    bfc = {k: np.full(s, pin.get_or_add_real("problem", "b0", 0.0))
           for k, s in phys.fc_shapes.items()}
    bfc["x2f"][:] = 0.0
    bfc["x3f"][:] = 0.0
    return jax_from_prims(phys, jnp.asarray(w), bfc)


@pytest.fixture(scope="module")
def rundir(tmp_path_factory):
    return tmp_path_factory.mktemp("srcterms")


def pair(name, rundir):
    if name not in _PAIRS:
        path, extra = DECKS[name]
        mp = pytest.MonkeyPatch()
        if name.startswith("rt2d-mhd"):
            mp.setattr(jax_rt, "init", _jax_rt_mhd)
        try:
            _PAIRS[name] = DeckPair(deck_text(path), extra,
                                    ncyc=1 if name == "rt2d-mhd" else 3,
                                    rundir=str(rundir / name.replace(
                                        " ", "_")))
        finally:
            mp.undo()
    return _PAIRS[name]


@pytest.mark.parametrize("name", sorted(DECKS))
def test_deck_matches_jax(name, rundir):
    p = check_pair(pair(name, rundir))
    assert p.phys.is_mhd == name.startswith("rt2d-mhd")
    if name.startswith("rt2d"):
        assert p.phys.srcterms.const_accel
    if name in ("slotted_cyl", "advect_hyd"):
        assert p.phys.nvar == 5 and p.phys.time_evolution == "kinematic"
    assert np.abs(p.state["u"] - p.port_ready["u"]).max() > 0.0
    assert all(k.launches == 0 for k in kernels.ALL)


def test_rt2d_mhd_three_cycles(rundir):
    """The shipped rt2d-mhd (16 x 48) for three cycles: the initial and
    initialised states to 1e-12, u, w and the time to 1e-10 everywhere,
    and the face fields to 1e-10 of their scale but on the faces within
    two cells of a reflecting x2 wall, where the GS07 selects follow the
    sign of a wall mass flux that is zero up to rounding (ROADMAP F4);
    there the packages are only held to the field's scale."""
    path, extra = DECKS["rt2d-mhd"]
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_rt, "init", _jax_rt_mhd)
    try:
        p = DeckPair(deck_text(path), extra, ncyc=3,
                     rundir=str(rundir / "rt2d-mhd_3"))
    finally:
        mp.undo()
    assert p.mesh.ncycle == 3
    assert_states_close(p.port_init, p.jax_init, 1e-12)
    assert_states_close(p.port_ready, p.jax_ready, 1e-12)
    cells = ("u", "w")
    assert_states_close({k: p.state[k] for k in cells},
                        {k: p.jax_state[k] for k in cells}, 1e-10)
    np.testing.assert_allclose(p.mesh.time, p.jax_time, rtol=1e-10)
    bmax = max(float(np.abs(v).max()) for v in p.jax_state["bfc"].values())
    for c, ref in p.jax_state["bfc"].items():
        got, ref = interior(p.state["bfc"][c]), interior(ref)
        err = np.abs(got - ref)[0, 0] / bmax          # [n2 (+1), n1 (+1)]
        wall = 3 if c == "x2f" else 2                  # x2f: the wall face
        assert err[wall:-wall].max() <= 1e-10, c
        assert err.max() <= 1e-5, c
