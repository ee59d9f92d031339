"""The port's dynamical GRMHD held against the JAX package on the CPU
(float64): the flux, source, stress-energy and Z4c matter terms on
random ADM states; three cycles of the shipped decks of
``inputs/dyn_grmhd/`` (sod as shipped, the TOV star on its fixed
spacetime and coupled to Z4c at 16^3, ``tov_z4c_smr`` cut to 8 blocks
of 8^3 on its refined level); the ``import_id`` generators on their
test's own volumes; the ``bin`` outputs of ``mhd_t``, ``adm`` and
``tmunu``; a restart; the decks through the CLI; and the kernel gates
and fill launches on a dyngr state.

Tolerances: the terms on random states to 1e-12 of each output's scale;
the decks' initial and initialised states to 1e-12, three cycles to
1e-10 (u, T, z and the face field, each of its own scale, and w through
its p2c image: the atmosphere's velocity is ill-conditioned in the c2p,
ROADMAP F12).  The
TOV decks are symmetric about the origin but carry no field, so the
corner EMFs' upwind selects (ROADMAP F4) have nothing to bite on.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from athenak_tpu import main as jax_main
from athenak_tpu.athinput import ParameterInput as JaxInput
from athenak_tpu_torch import main as torch_main
from athenak_tpu_torch.athinput import ParameterInput
from torch_deck_parity import (JAX_EXTRA, DeckPair, assert_close,
                               assert_states_close, deck_text, interior,
                               read_bin)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOD = "inputs/dyn_grmhd/sod.athinput"
COWLING = "inputs/dyn_grmhd/tov_cowling.athinput"
SMR = "inputs/dyn_grmhd/tov_z4c_smr.athinput"
BBH = "inputs/dyn_grmhd/dynbbh.athinput"
N16 = ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]
B16 = ["meshblock/nx1=16", "meshblock/nx2=16", "meshblock/nx3=16"]
# tov_z4c_smr cut: one 8^3 root block under the refined region, so 8
# blocks of 8^3 on level 1 (the shipped deck's shape: every root block
# refined)
SMR_CUT = ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8", "meshblock/nx1=8",
           "meshblock/nx2=8", "meshblock/nx3=8"]
DECKS = {
    "sod": (SOD, []),
    "tov_cowling": (COWLING, N16),
    "tov_z4c": (SMR, N16 + B16 + ["mesh_refinement/refinement=none"]),
    "tov_z4c_smr": (SMR, SMR_CUT),
}
KEYS = ("u", "w", "T", "z")


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """Each deck through both packages once, built on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            path, extra = DECKS[name]
            cache[name] = DeckPair(
                deck_text(path), extra,
                rundir=str(tmp_path_factory.mktemp(name)))
        return cache[name]
    return get


# ---------------------------------------------------------------------------
# the terms on random ADM states
# ---------------------------------------------------------------------------
SMALL = ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8", "meshblock/nx1=8",
         "meshblock/nx2=8", "meshblock/nx3=8",
         "mesh_refinement/refinement=none"]


@pytest.fixture(scope="module")
def small():
    """Both packages' physics of the coupled deck at 8^3 (ng 4) and one
    random state: an ADM slice (metric near flat, lapse, shift,
    curvature), primitives with a field, and a Z4c state."""
    from athenak_tpu.bvals import BoundaryValues as JaxBV
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    text = deck_text(SMR)
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + SMALL)
    jm = JaxMesh(pj)
    jp = jax_main.make_physics(pj, jm, JaxBV(jm))
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(SMALL)
    tm = Mesh(pt)
    tp = torch_main.make_physics(pt, tm, BoundaryValues(tm), "cpu",
                                 torch.float64)
    rng = np.random.default_rng(5)
    shp = (1, 16, 16, 16)

    def u(lo, hi, s=shp):
        return rng.uniform(lo, hi, s)
    adm = {"g3d": [1.0 + 0.2 * u(0, 1), 0.05 * u(-1, 1), 0.05 * u(-1, 1),
                   1.0 + 0.2 * u(0, 1), 0.05 * u(-1, 1), 1.0 + 0.2 * u(0, 1)],
           "alpha": 0.8 + 0.2 * u(0, 1),
           "beta_u": [0.1 * u(-1, 1) for _ in range(3)],
           "K_dd": [0.01 * u(-1, 1) for _ in range(6)]}
    rho = 10.0 ** u(-4, -1)
    w = np.stack([rho, u(-0.5, 0.5), u(-0.5, 0.5), u(-0.5, 0.5),
                  rho * 10.0 ** u(-3, -1)], axis=1)
    bfc = {k: np.sqrt(rho).mean() * rng.uniform(-1, 1, s)
           for k, s in tp.fc_shapes.items()}
    z = np.zeros((1, 22) + shp[1:])
    z[:, 0] = 0.5 + 0.5 * u(0, 1)
    for c in (1, 4, 6):
        z[:, c] = 1.0 + 0.05 * u(-1, 1)
    for c in (2, 3, 5):
        z[:, c] = 0.02 * u(-1, 1)
    for c in range(7, 18):
        z[:, c] = 0.01 * u(-1, 1)
    z[:, 18] = 0.5 + 0.5 * u(0, 1)
    for c in (19, 20, 21):
        z[:, c] = 0.05 * u(-1, 1)
    return dict(jp=jp, tp=tp, adm=adm, w=w, bfc=bfc, z=z)


def _both(s):
    """The random state as JAX arrays and as torch tensors, with T, bcc
    and u made by each package."""
    out = []
    for mk, phys in ((jnp.asarray, s["jp"]), (torch.tensor, s["tp"])):
        adm = {k: [mk(c) for c in v] if isinstance(v, list) else mk(v)
               for k, v in s["adm"].items()}
        w = mk(s["w"])
        bfc = {k: mk(v) for k, v in s["bfc"].items()}
        bcc = phys.compute_bcc(bfc)
        n = w[:, 0] / phys.ps.mb
        T = phys.policy.temperature_from_p(n, w[:, 4])
        u = phys.prim_to_cons_state(w, T, bcc, adm)
        out.append(dict(adm=adm, w=w, bfc=bfc, bcc=bcc, T=T, u=u,
                        z=mk(s["z"])))
    return out


def _close(got, ref, label, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert_close(got, np.asarray(ref), tol, label)


@pytest.mark.parametrize("rsolver", ["llf", "hlle"])
def test_fluxes_match_jax(small, rsolver):
    """The reconstructed LLF and HLLE fluxes, the mass fluxes and the
    face EMFs of every direction."""
    js, ts = _both(small)
    for p in (small["jp"], small["tp"]):
        p.rsolver = rsolver
    jf = small["jp"].fluxes(js["w"], js["T"], js["bcc"], js["bfc"],
                            js["adm"])
    tf = small["tp"].fluxes(ts["w"], ts["T"], ts["bcc"], ts["bfc"],
                            ts["adm"])
    for part in range(3):
        for k in jf[part]:
            _close(tf[part][k], jf[part][k], f"{rsolver} {part} {k}")


def test_coord_sources_and_tmunu_match_jax(small):
    """The coordinate source terms (the increment of u) and the
    stress-energy projections E, S_i and S_ij."""
    js, ts = _both(small)
    _close(ts["u"], js["u"], "p2c")
    jd = small["jp"].coord_src_terms(js["u"], js["w"], js["T"], js["bcc"],
                                     js["adm"], 0.1) - js["u"]
    td = small["tp"].coord_src_terms(ts["u"].clone(), ts["w"], ts["T"],
                                     ts["bcc"], ts["adm"], 0.1) - ts["u"]
    _close(td, jd, "coordinate sources")
    jt = small["jp"].set_tmunu(js["u"], js["w"], js["bcc"], js["adm"])
    tt = small["tp"].set_tmunu(ts["u"], ts["w"], ts["bcc"], ts["adm"])
    _close(tt["E"], jt["E"], "E")
    for k in ("S_d", "S_dd"):
        for a, (got, ref) in enumerate(zip(tt[k], jt[k])):
            _close(got, ref, f"{k}{a}")


def test_z4c_matter_rhs_matches_jax(small):
    """The Z4c right-hand side with the matter source of the random
    fluid, and the matter part alone (with minus without)."""
    js, ts = _both(small)
    jt = small["jp"].set_tmunu(js["u"], js["w"], js["bcc"], js["adm"])
    tt = small["tp"].set_tmunu(ts["u"], ts["w"], ts["bcc"], ts["adm"])
    jz, tz = small["jp"].z4c, small["tp"].z4c
    jr = jz.rhs(js["z"], tmunu=jt)
    tr = tz.rhs(ts["z"], tmunu=tt)
    _close(tr, jr, "rhs with matter", 1e-10)
    _close(tr - tz.rhs(ts["z"]), jr - jz.rhs(js["z"]), "matter part",
           1e-10)


# ---------------------------------------------------------------------------
# the decks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(DECKS))
def test_dyngr_decks_three_cycles(pairs, name):
    """The generator and p2c, the initialisation (fills, the algebraic
    constraints, c2p) to 1e-12, three cycles to 1e-10, the time."""
    pair = pairs(name)
    ng = pair.mesh.mb_indcs.ng
    assert pair.mesh.ncycle == 3
    assert_states_close(pair.port_init, pair.jax_init, 1e-12, ng, KEYS)
    assert_states_close(pair.port_ready, pair.jax_ready, 1e-12, ng, KEYS)
    assert_states_close(pair.state, pair.jax_state, 1e-10, ng,
                        ("u", "T", "z"))
    # w through its p2c image: the atmosphere's velocity is
    # ill-conditioned in the c2p (ROADMAP F12)
    phys = pair.phys
    images = []
    for st in (pair.state, pair.jax_state):
        t = {k: torch.as_tensor(v) for k, v in st.items()
             if not isinstance(v, dict)}
        images.append(interior(phys.prim_to_cons_state(
            t["w"], t["T"], t["bcc"], phys.adm_of(t)).numpy(), ng))
    assert_close(images[0], images[1], 1e-10, "p2c(w)")
    np.testing.assert_allclose(pair.mesh.time, pair.jax_time, rtol=1e-12)
    for k in KEYS:
        if k in pair.state:
            assert np.isfinite(pair.state[k]).all(), k
    if name == "tov_z4c_smr":
        assert pair.mesh.multilevel and set(pair.mesh.mb_lev) == {1}


@pytest.mark.parametrize("pgen", ["z4c_adm_import", "dyngr_bns_import"])
def test_import_id_generators_match_jax(pgen, tmp_path):
    """Both generators on tests/test_import_id.py's own volumes (the
    Brill-Lindquist puncture, the TOV star): the states to 1e-12."""
    import test_import_id as ti
    donor = str(tmp_path / "donor.npz")
    if pgen == "z4c_adm_import":
        ti._donor_puncture(donor)
        text = ti.Z4C_DECK.format(pgen=pgen, extra=f"id_filename = {donor}")
    else:
        ti._donor_tov(donor, None, None)
        text = ti.DYNGR_DECK.format(pgen=pgen,
                                    extra=f"id_filename = {donor}")
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA)
    jst = jax_main.build(pj)[4]
    tst = torch_main.build(ParameterInput.from_string(text),
                           device="cpu")[4]
    for k in ("u", "w", "T"):
        if k in jst:
            _close(tst[k], jst[k], k)


def test_dyngr_restart_is_bitwise(tmp_path, monkeypatch):
    """The TOV star on its fixed spacetime at 16^3: four cycles straight
    against two, a restart file, and two more through ``-r``; u, w, T
    and the face field bitwise."""
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    deck = tmp_path / "tov.athinput"
    deck.write_text(deck_text(COWLING)
                    + "\n<output9>\nfile_type = rst\ndcycle = 2\n")
    cwd = os.getcwd()
    try:
        _, _, _, s1 = torch_main.cli(["-i", str(deck), "-d",
                                      str(tmp_path / "straight"), *N16,
                                      "time/nlim=4"])
        os.chdir(cwd)
        torch_main.cli(["-i", str(deck), "-d", str(tmp_path / "first"),
                        *N16, "time/nlim=2"])
        os.chdir(cwd)
        rst = str(tmp_path / "first" / "tov_cowling.00001.rst")
        from athenak_tpu_torch.outputs import load_restart
        assert "T" in load_restart(rst)[4]
        m2, _, _, s2 = torch_main.cli(["-r", rst, "-d",
                                       str(tmp_path / "first"),
                                       "time/nlim=4"])
    finally:
        os.chdir(cwd)
    assert m2.ncycle == 4
    for k in ("u", "w", "T", "bcc"):
        assert torch.equal(s1[k], s2[k]), k
    for k in s1["bfc"]:
        assert torch.equal(s1["bfc"][k], s2["bfc"][k]), k


@pytest.mark.parametrize("name,variable", [
    ("tov_cowling", "mhd_t"), ("tov_cowling", "adm"),
    ("tov_cowling", "tmunu"), ("tov_z4c", "adm"), ("tov_z4c", "tmunu"),
    ("tov_z4c", "z4c")])
def test_dyngr_bin_outputs_match_jax(pairs, name, variable, tmp_path):
    """The port's final state through both packages' ``bin`` writers:
    the temperature, the ADM fields of the fixed and of the evolved
    spacetime, the stress-energy and the Z4c fields; the preheader and
    block records byte-equal, the cells of copied fields byte-equal, the
    computed ones to 1e-12."""
    from athenak_tpu import outputs as jax_outputs
    from athenak_tpu_torch import outputs as torch_outputs
    pair = pairs(name)
    for pin in (pair.port_pin, pair.jax_pin):
        pin.set_value("output7", "file_type", "bin")
        pin.set_value("output7", "variable", variable)
    tst = {k: {kk: torch.as_tensor(vv) for kk, vv in v.items()}
           if isinstance(v, dict) else torch.as_tensor(v)
           for k, v in pair.state.items()}
    jst = jax.tree_util.tree_map(jnp.asarray, pair.state)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        torch_outputs.BinaryOutput(pair.port_pin, pair.mesh, pair.phys,
                                   "output7").write(pair.mesh, tst)
        pair.jax_mesh.time, pair.jax_mesh.ncycle = pair.mesh.time, 3
        os.makedirs("jax")
        os.chdir("jax")
        jax_outputs.BinaryOutput(pair.jax_pin, pair.jax_mesh, pair.jax_phys,
                                 "output7").write(
            pair.jax_mesh, jst["u"], jst["w"], state=jst)
    finally:
        os.chdir(cwd)
    fname = [f for f in os.listdir(tmp_path) if f.endswith(".bin")][0]
    th, td = read_bin(tmp_path / fname)
    jh, jd = read_bin(tmp_path / "jax" / fname)
    assert th.split(b"header offset=")[0] == jh.split(b"header offset=")[0]
    assert len(td) == len(jd)
    copied = variable in ("mhd_t", "z4c") or (
        variable == "adm" and name == "tov_cowling")
    if copied:
        assert td == jd
    else:
        _close(np.frombuffer(td, np.float64), np.frombuffer(jd, np.float64),
               variable)


def test_dyngr_decks_through_the_cli(tmp_path, monkeypatch):
    """The four shipped decks (cut) and both import generators through
    ``main.cli``: finite states, dynbbh's history file."""
    import test_import_id as ti
    monkeypatch.setenv("ATHENAK_DEVICE", "cpu")
    donor = str(tmp_path / "tov.npz")
    ti._donor_tov(donor, None, None)
    runs = [(SOD, [], 2), (COWLING, N16, 2), (SMR, SMR_CUT, 1),
            (BBH, ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=8",
                   "meshblock/nx1=8", "meshblock/nx2=8", "meshblock/nx3=8",
                   "output1/dt=0.5"], 2)]
    for i, text in enumerate((ti.DYNGR_DECK, ti.Z4C_DECK)):
        deck = tmp_path / f"import{i}.athinput"
        pgen = ("dyngr_bns_import", "z4c_adm_import")[i]
        deck.write_text(text.format(pgen=pgen,
                                    extra=f"id_filename = {donor}"))
        runs.append((str(deck), [], 2))
    cwd = os.getcwd()
    try:
        for k, (deck, extra, nlim) in enumerate(runs):
            mesh, _, _, st = torch_main.cli(
                ["-i", os.path.join(ROOT, deck), "-d", str(tmp_path / str(k)),
                 *extra, f"time/nlim={nlim}"])
            os.chdir(cwd)
            # the import decks stop at their tlim of 0.05 first
            assert mesh.ncycle == nlim or (
                mesh.ncycle >= 1 and abs(mesh.time - 0.05) < 1e-12)
            for key in ("u", "w", "T", "z"):
                if key in st:
                    assert torch.isfinite(st[key]).all(), (deck, key)
    finally:
        os.chdir(cwd)
    assert (tmp_path / "3" / "dynbbh.hst").exists()


# ---------------------------------------------------------------------------
# the kernel gates
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sod", "tov_cowling", "tov_z4c_smr",
                                  "dynbbh", "tov_z4c"])
def test_dyngr_gates_match_jax(name):
    """On the shipped decks every kernel gate decides on a dyngr physics
    as the JAX package's (without its TPU condition): A, C, D, E, F and J
    closed (``use_pallas`` and ``use_fused_stage`` off), B and G closed
    (outflow sides), H open only where JAX's Z4c gate is (one level),
    and then closed at the stage by the matter source."""
    from athenak_tpu.bvals import BoundaryValues as JaxBV
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu.ops.pallas_pool_fill import supports_pool_fill
    from athenak_tpu.ops.pallas_z4c import supports_z4c_stage
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    path, extra = {"dynbbh": (BBH, [])}.get(name, DECKS.get(name))
    text = deck_text(path)
    pj = JaxInput.from_string(text)
    pj.modify_from_cmdline(JAX_EXTRA + extra)
    jm = JaxMesh(pj)
    jbv = JaxBV(jm)
    jp = jax_main.make_physics(pj, jm, jbv)
    pt = ParameterInput.from_string(text)
    pt.modify_from_cmdline(extra)
    tm = Mesh(pt)
    tbv = BoundaryValues(tm)
    tp = torch_main.make_physics(pt, tm, tbv, "cpu", torch.float64)
    assert type(tp).__name__ == type(jp).__name__ == "DynGRMHD"
    assert not jp.use_pallas and not jp.use_fused_stage
    assert not (tp.use_mega_v2 or tp.use_mega_stage or tp.use_fused_stage
                or tp.use_fused_ct or tp.use_flux_dir)
    single = (jm.nmb_total == 1 and not jbv.multilevel
              and len(jbv.active_axes) == 3 and jbv.ng == 2
              and not any(jbv.any_phys.values())
              and all(f == "periodic" for f in jbv.flag.values()))
    assert tbv.use_fill_kernel == single is False
    assert tbv.use_pool_fill == supports_pool_fill(jm) is False
    if jp.z4c is not None:
        assert tp.z4c.use_stage_kernel == supports_z4c_stage(jp.z4c, jm) \
            == (name == "tov_z4c")


PERIODIC = ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8", "meshblock/nx1=8",
            "meshblock/nx2=8", "meshblock/nx3=8", "mesh/nghost=2",
            "mesh_refinement/refinement=none"] + [
    f"mesh/{s}x{d}_bc=periodic" for s in "io" for d in (1, 2, 3)]
POOL = PERIODIC[3:] + ["mesh/nx1=16", "mesh/nx2=16", "mesh/nx3=16"]


@pytest.mark.parametrize("label,extra,kind", [
    ("block", PERIODIC, "periodic"), ("pool", POOL, "pool")])
def test_fill_launches_on_a_dyngr_state(label, extra, kind, monkeypatch):
    """The coupled TOV deck on a fully periodic ng-2 mesh, one 8^3 block
    (B) or a 2x2x2 pool (G), with the kernels' gates opened for CPU
    tensors (Z4c's stage kernel too): the JAX package fills u and z with
    one call each and the faces with one (``dyngr.py:558-563`` and
    ``:600-613``), so n RK2 cycles take 2 + 4 n cell fills and 1 + 2 n
    face fills, all on the kernel, and no Z4c stage kernel (the matter
    closes it); the state bitwise the plain path's."""
    from athenak_tpu_torch import bvals
    from athenak_tpu_torch.ops import fill, pool_fill, z4c_stage
    from athenak_tpu_torch.physics import mhd
    from athenak_tpu_torch.z4c import z4c
    ncyc = 2
    for mod in (bvals, mhd, z4c):
        monkeypatch.setattr(mod, "kernel_dtype_ok", lambda t: True)
    names = {"periodic": ("periodic_fill_cc", "periodic_fill_fc"),
             "pool": ("pool_fill_cc", "pool_fill_fc")}[kind]
    calls = {n: 0 for n in names + ("fused_z4c_stage",)}

    def counted(mod, fn):
        orig = getattr(mod, fn)

        def wrapped(*a, **k):
            calls[fn] += 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, fn, wrapped)
    counted(fill if kind == "periodic" else pool_fill, names[0])
    counted(fill if kind == "periodic" else pool_fill, names[1])
    counted(z4c_stage, "fused_z4c_stage")
    states = {}
    for use in ("true", "false"):
        for k in calls:
            calls[k] = 0
        pin = ParameterInput.from_string(deck_text(SMR))
        pin.modify_from_cmdline(extra + [
            f"time/nlim={ncyc}", f"mhd/use_kernels={use}",
            f"z4c/use_kernels={use}"])
        _, phys, _, states[use] = torch_main.run(pin, device="cpu")
        on = use == "true"
        assert calls == {names[0]: (2 + 4 * ncyc) * on,
                         names[1]: (1 + 2 * ncyc) * on,
                         "fused_z4c_stage": 0}, (label, use, calls)
    for k in ("u", "w", "T", "z"):
        assert torch.equal(states["true"][k], states["false"][k]), k
