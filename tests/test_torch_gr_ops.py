"""The GR operations of the port against the JAX package, float64.

  * The Cartesian Kerr-Schild metric, its derivatives and the ADM
    decomposition at seeded random points, for a = 0, a = 0.9375 and
    Minkowski, to 1e-12 of each component's scale.
  * ``coordinates.GRGeometry``: the kept metric bitwise equal to a fresh
    call of ``gr.cks`` in float64 (the components i <= j; (j, i) is the
    same tensor), and the excision masks equal to the JAX package's.
  * The GR hydro and MHD c2p/p2c on random states around a spinning hole
    whose c2p hits the density and energy floors, the Lorentz ceiling,
    the excision inside the horizon and failed root finds (non-finite
    momenta), to 1e-12, the four counters equal and non-zero.
  * The GR hydro and GRMHD LLF and HLLE solvers in each direction, to
    1e-12, and the coordinate source terms with and without the field.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from athenak_tpu.gr import cks as jcks  # noqa: E402
from athenak_tpu.ops import eos as jeos  # noqa: E402
from athenak_tpu.ops import eos_gr as jeg  # noqa: E402
from athenak_tpu.ops import rsolvers_gr as jrg  # noqa: E402
from athenak_tpu.ops import rsolvers_grmhd as jrgm  # noqa: E402
from athenak_tpu_torch.gr import cks as tcks  # noqa: E402
from athenak_tpu_torch.ops import eos as teos  # noqa: E402
from athenak_tpu_torch.ops import eos_gr as teg  # noqa: E402
from athenak_tpu_torch.ops import rsolvers_gr as trg  # noqa: E402
from athenak_tpu_torch.ops import rsolvers_grmhd as trgm  # noqa: E402
from test_torch_hydro_ops import SHAPE, close  # noqa: E402

SPINS = {"a=0": (0.0, False), "a=0.9375": (0.9375, False),
         "minkowski": (0.0, True)}
A = 0.9375
EOS_KW = dict(gamma=4.0 / 3.0, is_ideal=True, dfloor=0.05, pfloor=0.02,
              gamma_max=3.0)
DEXCISE, PEXCISE = 1.0e-3, 1.0e-4


def _points(rng, lo=-5.0, hi=5.0):
    return [rng.uniform(lo, hi, SHAPE) for _ in range(3)]


def _pair(fn_j, fn_t, xyz, a, mink):
    return (fn_j(*map(jnp.asarray, xyz), a, mink),
            fn_t(*map(torch.from_numpy, xyz), a, mink))


def _close_nested(got, ref, label):
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), label
        for i, (g, r) in enumerate(zip(got, ref)):
            _close_nested(g, r, f"{label}[{i}]")
        return
    ref = np.broadcast_to(np.asarray(ref, dtype=np.float64), SHAPE)
    got = np.broadcast_to(got.numpy() if torch.is_tensor(got)
                          else np.asarray(got, dtype=np.float64), SHAPE)
    err = np.abs(got - ref).max()
    assert err <= 1e-12 * max(np.abs(ref).max(), 1e-300), f"{label}: {err}"


@pytest.mark.parametrize("spin", sorted(SPINS))
def test_metric_matches_jax(spin):
    a, mink = SPINS[spin]
    xyz = _points(np.random.default_rng(3))
    for name in ("metric", "metric_derivatives", "adm_decomposition"):
        ref, got = _pair(getattr(jcks, name), getattr(tcks, name), xyz, a,
                         mink)
        _close_nested(got, ref, f"{spin} {name}")


def test_geometry_cache_is_a_fresh_call():
    from athenak_tpu.athinput import ParameterInput as JaxInput
    from athenak_tpu.coordinates import GRGeometry as JaxGeometry
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.coordinates import (Coordinates, GRGeometry,
                                               excision_masks)
    from athenak_tpu_torch.mesh import Mesh
    from torch_deck_parity import deck_text

    over = ["mesh/nx1=12", "mesh/nx2=8", "mesh/nx3=8", "meshblock/nx1=6",
            "meshblock/nx2=8", "meshblock/nx3=4", "mesh/x1min=-3.3",
            "mesh/x1max=2.7", "mesh/x2min=-4", "mesh/x2max=4",
            "mesh/x3min=-3", "mesh/x3max=3"]
    pin = ParameterInput.from_string(deck_text(
        "inputs/grmhd/torus_sane.athinput"))
    pin.modify_from_cmdline(over)
    mesh = Mesh(pin)
    cd = Coordinates(pin).coord_data
    geom = GRGeometry(mesh, cd, "cpu", torch.float64)
    pos = {"cc": (geom.xc, geom.yc, geom.zc)}
    for where in ("x1", "x2", "x3"):
        x, y, z = (np.empty_like(c) for c in pos["cc"])
        for gid in range(mesh.nmb_total):
            e = mesh.face_edges(gid)
            c = mesh.cell_centers(gid)
            x[gid, 0, 0] = (e if where == "x1" else c)[0][:x.shape[-1]]
            y[gid, 0, :, 0] = (e if where == "x2" else c)[1][:y.shape[-2]]
            z[gid, :, 0, 0] = (e if where == "x3" else c)[2][:z.shape[-3]]
        pos[where] = (x, y, z)
    for where, xyz in pos.items():
        fresh = tcks.metric(*map(torch.from_numpy, xyz), cd.bh_spin)
        kept = geom.metric(where)
        for gk, gf in zip(kept, fresh):
            for i in range(4):
                for j in range(i, 4):
                    assert gk[i][j] is gk[j][i]
                    assert torch.equal(gk[i][j], gf[i][j].expand(
                        gk[i][j].shape)), (where, i, j)
    fresh = tcks.metric_derivatives(*map(torch.from_numpy, pos["cc"]),
                                    cd.bh_spin)
    for dk, df in zip(geom.metric_derivatives(), fresh):
        for i in range(4):
            for j in range(i, 4):
                assert torch.equal(dk[i][j], df[i][j].expand(
                    dk[i][j].shape))
    assert geom.nbytes() == 110 * 8 * geom.metric("cc")[0][0][0].numel()

    # the excision masks, as the JAX package builds them
    jpin = JaxInput.from_string(deck_text(
        "inputs/grmhd/torus_sane.athinput"))
    jpin.modify_from_cmdline(over)
    from athenak_tpu.coordinates import Coordinates as JaxCoordinates
    jmesh = JaxMesh(jpin)
    jgeom = JaxGeometry(jmesh, JaxCoordinates(jpin).coord_data)
    floor, flux = excision_masks(geom, mesh, "cpu")
    shape = tuple(floor.shape)
    np.testing.assert_array_equal(
        floor.numpy(), np.broadcast_to(jgeom.excision_floor_mask(), shape))
    near = np.broadcast_to(jgeom.ks_radius_cc(), shape) <= 1.0
    ref = near.copy()
    for ax in (1, 2, 3):
        ref |= np.roll(near, 1, axis=ax) | np.roll(near, -1, axis=ax)
    np.testing.assert_array_equal(flux.numpy(), ref)
    assert floor.any() and flux.sum() > floor.sum()


def _metrics(rng):
    xyz = _points(rng)
    gj = jcks.metric(*map(jnp.asarray, xyz), A)
    gt = tcks.metric(*map(torch.from_numpy, xyz), A)
    x, y, z = xyz
    rad2 = x * x + y * y + z * z
    rk = np.sqrt(0.5 * (rad2 - A * A + np.sqrt((rad2 - A * A) ** 2
                                               + 4 * A * A * z * z)))
    return gj, gt, rk <= 1.0


def _prims(rng):
    return np.concatenate([
        rng.uniform(0.01, 2.0, (SHAPE[0], 1) + SHAPE[1:]),
        rng.uniform(-3.0, 3.0, (SHAPE[0], 3) + SHAPE[1:]),
        rng.uniform(0.01, 2.0, (SHAPE[0], 1) + SHAPE[1:]),
        rng.uniform(0.0, 1.0, (SHAPE[0], 1) + SHAPE[1:])], axis=1)


@pytest.mark.parametrize("mhd", [False, True], ids=["hydro", "mhd"])
def test_c2p_p2c_match_jax(mhd):
    rng = np.random.default_rng(5)
    (glj, guj), (glt, gut), exc = _metrics(rng)
    je, te = jeos.EOSData(**EOS_KW), teos.EOSData(**EOS_KW)
    w = _prims(rng)
    bcc = rng.uniform(-1.0, 1.0, (SHAPE[0], 3) + SHAPE[1:])
    bj, bt = jnp.asarray(bcc), torch.from_numpy(bcc)
    if mhd:
        uj = jeg.prim_to_cons_gr_mhd(jnp.asarray(w), bj, je, glj, guj)
        ut = teg.prim_to_cons_gr_mhd(torch.from_numpy(w), bt, te, glt, gut)
    else:
        uj = jeg.prim_to_cons_gr_hydro(jnp.asarray(w), je, glj, guj)
        ut = teg.prim_to_cons_gr_hydro(torch.from_numpy(w), te, glt, gut)
    close(ut, uj, "p2c")
    # states for every fix: low density, low and negative energy, large
    # momenta (the ceiling) and non-finite momenta (a failed root find)
    u = np.array(uj)
    m = rng.random(SHAPE)
    u[:, 0] = np.where(m < 0.1, u[:, 0] * 0.01, u[:, 0])
    u[:, 4] = np.where((m > 0.1) & (m < 0.2), u[:, 4] * 0.001, u[:, 4])
    u[:, 4] = np.where((m > 0.2) & (m < 0.25), -u[:, 4], u[:, 4])
    u[:, 1] = np.where((m > 0.25) & (m < 0.3), u[:, 1] * 1e3, u[:, 1])
    u[:, 3] = np.where((m > 0.35) & (m < 0.38), np.nan, u[:, 3])
    kw = dict(dexcise=DEXCISE, pexcise=PEXCISE)
    if mhd:
        rj = jeg.cons_to_prim_gr_mhd(jnp.asarray(u), bj, je, glj, guj,
                                     excise_mask=jnp.asarray(exc), **kw)
        rt = teg.cons_to_prim_gr_mhd(torch.from_numpy(u), bt, te, glt, gut,
                                     excise_mask=torch.from_numpy(exc), **kw)
    else:
        rj = jeg.cons_to_prim_gr_hydro(jnp.asarray(u), je, glj, guj,
                                       excise_mask=jnp.asarray(exc), **kw)
        rt = teg.cons_to_prim_gr_hydro(torch.from_numpy(u), te, glt, gut,
                                       excise_mask=torch.from_numpy(exc),
                                       **kw)
    assert np.isfinite(rt[0].numpy()).all()
    close(rt[0], rj[0], "c2p w")
    close(rt[1], rj[1], "c2p u_fixed")
    assert set(rt[2]) == set(rj[2]) == {"neos_dfloor", "neos_efloor",
                                        "neos_vceil", "nc2p_fail"}
    for k in rj[2]:
        assert int(rt[2][k]) == int(rj[2][k]) > 0, k
    assert exc.any()
    np.testing.assert_array_equal(rt[0].numpy()[:, 0][exc], DEXCISE)


@pytest.mark.parametrize("ivx", [1, 2, 3])
@pytest.mark.parametrize("solver", ["llf", "hlle"])
def test_gr_solvers_match_jax(solver, ivx):
    rng = np.random.default_rng(11 + ivx)
    (glj, guj), (glt, gut), _ = _metrics(rng)
    je, te = jeos.EOSData(**EOS_KW), teos.EOSData(**EOS_KW)
    wl, wr = _prims(rng), _prims(rng)
    wr[:, :, :3] = wl[:, :, :3]              # equal states on some faces
    fj = jrg.GR_HYDRO_RSOLVER_FNS[solver](jnp.asarray(wl), jnp.asarray(wr),
                                          je, ivx, glj, guj)
    ft = trg.GR_HYDRO_RSOLVER_FNS[solver](torch.from_numpy(wl),
                                          torch.from_numpy(wr), te, ivx,
                                          glt, gut)
    close(ft, fj, f"gr {solver}")
    bl = rng.uniform(-1.0, 1.0, (SHAPE[0], 3) + SHAPE[1:])
    br = rng.uniform(-1.0, 1.0, bl.shape)
    bx = rng.uniform(-1.0, 1.0, (SHAPE[0],) + SHAPE[1:])
    args = (wl[:, :5], wr[:, :5], bl, br, bx)
    outj = jrgm.GR_MHD_RSOLVER_FNS[solver](*map(jnp.asarray, args), je, ivx,
                                           glj, guj)
    outt = trgm.GR_MHD_RSOLVER_FNS[solver](*map(torch.from_numpy, args), te,
                                           ivx, glt, gut)
    for name, a, b in zip(("flux", "ey", "ez"), outt, outj):
        close(a, b, f"grmhd {solver} {name}")
    assert set(trg.GR_HYDRO_RSOLVER_FNS) == set(jrg.GR_HYDRO_RSOLVER_FNS)
    assert set(trgm.GR_MHD_RSOLVER_FNS) == set(jrgm.GR_MHD_RSOLVER_FNS)


@pytest.mark.parametrize("mhd", [False, True], ids=["hydro", "mhd"])
def test_coord_src_terms_match_jax(mhd):
    """The coordinate source terms of one stage, each package's own
    (the JAX ``coord_src_terms`` methods) on one random state."""
    from athenak_tpu.athinput import ParameterInput as JaxInput
    from athenak_tpu.bvals import BoundaryValues as JaxBvals
    from athenak_tpu.mesh import Mesh as JaxMesh
    from athenak_tpu.physics.hydro import Hydro as JaxHydro
    from athenak_tpu.physics.mhd import MHD as JaxMHD
    from athenak_tpu_torch.athinput import ParameterInput
    from athenak_tpu_torch.bvals import BoundaryValues
    from athenak_tpu_torch.mesh import Mesh
    from athenak_tpu_torch.physics.hydro import Hydro
    from athenak_tpu_torch.physics.mhd import MHD
    from torch_deck_parity import deck_text

    text = deck_text("inputs/grmhd/torus_sane.athinput")
    if not mhd:
        text = text.replace("<mhd>", "<hydro>")
    over = ["mesh/nx1=8", "mesh/nx2=8", "mesh/nx3=8", "mesh/x1min=-3.3",
            "mesh/x1max=4.7", "mesh/x2min=-4", "mesh/x2max=4",
            "mesh/x3min=-4", "mesh/x3max=4"]
    jpin, tpin = JaxInput.from_string(text), ParameterInput.from_string(text)
    jpin.modify_from_cmdline(over)
    tpin.modify_from_cmdline(over)
    jm, tm = JaxMesh(jpin), Mesh(tpin)
    jp = (JaxMHD if mhd else JaxHydro)(jpin, jm, JaxBvals(jm))
    tp = (MHD if mhd else Hydro)(tpin, tm, BoundaryValues(tm), "cpu",
                                 torch.float64)
    rng = np.random.default_rng(19)
    mbi = tm.mb_indcs
    shp = (tm.nmb_total, 5, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    w = np.concatenate([rng.uniform(0.1, 1.0, (shp[0], 1) + shp[2:]),
                        rng.uniform(-0.5, 0.5, (shp[0], 3) + shp[2:]),
                        rng.uniform(0.1, 1.0, (shp[0], 1) + shp[2:])], axis=1)
    u = rng.normal(size=shp)
    bcc = rng.uniform(-1.0, 1.0, (shp[0], 3) + shp[2:])
    if mhd:
        ref = jp.coord_src_terms(jnp.asarray(u), jnp.asarray(w),
                                 jnp.asarray(bcc), 0.1)
        got = teg.coord_src_terms(torch.tensor(u), torch.from_numpy(w),
                                  tp.eos, tp.geom, 0.1,
                                  bcc=torch.from_numpy(bcc))
    else:
        ref = jp.coord_src_terms(jnp.asarray(u), jnp.asarray(w), 0.1)
        got = teg.coord_src_terms(torch.tensor(u), torch.from_numpy(w),
                                  tp.eos, tp.geom, 0.1)
    close(got - torch.from_numpy(u), np.asarray(ref) - u, "source")
