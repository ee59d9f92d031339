"""Magnetised star-disk interaction: a Keplerian disk and a stellar
dipole magnetosphere, with orbiting planets.

Counterpart of ``athenak_tpu/pgen/disk_magnetosphere.py`` (reference:
src/pgen/fluids/disk-magnetosphere.cpp, the Cartesian branch):

  * a Keplerian disk with a power-law surface density and temperature
    and vertical hydrostatic structure (DenProfileCyl:725-765), whose
    magnetospheric cavity inside rmagsph holds a hydrostatic stellar
    atmosphere marched outward from denstar (dr = rs / 100, vectorised
    over the cavity's cells as in the JAX package);
  * the stellar dipole B = curl A on the staggered mesh (A1/A2:822-848);
  * the source-term hook (``srcterms_func``, ``needs_time``: the planets
    orbit with the time the state carries in ``t``): smoothed stellar
    gravity, the interior reset inside rfix, beta cooling toward the
    initial temperature, the radius-dependent density floor, and
    circular-orbit planets with softened gravity and a sin^2 mass ramp
    over insert_time orbits (StarSourceTerms:1253-1316,
    Cooling:1518-1542, orbit:1497-1514);
  * "steady" user boundaries: the ghosts of the ``user`` sides pinned to
    the initial state (DiskInnerX1..DiskOuterX3:880-1240);
  * per-planet history columns: the orbit and the Hill-masked force
    integrals (PlanetForce, the 14 enrolled outputs:346-380).

The profiles are host numpy tables moved to the device once.  The JAX
package's state carries no ``t`` (its driver advances one only when the
state has it), so its planets never act there and its history hook has
no time to read; the port's state carries ``t`` from the start.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..comm import local_blocks, local_tree
from ..indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ
from . import state_from_prims, to_device


def _params(pin, phys):
    is_ideal = phys.eos.is_ideal
    p = dict(
        gm0=pin.get_or_add_real("problem", "GM", 0.0),
        r0=pin.get_or_add_real("problem", "r0", 1.0),
        rho0=pin.get_real("problem", "rho0"),
        dslope=pin.get_or_add_real("problem", "dslope", 0.0),
        tcool=pin.get_or_add_real("problem", "tcool", 0.0),
        rho_floor0=pin.get_real("problem", "rho_floor0"),
        slope_rho_floor=pin.get_or_add_real("problem",
                                            "slope_rho_floor", 0.0),
        rs=pin.get_or_add_real("problem", "rsmooth", 0.0),
        rfix=pin.get_or_add_real("problem", "rfix", 0.1),
        smoothin=pin.get_or_add_real("problem", "smoothin", 0.0),
        smoothtr=pin.get_or_add_real("problem", "smoothtr", 0.0),
        rrigid=pin.get_or_add_real("problem", "rrigid", 0.0),
        origid=pin.get_or_add_real("problem", "origid", 0.0),
        rmagsph=pin.get_or_add_real("problem", "rmagsph", 0.0),
        denstar=pin.get_or_add_real("problem", "denstar", 0.0),
        ratmagfloor=pin.get_or_add_real("problem", "ratmagfloor", 1.0e6),
        ratmagfslope=pin.get_or_add_real("problem", "ratmagfslope", 5.5),
        insert_time=pin.get_or_add_real("problem", "insert_time", 5.0),
    )
    if is_ideal:
        p["p0_over_r0"] = pin.get_or_add_real("problem", "p0_over_r0",
                                              0.0025)
        p["pslope"] = pin.get_or_add_real("problem", "pslope", 0.0)
    else:
        p["p0_over_r0"] = phys.eos.iso_cs ** 2
        p["pslope"] = 0.0
    p["gamma"] = phys.eos.gamma
    if phys.is_mhd:
        p["beta"] = pin.get_real("problem", "beta")
        p["mm"] = pin.get_or_add_real("problem", "mm", 0.0)
        p["b0"] = math.sqrt(2.0 * p["p0_over_r0"] * p["rho0"] / p["beta"])
    else:
        p["beta"], p["mm"], p["b0"] = 1.0, 0.0, 0.0
    p["dfloor"] = pin.get_or_add_real(
        "mhd" if phys.is_mhd else "hydro", "dfloor",
        1024 * float(np.finfo(np.float32).tiny))
    return p


def _pover_r(rad, p):
    r = np.maximum(rad, p["rfix"])
    return p["p0_over_r0"] * (r / p["r0"]) ** p["pslope"]


def _rho_floor(rc, p):
    fl = np.where(rc > p["rs"],
                  p["rho_floor0"] * (rc / p["r0"]) ** p["slope_rho_floor"],
                  0.0)
    if p["mm"] != 0.0:
        fl = fl + np.where(
            rc > p["rs"],
            4.0 * p["rho0"] * p["mm"] ** 2 / p["beta"] / p["ratmagfloor"]
            * (p["r0"] / rc) ** p["ratmagfslope"], 0.0)
    return np.maximum(fl, p["dfloor"])


def _den_profile(rad, z, p):
    """DenProfileCyl (disk-magnetosphere.cpp:725-765), vectorised; returns
    (the floored density, the raw profile)."""
    r = np.maximum(rad, p["rs"])
    p_over_r = _pover_r(r, p)
    denmid = p["rho0"] * (r / p["r0"]) ** p["dslope"]
    den = denmid * np.exp(p["gm0"] / p_over_r
                          * (1.0 / np.sqrt(r * r + z * z) - 1.0 / r))
    rc = np.sqrt(rad * rad + z * z)
    if p["rmagsph"] > 0.0:
        sinsq = rad * rad / np.maximum(rc * rc, 1e-300)
        den = np.where(rc < p["rmagsph"],
                       den * np.exp(-((rc - p["rmagsph"])
                                      / p["smoothtr"]) ** 2), den)
        # the hydrostatic stellar atmosphere: the reference's midpoint
        # march in rint, every cell on the same grid with a mask
        por_s = float(np.asarray(_pover_r(np.asarray(p["rs"]), p)))
        dr = p["rs"] / 100.0
        pre = np.full(rc.shape, p["denstar"] * por_s)
        rint = 0.0
        while rint < p["rmagsph"]:
            act = rint < rc
            if rint < p["rs"]:
                dpre = dr * p["origid"] ** 2 * rint * sinsq * pre / por_s
            else:
                sm = (rint - p["smoothin"]) ** 2
                dpre = (-dr * p["gm0"] / rint ** 2
                        * sm / (sm + p["smoothtr"] ** 2) * pre / por_s
                        + dr * p["origid"] ** 2 * rint * sinsq
                        * pre / por_s)
            pre = np.where(act, pre + dpre, pre)
            rint += dr
        den = np.where(rc < p["rmagsph"], den + pre / por_s, den)
    return np.maximum(den, _rho_floor(rc, p)), den


def _vel_profile(rad, z, X, Y, p):
    """VelProfileCyl (disk-magnetosphere.cpp:780-812), Cartesian."""
    r = np.maximum(rad, p["rs"])
    p_over_r = _pover_r(r, p)
    vel2 = ((p["dslope"] + p["pslope"]) * p_over_r / (p["gm0"] / r)
            + (1.0 + p["pslope"])
            - p["pslope"] * r / np.sqrt(r * r + z * z))
    vel = np.sqrt(p["gm0"] / r) * np.sqrt(np.maximum(vel2, 0.0))
    rc = np.sqrt(rad * rad + z * z)
    if p["rmagsph"] > 0.0:
        vel = np.where(rc < p["rmagsph"],
                       vel * np.exp(-((rc - p["rmagsph"])
                                      / p["smoothtr"]) ** 2), vel)
    if p["rrigid"] > 0.0:
        vel = np.where(rc <= p["rrigid"], vel + p["origid"] * rad, vel)
    phi = np.arctan2(Y, X)
    return -vel * np.sin(phi), vel * np.cos(phi), np.zeros_like(vel)


def _dipole_a(x, y, z, p):
    """(A1, A2) of the stellar dipole (disk-magnetosphere.cpp:822-848)."""
    rc = np.maximum(np.sqrt(x * x + y * y + z * z), p["rs"] / 2.0)
    coef = p["mm"] * p["b0"] / rc ** 3
    return -coef * y, coef * x


class _Planets:
    """Circular-orbit planets (PlanetarySystem,
    disk-magnetosphere.cpp:94-140, orbit:1497-1514)."""

    def __init__(self, pin, gm0, insert_time) -> None:
        self.np_ = pin.get_or_add_integer("planets", "np", 0) \
            if pin.does_block_exist("planets") else 0
        self.gm0 = gm0
        self.insert_time = insert_time
        self.rsoft2 = pin.get_or_add_real("planets", "rsoft2", 0.0016) \
            if self.np_ else 0.0
        self.massset, self.x0, self.y0, self.z0 = [], [], [], []
        for ip in range(self.np_):
            self.massset.append(pin.get_or_add_real(
                "planets", f"mass{ip}", 1.0e-2))
            self.x0.append(pin.get_or_add_real("planets", f"x{ip}", 1.0))
            self.y0.append(pin.get_or_add_real("planets", f"y{ip}", 0.0))
            self.z0.append(pin.get_or_add_real("planets", f"z{ip}", 0.0))

    def state_at(self, t):
        """(mass, xp, yp, zp) of each planet at the time ``t`` (a 0-d
        tensor; orbit())."""
        out = []
        for ip in range(self.np_):
            ms = self.massset[ip]
            ramp = torch.sin(t / self.insert_time / 4.0) ** 2
            mass = torch.where(t < self.insert_time * 2.0 * math.pi,
                               ms * ramp, torch.full_like(t, ms))
            dis = math.sqrt(self.x0[ip] ** 2 + self.y0[ip] ** 2)
            ang = math.sqrt((self.gm0 + ms) / dis ** 3) * t
            out.append((mass, dis * torch.cos(ang), dis * torch.sin(ang),
                        self.z0[ip]))
        return out


def init(pin, mesh, phys):
    p = _params(pin, phys)
    is_mhd = phys.is_mhd
    is_ideal = phys.eos.is_ideal
    gm1 = p["gamma"] - 1.0
    psys = _Planets(pin, p["gm0"], p["insert_time"])

    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()} \
        if is_mhd else None
    shape = (nmb, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    xc_t, yc_t, zc_t = np.zeros(shape), np.zeros(shape), np.zeros(shape)
    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        x1f, x2f, x3f = mesh.face_edges(gid)
        X3, X2, X1 = np.meshgrid(x3v, x2v, x1v, indexing="ij")
        xc_t[gid], yc_t[gid], zc_t[gid] = X1, X2, X3
        rad = np.sqrt(X1 ** 2 + X2 ** 2)
        den, den_raw = _den_profile(rad, X3, p)
        v1, v2, v3 = _vel_profile(rad, X3, X1, X2, p)
        # floor-dominated cells carry no orbital flow (the JAX package's
        # quiet start)
        quiet = den_raw < _rho_floor(np.sqrt(rad * rad + X3 * X3), p)
        w[gid, IDN] = den
        w[gid, IVX] = np.where(quiet, 0.0, v1)
        w[gid, IVY] = np.where(quiet, 0.0, v2)
        w[gid, IVZ] = np.where(quiet, 0.0, v3)
        if is_ideal:
            w[gid, IEN] = _pover_r(rad, p) * den / gm1
        if is_mhd and p["mm"] != 0.0:
            # B = curl A on the faces from A on the edges (SetBfield)
            dx1 = x1v[1] - x1v[0]
            dx2 = x2v[1] - x2v[0]
            dx3 = x3v[1] - x3v[0] if mbi.nx3 > 1 else 1.0
            E3, E2, E1 = np.meshgrid(x3f, x2f, x1v, indexing="ij")
            a1 = _dipole_a(E1, E2, E3, p)[0]
            E3, E2, E1 = np.meshgrid(x3f, x2v, x1f, indexing="ij")
            a2 = _dipole_a(E1, E2, E3, p)[1]
            b1 = np.zeros((mbi.ncells3, mbi.ncells2, mbi.ncells1 + 1))
            b2 = np.zeros((mbi.ncells3, mbi.ncells2 + 1, mbi.ncells1))
            b3 = np.zeros((mbi.ncells3 + 1, mbi.ncells2, mbi.ncells1))
            if mbi.nx3 > 1:
                b1[:] = -(a2[1:, :, :] - a2[:-1, :, :]) / dx3
                b2[:] = (a1[1:, :, :] - a1[:-1, :, :]) / dx3
                b3[:] = ((a2[:, :, 1:] - a2[:, :, :-1]) / dx1
                         - (a1[:, 1:, :] - a1[:, :-1, :]) / dx2)
            else:
                b3[0] = ((a2[0, :, 1:] - a2[0, :, :-1]) / dx1
                         - (a1[0, 1:, :] - a1[0, :-1, :]) / dx2)
                b3[1] = b3[0]
            bfc["x1f"][gid], bfc["x2f"][gid], bfc["x3f"][gid] = b1, b2, b3

    # the initial-state tables of the source terms, on the device
    den0 = w[:, IDN].copy()
    mom0 = np.stack([w[:, IVX] * den0, w[:, IVY] * den0,
                     w[:, IVZ] * den0], axis=1)
    rad_t = np.sqrt(xc_t ** 2 + yc_t ** 2)
    por0 = _pover_r(rad_t, p)
    rc_tab = np.sqrt(xc_t ** 2 + yc_t ** 2 + zc_t ** 2)
    sm2 = (rc_tab - p["smoothin"]) ** 2
    fsm = np.where(rc_tab < p["smoothin"], 0.0,
                   sm2 / (sm2 + p["smoothtr"] ** 2))
    gcoe = -p["gm0"] / np.maximum(rc_tab, 1e-12) ** 3 * fsm
    dev = dev_all = {k: to_device(phys, v) for k, v in (
        ("gx", gcoe * xc_t), ("gy", gcoe * yc_t), ("gz", gcoe * zc_t),
        ("xc", xc_t), ("yc", yc_t), ("zc", zc_t), ("d0", den0),
        ("m0", mom0), ("por", por0), ("floor", _rho_floor(rc_tab, p)))}
    dev["fix"] = torch.as_tensor(rc_tab < p["rfix"], device=phys.device)
    if is_ideal:
        dev["e0"] = to_device(phys, por0 * den0 / gm1)
        dev["omk"] = torch.sqrt(p["gm0"] / torch.clamp(
            torch.sqrt(dev["xc"] ** 2 + dev["yc"] ** 2),
            min=p["rfix"]) ** 3)

    def srcterms(u, wprim, beta_dt, bcc=None, t=None):
        """AllSourceTerms: the star, the planets, the rfix reset, the
        cooling and the floors.  The tables are the running cycle's
        rows (JAX disk_magnetosphere.py:304)."""
        dev = local_tree(dev_all)
        u = u.clone()
        den = u[:, IDN].clone()
        ss = [beta_dt * den * dev[c] for c in ("gx", "gy", "gz")]
        for s, im in zip(ss, (IM1, IM2, IM3)):
            u[:, im] += s
        if is_ideal:
            u[:, IEN] += (ss[0] * wprim[:, IVX] + ss[1] * wprim[:, IVY]
                          + ss[2] * wprim[:, IVZ])
        # the planets: softened gravity at the orbit's position
        if psys.np_ > 0 and t is not None:
            rsoft = math.sqrt(psys.rsoft2)
            for mass, xp, yp, zp in psys.state_at(t):
                ddx, ddy, ddz = dev["xc"] - xp, dev["yc"] - yp, \
                    dev["zc"] - zp
                dist = torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz)
                coe = torch.where(
                    dist >= rsoft, -mass / torch.clamp(dist, min=1e-12) ** 3,
                    mass / psys.rsoft2 / rsoft * (3.0 * dist / rsoft - 4.0))
                fs = [beta_dt * den * coe * dd for dd in (ddx, ddy, ddz)]
                for f, im in zip(fs, (IM1, IM2, IM3)):
                    u[:, im] += f
                if is_ideal:
                    u[:, IEN] += (fs[0] * wprim[:, IVX] + fs[1] * wprim[:, IVY]
                                  + fs[2] * wprim[:, IVZ])
        # the interior reset inside rfix (StarSourceTerms:1291-1310)
        fm = dev["fix"]
        u[:, IDN] = torch.where(fm, dev["d0"], u[:, IDN])
        for c, im in enumerate((IM1, IM2, IM3)):
            u[:, im] = torch.where(fm, dev["m0"][:, c], u[:, im])
        if is_ideal:
            efix = dev["e0"] + 0.5 * torch.sum(dev["m0"] * dev["m0"], dim=1) \
                / torch.clamp(dev["d0"], min=1e-300)
            if bcc is not None:
                efix = efix + 0.5 * torch.sum(bcc * bcc, dim=1)
            u[:, IEN] = torch.where(fm, efix, u[:, IEN])
        # beta cooling toward the initial temperature (Cooling)
        if is_ideal and p["tcool"] > 0.0:
            eint = u[:, IEN] - 0.5 * (u[:, IM1] ** 2 + u[:, IM2] ** 2
                                      + u[:, IM3] ** 2) / u[:, IDN]
            if bcc is not None:
                eint = eint - 0.5 * torch.sum(bcc * bcc, dim=1)
            dtr = torch.clamp(p["tcool"] * 2.0 * math.pi / dev["omk"],
                              min=beta_dt)
            de = eint - dev["por"] / gm1 * u[:, IDN]
            u[:, IEN] += -de * beta_dt / dtr
        # the radius-dependent density floor
        u[:, IDN] = torch.maximum(u[:, IDN], dev["floor"])
        return u

    srcterms.needs_bcc = is_mhd
    srcterms.needs_time = True
    phys.srcterms_func = srcterms

    state = state_from_prims(phys, w, bfc)
    state["t"] = torch.zeros((), dtype=phys.dtype, device=phys.device)

    # the "steady" user boundaries: ghosts pinned to their initial values
    gmask = np.zeros((nmb, 1, mbi.ncells3, mbi.ncells2, mbi.ncells1),
                     dtype=bool)
    ng = mbi.ng
    for ax, a5, n in (("x1", 4, mbi.ncells1), ("x2", 3, mbi.ncells2),
                      ("x3", 2, mbi.ncells3)):
        for side in ("m", "p"):
            if mesh.mesh_bcs[("i" if side == "m" else "o") + ax] != "user":
                continue
            for gid in np.where(mesh.phys_bc_mask[f"{ax}{side}"])[0]:
                sl = [slice(None)] * 5
                sl[0] = gid
                sl[a5] = slice(0, ng) if side == "m" else slice(n - ng, n)
                gmask[tuple(sl)] = True
    gmask_t = torch.as_tensor(gmask, device=phys.device)
    u_init = state["u"].clone()

    def steady_bc(u, bv):
        return torch.where(local_blocks(gmask_t),
                           local_blocks(u_init), u, out=u)

    steady_bc.shard_safe = True
    phys.bvals.user_bc_func = steady_bc

    if psys.np_ > 0:
        _enroll_planet_hist(phys, mesh, p, psys, xc_t, yc_t, zc_t)
    return state


def _enroll_planet_hist(phys, mesh, p, psys, xc_t, yc_t, zc_t):
    """The per-planet history columns: the orbit and the Hill-masked
    force integrals (PlanetForce; the reference's 14 columns a planet),
    on the host like every history hook."""
    from .errors import host

    mbi = mesh.mb_indcs
    vol = float(mesh.mesh_size.dx1 * mesh.mesh_size.dx2
                * mesh.mesh_size.dx3)
    act = (slice(None), slice(mbi.ks, mbi.ke + 1),
           slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    xc, yc, zc = xc_t[act], yc_t[act], zc_t[act]
    rst = np.sqrt(xc * xc + yc * yc + zc * zc)

    def planet_hist(mesh_now, state):
        t = float(state["t"])
        dens_all = host(state["u"][:, IDN])[act]
        labels, vals = [], []
        for ip in range(psys.np_):
            ms = psys.massset[ip]
            if t < psys.insert_time * 2.0 * math.pi:
                mass = ms * math.sin(t / psys.insert_time / 4.0) ** 2
            else:
                mass = ms
            dis = math.sqrt(psys.x0[ip] ** 2 + psys.y0[ip] ** 2)
            ome = math.sqrt((p["gm0"] + ms) / dis ** 3)
            xp, yp, zp = dis * math.cos(ome * t), dis * math.sin(ome * t), \
                psys.z0[ip]
            ddx, ddy, ddz = xc - xp, yc - yp, zc - zp
            dist = np.sqrt(ddx ** 2 + ddy ** 2 + ddz ** 2)
            rsoft = math.sqrt(psys.rsoft2)
            coe = np.where(dist >= rsoft,
                           -mass / np.maximum(dist, 1e-12) ** 3,
                           mass / psys.rsoft2 / rsoft
                           * (3.0 * dist / rsoft - 4.0))
            rpp = math.sqrt(xp * xp + yp * yp + zp * zp)
            rh = rpp * (mass / 3.0 / max(p["gm0"], 1e-12)) ** (1.0 / 3.0)
            dens = np.where((dist < rh) | (rst < 2.5 * p["rs"]), 0.0,
                            dens_all)
            fx = float((coe * ddx * vol * dens).sum())
            fy = float((coe * ddy * vol * dens).sum())
            fz = float((coe * ddz * vol * dens).sum())
            phip = math.atan2(yp, xp)
            labels += [f"{nm}{ip}" for nm in
                       ("fr", "ft", "fp", "fxpp", "fypp", "fzpp", "torque",
                        "xpp", "ypp", "zpp", "rpp", "tpp", "ppp", "mp")]
            vals += [fx * math.cos(phip) + fy * math.sin(phip),
                     -fx * math.sin(phip) + fy * math.cos(phip), fz, fx, fy,
                     fz, xp * fy - yp * fx, xp, yp, zp, rpp,
                     math.acos(min(max(zp / rpp, -1.0), 1.0)), phip, mass]
        return labels, vals

    phys.user_hist_func = planet_hist
