"""Output variables: the registry of the reference's ``var_choice``
names (reference: src/outputs/outputs.hpp:31-105,
src/outputs/derived_variables.cpp).

Counterpart of ``athenak_tpu/outputs/variables.py``.  ``resolve`` takes
every name the JAX package's ``resolve`` takes, in its order: the fluid's
conserved and primitive fields and their single channels, the passive
scalars, the cell-centred field, the temperature, vorticity, current,
|B|, div(B), the field-line curvatures, the 4-current ``jcon``, the
dynamo and subgrid-scale moments, the turbulence force, the particle
density, the gravitational potential, the Z4c, ADM, constraint, psi4 and
stress-energy fields, and the radiation moments.  Every name resolves to
the labels and a tensor [nmb, nvar, n3, n2, n1] (ghosts included) on the
state's device, computed there in torch ops; the writers move what they
write to the host.  The centred differences roll across the block, as
the JAX package's do: the ghost cells they wrap into are not written.
"""

from __future__ import annotations

import numpy as np
import torch

from ..indices import IDN, IEN, IVX, IVY, IVZ

Z4C_LABELS = [
    "z4c_chi",
    "z4c_gxx", "z4c_gxy", "z4c_gxz", "z4c_gyy", "z4c_gyz", "z4c_gzz",
    "z4c_Khat",
    "z4c_Axx", "z4c_Axy", "z4c_Axz", "z4c_Ayy", "z4c_Ayz", "z4c_Azz",
    "z4c_Gamx", "z4c_Gamy", "z4c_Gamz",
    "z4c_Theta", "z4c_alpha", "z4c_betax", "z4c_betay", "z4c_betaz"]

ADM_LABELS = [
    "adm_gxx", "adm_gxy", "adm_gxz", "adm_gyy", "adm_gyz", "adm_gzz",
    "adm_Kxx", "adm_Kxy", "adm_Kxz", "adm_Kyy", "adm_Kyz", "adm_Kzz",
    "adm_alpha", "adm_betax", "adm_betay", "adm_betaz"]

CON_NAMES = ("con", "con_C", "con_H", "con_M", "con_Z", "con_Mx",
             "con_My", "con_Mz")

TMUNU_LABELS = [
    "tmunu_Sxx", "tmunu_Sxy", "tmunu_Sxz", "tmunu_Syy", "tmunu_Syz",
    "tmunu_Szz", "tmunu_E", "tmunu_Sx", "tmunu_Sy", "tmunu_Sz"]

NAMES = tuple(["z4c"] + Z4C_LABELS + ["adm", "adm_psi4"] + ADM_LABELS
              + list(CON_NAMES) + ["weyl", "weyl_rpsi4", "weyl_ipsi4"]
              + ["tmunu"] + TMUNU_LABELS)


_HYDRO_U = ["dens", "mom1", "mom2", "mom3", "ener"]
_HYDRO_W = ["dens", "velx", "vely", "velz", "eint"]
FLUID_NAMES = ("hydro_u", "hydro_w", "mhd_u", "mhd_w", "mhd_u_bcc",
               "mhd_w_bcc", "mhd_bcc", "grav_phi", "hydro_t", "mhd_t")


def resolve_fluid(name: str, phys, state):
    """(labels, tensor) of a fluid output variable, as the JAX
    ``resolve`` gives them: the fluid channels of u or w (four under an
    isothermal EOS, scalars left out), with the cell-centred field for
    ``*_bcc``; ``mhd_bcc`` the field alone; ``grav_phi`` the potential of
    a fresh solve on the state (the JAX package's own file holds no cell
    data, ROADMAP F18); ``*_t`` the temperature of a dynamical-GRMHD
    state."""
    if name in ("hydro_t", "mhd_t"):
        return ["temp"], state["T"][:, None]
    if name == "grav_phi":
        return ["phi"], phys.pgrav.solve(state["u"], phys.bvals)
    if name == "mhd_bcc":
        return ["bcc1", "bcc2", "bcc3"], state["bcc"]
    if name not in FLUID_NAMES:
        raise KeyError(f"'{name}' is not a fluid output variable")
    key = name.split("_", 1)[1]
    nh = phys.nmhd if getattr(phys, "is_mhd", False) else phys.nhydro
    arr = state[key[0]]
    labels = (_HYDRO_U if key[0] == "u" else _HYDRO_W)[:nh]
    if key.endswith("_bcc"):
        return labels + ["bcc1", "bcc2", "bcc3"], torch.cat(
            [arr[:, :nh], state["bcc"].to(arr.dtype)], dim=1)
    return labels, arr[:, :min(nh, 5)]


RAD_NAMES = ("rad_coord", "rad_fluid", "rad_coord_fluid")


def fluid_name(name: str) -> str:
    """A radiation-coupled run's ``rad_hydro_*`` and ``rad_mhd_*`` are the
    fluid's own variables (reference: the rad_hydro_/rad_mhd_ rows)."""
    if name.startswith(("rad_hydro_", "rad_mhd_")):
        return name[4:]
    return name


def is_rad_variable(name: str) -> bool:
    return name in RAD_NAMES


def resolve_rad(name: str, phys, state):
    """(labels, tensor [nmb, 10 or 20, n3, n2, n1]) of the radiation
    moments R^{munu}: the coordinate frame (``rad_coord``), the fluid
    frame (``rad_fluid``, a coupled run only) or both (reference:
    derived_variables.cpp:1076-1260)."""
    if name not in RAD_NAMES:
        raise KeyError(f"'{name}' is not a radiation output variable")
    rad = getattr(phys, "rad", phys)
    i0 = state["i0"] if "i0" in state else state["u"]
    labels, parts = [], []
    if name in ("rad_coord", "rad_coord_fluid"):
        lc, mc = rad.coord_moments({"u": i0})
        labels += lc
        parts.append(mc)
    if name in ("rad_fluid", "rad_coord_fluid"):
        if rad is phys:
            raise ValueError(f"{name}: fluid-frame moments need a coupled "
                             "fluid")
        lf, mf = rad.fluid_moments(i0, state["w"])
        labels += lf
        parts.append(mf)
    return labels, parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def is_z4c_variable(name: str) -> bool:
    return name in NAMES


def resolve_z4c(name: str, phys, state):
    """(labels, tensor [nmb, nvar, n3, n2, n1]) of a Z4c output variable
    on the state's device; a name of another family raises KeyError.
    Under dynamical GRMHD the Z4c fields are the state's ``z``, the ADM
    fields the physics' ``adm_of`` (the evolved, fixed or prescribed
    spacetime) and ``tmunu`` the fluid's stress-energy on it."""
    if not is_z4c_variable(name):
        raise KeyError(f"'{name}' is not a Z4c output variable")
    z = state.get("z", state["u"])
    if name.startswith("tmunu"):
        tm = phys.set_tmunu(state["u"], state["w"], state["bcc"],
                            phys.adm_of(state))
        fields = tm["S_dd"] + [tm["E"]] + tm["S_d"]
        if name == "tmunu":
            return list(TMUNU_LABELS), torch.stack(fields, dim=1)
        i = TMUNU_LABELS.index(name)
        return [name], fields[i][:, None]
    if name == "z4c":
        return list(Z4C_LABELS), z[:, :len(Z4C_LABELS)]
    if name.startswith("z4c"):
        i = Z4C_LABELS.index(name)
        return [name], z[:, i:i + 1]
    if name.startswith("adm"):
        if hasattr(phys, "adm_of"):
            adm = phys.adm_of(state)
        else:
            from ..z4c.z4c import adm_from_z4c
            adm = adm_from_z4c(phys, z)
        fields = adm["g3d"] + adm["K_dd"] + [adm["alpha"]] + adm["beta_u"]
        if name == "adm":
            return list(ADM_LABELS), torch.stack(fields, dim=1)
        if name == "adm_psi4":
            # det(gamma)^(1/6) of the six-component metric (the JAX
            # package passes the list to its 3x3 determinant; ROADMAP F11)
            from ..z4c.ahf import _det6
            return ["adm_psi4"], (_det6(adm["g3d"]) ** (1.0 / 6.0))[:, None]
        i = ADM_LABELS.index(name)
        return [name], fields[i][:, None]
    # the constraints and psi4 of a dynamical-GRMHD run are its Z4c's
    phys = getattr(phys, "z4c", None) or phys
    if name.startswith("con"):
        if name == "con_H":
            H, _ = phys.adm_constraints(z)
            return ["con_H"], H[:, None]
        if name == "con_M":
            _, M2 = phys.adm_constraints(z)
            return ["con_M"], torch.sqrt(M2)[:, None]
        con = phys.adm_constraints(z, full=True)
        if name == "con_C":
            return ["con_C"], con["C"][:, None]
        if name == "con_Z":
            return ["con_Z"], con["Z"][:, None]
        if name in ("con_Mx", "con_My", "con_Mz"):
            a = {"con_Mx": 0, "con_My": 1, "con_Mz": 2}[name]
            return [name], con["M_d"][a][:, None]
        # the full monitor set (reference: z4c.hpp:61-67 I_CON_* order)
        fields = [con["C"], con["H"], torch.sqrt(con["M2"]),
                  con["Z"]] + list(con["M_d"])
        return (["con_C", "con_H", "con_M", "con_Z",
                 "con_Mx", "con_My", "con_Mz"], torch.stack(fields, dim=1))
    from ..z4c.weyl import weyl_scalars
    rp, ip = weyl_scalars(phys, z)
    if name == "weyl_rpsi4":
        return ["r_psi4"], rp[:, None]
    if name == "weyl_ipsi4":
        return ["i_psi4"], ip[:, None]
    return ["r_psi4", "i_psi4"], torch.stack([rp, ip], dim=1)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
def resolve(variable: str, phys, state, mesh):
    """(labels, tensor [nmb, nvar, n3, n2, n1]) of any output variable,
    ghosts included, on the state's device (the JAX package's
    ``resolve``).  ``rad_hydro_*`` and ``rad_mhd_*`` are the fluid's own
    names; an unknown name raises ValueError."""
    name = fluid_name(variable)
    if name in FLUID_NAMES:
        return resolve_fluid(name, phys, state)
    if name.startswith(("hydro_", "mhd_")):
        return _resolve_derived(variable, name, phys, state, mesh)
    if is_z4c_variable(name):
        return resolve_z4c(name, phys, state)
    if is_rad_variable(name):
        return resolve_rad(name, phys, state)
    if name == "turb_force":
        # the driver's force (the JAX package reads a "force" entry that
        # no state holds, ROADMAP F31)
        return ["force1", "force2", "force3"], state["turb_force"]
    if name == "prtcl_d":
        return ["prtcl_d"], _prtcl_density(phys, state, mesh)[:, None]
    raise ValueError(f"output variable '{variable}' unknown")


_SINGLE = {"u_d": ("u", IDN, "dens"), "u_m1": ("u", 1, "mom1"),
           "u_m2": ("u", 2, "mom2"), "u_m3": ("u", 3, "mom3"),
           "u_e": ("u", IEN, "ener"), "w_d": ("w", IDN, "dens"),
           "w_vx": ("w", IVX, "velx"), "w_vy": ("w", IVY, "vely"),
           "w_vz": ("w", IVZ, "velz"), "w_e": ("w", IEN, "eint")}


def _resolve_derived(variable, name, phys, state, mesh):
    """A ``hydro_*`` or ``mhd_*`` name outside FLUID_NAMES (which hold
    the JAX ``resolve``'s whole-family names; its other fluid names
    here, name for name)."""
    u, w, bcc = state.get("u"), state.get("w"), state.get("bcc")
    mbi = mesh.mb_indcs
    ndim = 3 if mbi.nx3 > 1 else (2 if mbi.nx2 > 1 else 1)
    phys_name, key = name.split("_", 1)
    if key in _SINGLE:
        arr, c, label = _SINGLE[key]
        return [label], state[arr][:, c:c + 1]
    if key in ("u_s", "w_s"):
        ns = phys.nscalars
        if ns == 0:
            raise ValueError(f"{variable}: no scalars configured")
        arr = u if key == "u_s" else w
        return ([f"s{i:02d}" for i in range(ns)],
                arr[:, phys.nvar - ns:phys.nvar])
    if key in ("bcc1", "bcc2", "bcc3"):
        i = int(key[-1]) - 1
        return [key], bcc[:, i:i + 1]
    if key in ("wz", "w2"):
        c1, c2, c3 = _curl_cc(w[:, IVX], w[:, IVY], w[:, IVZ], mesh, ndim)
        if key == "wz":
            return ["vort_z"], c3[:, None]
        return ["vort2"], (c1 * c1 + c2 * c2 + c3 * c3)[:, None]
    if key in ("jz", "j2"):
        c1, c2, c3 = _curl_cc(bcc[:, 0], bcc[:, 1], bcc[:, 2], mesh, ndim)
        if key == "jz":
            return ["curr_z"], c3[:, None]
        return ["curr2"], (c1 * c1 + c2 * c2 + c3 * c3)[:, None]
    if key == "bmag":
        return ["bmag"], torch.sqrt(
            bcc[:, 0] ** 2 + bcc[:, 1] ** 2 + bcc[:, 2] ** 2)[:, None]
    if key == "divb":
        return ["divb"], _divb_cc(state["bfc"], mesh)[:, None]
    if key in ("curv", "curv_alt", "k_jxb", "curv_perp"):
        return _mhd_curvature(key, bcc, mesh, ndim)
    if key == "jcon":
        return _mhd_jcon(phys, w, bcc, mesh, ndim)
    if key == "dynamo_ks":
        return _dynamo_ks(w, bcc, state["bfc"], mesh)
    if key == "sgs":
        return _sgs(phys_name, u, bcc)
    raise ValueError(f"output variable '{variable}' not implemented")


def _dx(mesh, d: int, like):
    """Each block's cell size along x<d>, [nmb, 1, 1, 1] in ``like``'s
    dtype and device."""
    return torch.as_tensor(np.asarray(mesh.mb_size[f"dx{d}"],
                                      dtype=np.float64),
                           dtype=like.dtype,
                           device=like.device).reshape(-1, 1, 1, 1)


def _curl_cc(v1, v2, v3, mesh, ndim):
    """Cell-centred curl by centred differences, valid in the interior
    (reference: derived_variables.cpp vorticity and current)."""
    dx1, dx2, dx3 = (_dx(mesh, d, v1) for d in (1, 2, 3))

    def d(f, ax, dx):
        return (torch.roll(f, -1, ax) - torch.roll(f, 1, ax)) / (2.0 * dx)

    c1 = d(v3, 2, dx2) - (d(v2, 1, dx3) if ndim == 3 else 0.0)
    c2 = (d(v1, 1, dx3) if ndim == 3 else 0.0) - d(v3, 3, dx1)
    c3 = d(v2, 3, dx1) - d(v1, 2, dx2)
    return c1, c2, c3


def _divb_cc(bfc, mesh):
    """div(B) of the face field in each cell; a collapsed axis (two
    faces) adds nothing."""
    x1f, x2f, x3f = bfc["x1f"], bfc["x2f"], bfc["x3f"]
    dx1, dx2, dx3 = (_dx(mesh, d, x1f) for d in (1, 2, 3))
    div = (x1f[..., 1:] - x1f[..., :-1]) / dx1
    if x2f.shape[2] > 2:
        div = div + (x2f[:, :, 1:, :] - x2f[:, :, :-1, :]) / dx2
    if x3f.shape[1] > 2:
        div = div + (x3f[:, 1:, :, :] - x3f[:, :-1, :, :]) / dx3
    return div


def _grad_cc(f, mesh, ndim):
    """Centred-difference gradient (d/dx1, d/dx2, d/dx3) of a
    cell-centred field, valid in the interior."""
    dx1, dx2, dx3 = (_dx(mesh, d, f) for d in (1, 2, 3))

    def d(ax, dx):
        return (torch.roll(f, -1, ax) - torch.roll(f, 1, ax)) / (2.0 * dx)

    return (d(3, dx1),
            d(2, dx2) if ndim >= 2 else torch.zeros_like(f),
            d(1, dx3) if ndim == 3 else torch.zeros_like(f))


def _mhd_curvature(key, bcc, mesh, ndim):
    """Field-line curvature diagnostics (reference:
    derived_variables.cpp:208-359,781-900): curv = |(B.grad B)_perp|/B^2,
    curv_alt = |bhat.grad bhat|, k_jxb = |J x B|/B^2, curv_perp =
    |J x B / B^2 - bhat.grad bhat|.  B^2 is floored at 1e-300, which is 0
    in float32: a cell with B = 0 gives NaN there (ROADMAP F29)."""
    bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]
    b2 = torch.clamp(bx * bx + by * by + bz * bz, min=1e-300)
    grads = [_grad_cc(c, mesh, ndim) for c in (bx, by, bz)]

    def bdotgrad(c):
        gx, gy, gz = grads[c]
        return bx * gx + by * gy + bz * gz

    if key == "curv":
        # (B.grad B) perpendicular to bhat, over B^2
        k = [bdotgrad(c) for c in range(3)]
        bdk = (bx * k[0] + by * k[1] + bz * k[2]) / b2
        p = [k[c] - bdk * (bx, by, bz)[c] for c in range(3)]
        val = torch.sqrt(p[0] ** 2 + p[1] ** 2 + p[2] ** 2) / b2
        return ["curv"], val[:, None]

    bmag = torch.sqrt(b2)
    ux, uy, uz = bx / bmag, by / bmag, bz / bmag
    ugrads = [_grad_cc(c, mesh, ndim) for c in (ux, uy, uz)]
    kappa = [ux * g[0] + uy * g[1] + uz * g[2] for g in ugrads]
    if key == "curv_alt":
        val = torch.sqrt(kappa[0] ** 2 + kappa[1] ** 2 + kappa[2] ** 2)
        return ["curv_alt"], val[:, None]

    # the current J = curl B, cell-centred
    j1, j2, j3 = _curl_cc(bx, by, bz, mesh, ndim)
    jxb = ((j2 * bz - j3 * by) / b2,
           (j3 * bx - j1 * bz) / b2,
           (j1 * by - j2 * bx) / b2)
    if key == "k_jxb":
        val = torch.sqrt(jxb[0] ** 2 + jxb[1] ** 2 + jxb[2] ** 2)
        return ["k_jxb"], val[:, None]
    val = torch.sqrt(sum((jxb[c] - kappa[c]) ** 2 for c in range(3)))
    return ["curv_perp"], val[:, None]


def _dynamo_ks(w, bcc, bfc, mesh):
    """Dynamo wavenumber-scale moments (reference:
    derived_variables.cpp:945-1040 mhd_dynamo_ks): 8 channels of B and U
    magnitudes and gradient contractions whose volume averages give the
    field's characteristic wavenumbers."""
    bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]
    b2 = bx * bx + by * by + bz * bz
    dx = _dx(mesh, 1, bx)
    dx2_sq = dx * dx

    def dc(f, ax):  # un-normalised centred difference (the reference's)
        return 0.5 * (torch.roll(f, -1, ax) - torch.roll(f, 1, ax))

    def df(face, ax):  # the face difference across the cell
        n = face.shape[ax]
        return face.narrow(ax, 1, n - 1) - face.narrow(ax, 0, n - 1)

    dbx = (df(bfc["x1f"], 3), dc(bx, 2), dc(bx, 1))
    dby = (dc(by, 3), df(bfc["x2f"], 2), dc(by, 1))
    dbz = (dc(bz, 3), dc(bz, 2), df(bfc["x3f"], 1))
    grad2 = sum(d ** 2 for trip in (dbx, dby, dbz) for d in trip) / dx2_sq
    bdb = [(bx * d[0] + by * d[1] + bz * d[2]) for d in (dbx, dby, dbz)]
    bdb2 = (bdb[0] ** 2 + bdb[1] ** 2 + bdb[2] ** 2) / dx2_sq
    jx = dc(bz, 2) - dc(by, 1)
    jy = dc(bx, 1) - dc(bz, 3)
    jz = dc(by, 3) - dc(bx, 2)
    bxj2 = ((by * jz - bz * jy) ** 2 + (bz * jx - bx * jz) ** 2
            + (bx * jy - by * jx) ** 2) / dx2_sq
    bdj2 = (bx * jx + by * jy + bz * jz) ** 2 / dx2_sq
    vx, vy, vz = w[:, IVX], w[:, IVY], w[:, IVZ]
    u2 = vx * vx + vy * vy + vz * vz
    du2 = sum(dc(v, ax) ** 2 for v in (vx, vy, vz)
              for ax in (3, 2, 1)) / dx2_sq
    labels = ["B2", "B4", "dB2", "BdB2", "BxJ2", "BdJ2", "U2", "dU2"]
    return labels, torch.stack(
        [b2, b2 * b2, grad2, bdb2, bxj2, bdj2, u2, du2], dim=1)


def _sgs(phys_name, u, bcc):
    """Subgrid-scale analysis products (reference:
    derived_variables.cpp:528-700 mhd_sgs/hydro_sgs): the state and
    every quadratic and cubic flux product of the SGS terms, 23 channels
    for hydro and 59 for MHD."""
    rho = u[:, IDN]
    mx, my, mz = u[:, 1], u[:, 2], u[:, 3]
    eint = u[:, IEN]
    chans = [rho, mx, my, mz, eint]
    labels = ["rho", "mx", "my", "mz", "eint"]
    if phys_name == "mhd":
        bx, by, bz = bcc[:, 0], bcc[:, 1], bcc[:, 2]
        chans += [bx, by, bz]
        labels += ["Bx", "By", "Bz"]
    ms = [mx, my, mz]
    mlab = ["x", "y", "z"]
    for a in range(3):
        for b in range(a, 3):
            chans.append(ms[a] * ms[b] / rho)
            labels.append(f"mv{mlab[a]}{mlab[b]}")
    if phys_name == "mhd":
        bs = [bx, by, bz]
        for a in range(3):
            for b in range(a, 3):
                chans.append(bs[a] * bs[b])
                labels.append(f"BB{mlab[a]}{mlab[b]}")
        for a in range(3):
            for b in range(3):
                chans.append(ms[a] * bs[b] / rho)
                labels.append(f"vB{mlab[a]}{mlab[b]}")
    for a in range(3):
        chans.append(ms[a] * eint / rho)
        labels.append(f"vT{mlab[a]}")
    for a in range(3):
        for b in range(3):
            chans.append(ms[a] * ms[b] * ms[b] / (rho * rho))
            labels.append(f"vvv{mlab[a]}{mlab[b]}")
    if phys_name == "mhd":
        for a in range(3):
            for b in range(3):
                chans.append(ms[a] * bs[b] * bs[b] / rho)
                labels.append(f"vBB{mlab[a]}{mlab[b]}")
        for a in range(3):
            for b in range(3):
                chans.append(ms[a] * bs[a] * bs[b] / rho)
                labels.append(f"vBiBj{mlab[a]}{mlab[b]}")
    return labels, torch.stack(chans, dim=1)


def _build_eps4():
    import itertools
    eps = np.zeros((4, 4, 4, 4))
    for p in itertools.permutations(range(4)):
        s = 1
        for i in range(4):
            for j in range(i + 1, 4):
                if p[i] > p[j]:
                    s = -s
        eps[p] = s
    return eps


_EPS4 = _build_eps4()


def _ucov_bcov(w, bcc, gl, gu):
    """Covariant 4-velocity and 4-magnetic field from the primitives
    (reference: ComputeUcBcFromPrimitive, derived_variables.cpp:36-70)."""
    uu = (w[:, IVX], w[:, IVY], w[:, IVZ])
    q = (gl[1][1] * uu[0] ** 2 + gl[2][2] * uu[1] ** 2
         + gl[3][3] * uu[2] ** 2
         + 2.0 * (gl[1][2] * uu[0] * uu[1] + gl[1][3] * uu[0] * uu[2]
                  + gl[2][3] * uu[1] * uu[2]))
    alp = torch.sqrt(-1.0 / gu[0][0])
    lor = torch.sqrt(1.0 + q)
    ucon = [lor / alp] + [uu[i] - alp * lor * gu[0][i + 1]
                          for i in range(3)]
    ucov = [sum(gl[m][n] * ucon[n] for n in range(4)) for m in range(4)]
    bb = (bcc[:, 0], bcc[:, 1], bcc[:, 2])
    b0 = sum(bb[i] * ucov[i + 1] for i in range(3))
    bcon = [b0] + [(bb[i] + b0 * ucon[i + 1]) / ucon[0]
                   for i in range(3)]
    bcov = [sum(gl[m][n] * bcon[n] for n in range(4)) for m in range(4)]
    return ucov, bcov


def _detg_fcon(mu, nu, ucov, bcov):
    """detg F^{mu nu} = -eps^{mu nu kap lam} u_kap b_lam (reference:
    utils/current.hpp get_detg_Fcon)."""
    out = 0.0
    for kap in range(4):
        for lam in range(4):
            s = float(_EPS4[mu, nu, kap, lam])
            if s:
                out = out - s * ucov[kap] * bcov[lam]
    return out


def _rolled(g, shift, ax):
    """A metric table rolled along a cell axis (its constants as they
    are)."""
    return [[torch.roll(c, shift, ax) if torch.is_tensor(c) and c.dim() >= 3
             else c for c in row] for row in g]


def _mhd_jcon(phys, w, bcc, mesh, ndim):
    """Contravariant 4-current j^mu = (1/(detg sqrt(4pi))) d_nu (detg
    F^{nu mu}) with a time-centred Faraday tensor (reference:
    derived_variables.cpp:364-527 'mhd_jcon').  It reads the previous
    cycle's (w, bcc, dt) that the driver keeps (``Driver.save_wbcc``);
    without one (or with one of another tree) it is zero, as the
    reference's have_prior=False branch.
    A GR run reads the whole mesh's metric (``GRGeometry.metric``
    outside a rank's cycle)."""
    if getattr(phys, "is_gr", False):
        gl, gu = phys.geom.metric("cc")
    else:
        z = torch.zeros_like(w[:, 0])
        eta = [-1.0, 1.0, 1.0, 1.0]
        gl = [[(eta[i] + z) if i == j else z for j in range(4)]
              for i in range(4)]
        gu = gl
    prev = getattr(phys, "_jcon_prev", None)
    labels = ["j0", "j1", "j2", "j3"]
    if prev is not None and prev[0].shape != w.shape:
        prev = None     # kept on the tree before an AMR update
    if prev is None:
        zero = torch.zeros_like(w[:, :1])
        return labels, torch.cat([zero] * 4, dim=1)
    w_old, bcc_old, dt_last = prev

    uc_new, bc_new = _ucov_bcov(w, bcc, gl, gu)
    uc_old, bc_old = _ucov_bcov(w_old, bcc_old, gl, gu)
    w_mid = 0.5 * (w + w_old)
    b_mid = 0.5 * (bcc + bcc_old)

    dxs = [_dx(mesh, d, w) for d in (1, 2, 3)]
    # alpha sqrt(det g_ij) = sqrt(-g)
    detg = torch.sqrt(-1.0 / gu[0][0]) * torch.sqrt(_det3(gl))

    axes = [3, 2, 1][:ndim]
    out = []
    for mu in range(4):
        j = (_detg_fcon(mu, 0, uc_new, bc_new)
             - _detg_fcon(mu, 0, uc_old, bc_old)) / dt_last
        for d, ax in enumerate(axes):
            # the time-centred fields and the metric at the shifted
            # cells, u and b evaluated there
            glp, glm = _rolled(gl, -1, ax), _rolled(gl, 1, ax)
            gup, gum = _rolled(gu, -1, ax), _rolled(gu, 1, ax)
            wp = torch.roll(w_mid, -1, ax + 1)
            wm = torch.roll(w_mid, 1, ax + 1)
            bp = torch.roll(b_mid, -1, ax + 1)
            bm = torch.roll(b_mid, 1, ax + 1)
            ucp, bcp = _ucov_bcov(wp, bp, glp, gup)
            ucm, bcm = _ucov_bcov(wm, bm, glm, gum)
            j = j + (_detg_fcon(mu, d + 1, ucp, bcp)
                     - _detg_fcon(mu, d + 1, ucm, bcm)) / (2.0 * dxs[d])
        out.append(j / (detg * float(np.sqrt(4.0 * np.pi))))
    return labels, torch.stack(out, dim=1)


def _det3(gl):
    """The determinant of the spatial part of a 4x4 metric table."""
    a, b, c = gl[1][1], gl[1][2], gl[1][3]
    d, e = gl[2][2], gl[2][3]
    f = gl[3][3]
    return a * (d * f - e * e) - b * (b * f - e * c) \
        + c * (b * e - d * c)


def _prtcl_density(phys, state, mesh):
    """Particle number density, deposited nearest-grid-point onto each
    particle's owner block (reference: the 'prtcl_d' row,
    outputs.hpp:151-152).  The cell and its volume are the owner block's
    (``mb_size``): the JAX package takes the root grid's, which puts a
    refined block's particles into the wrong cells (ROADMAP F30); on a
    uniform mesh the two agree."""
    mbi = mesh.mb_indcs
    x = state["prtcl_x"]
    dev = x.device
    gid = torch.as_tensor(np.asarray(phys.ppart.gids(x), dtype=np.int64),
                          device=dev)
    sz = mesh.mb_size

    def table(keys):
        return torch.as_tensor(np.stack([np.asarray(sz[k], dtype=np.float64)
                                         for k in keys], axis=1),
                               dtype=x.dtype, device=dev)

    lo = table(("x1min", "x2min", "x3min"))[gid]
    dxs = table(("dx1", "dx2", "dx3"))
    nx = torch.tensor([mbi.nx1 - 1, max(mbi.nx2, 1) - 1,
                       max(mbi.nx3, 1) - 1], device=dev)
    ijk = torch.minimum(torch.clamp(((x - lo) / dxs[gid]).to(torch.int64),
                                    min=0), nx)
    shape = (mesh.nmb_total, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    off = (mbi.is_, mbi.js if mbi.nx2 > 1 else 0,
           mbi.ks if mbi.nx3 > 1 else 0)
    flat = ((gid * shape[1] + ijk[:, 2] + off[2]) * shape[2]
            + ijk[:, 1] + off[1]) * shape[3] + ijk[:, 0] + off[0]
    dens = torch.bincount(flat, minlength=int(np.prod(shape))).to(x.dtype)
    vol = dxs[:, 0] * (dxs[:, 1] if mbi.nx2 > 1 else 1.0) \
        * (dxs[:, 2] if mbi.nx3 > 1 else 1.0)
    return dens.reshape(shape) / vol.reshape(-1, 1, 1, 1)
