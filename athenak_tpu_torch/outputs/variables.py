"""Output variables: the fluid's conserved and primitive fields, the
cell-centred field, the gravitational potential, the temperature of a
dynamical-GRMHD run, the Z4c fields, ADM fields, constraint monitors and
psi4, the fluid's stress-energy, and the radiation moments.

Counterpart of ``athenak_tpu/outputs/variables.py`` for these names
(reference: the ``var_choice`` rows of src/outputs/outputs.hpp:31-105):
every name resolves to the labels and a tensor [nmb, nvar, n3, n2, n1]
on the state's device, of which the writers move only the interior to
the host.  The other hydro and MHD derived variables are not ported yet
(ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import torch

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
