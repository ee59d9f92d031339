"""GR split monopole (Blandford-Znajek) test.

Counterpart of ``athenak_tpu/pgen/gr_monopole.py`` (reference:
src/pgen/tests/gr_monopole.cpp): the BZ77 split monopole around a
spinning black hole in Cartesian Kerr-Schild coordinates, a power-law
atmosphere, A_phi = a_norm (1 - cos theta_ks) transformed to CKS with a
sin(pi r^2 / 2) ramp inside r < 1, and B = curl A on the staggered mesh.
``final`` measures the field rotation rate Omega / Omega_H on a geodesic
sphere at the horizon and writes ``<basename>-diag.dat`` (BZ value 0.5).
The reference's ReflectingMonopole boundary is the ``diode`` flag here,
as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IM1, IM2, IM3
from . import state_from_prims
from .gr_bondi import host_metric


def _ks_coords(x, y, z, spin):
    """Cartesian -> spherical Kerr-Schild (r, theta, phi, |x|)
    (GetKerrSchildCoordinates)."""
    rad = np.sqrt(x * x + y * y + z * z)
    z = np.where((rad < 1.0) & (np.abs(z) < 1.0e-5), 1.0e-5, z)
    rad = np.sqrt(x * x + y * y + z * z)
    r = np.sqrt(rad ** 2 - spin ** 2 + np.sqrt(
        (rad ** 2 - spin ** 2) ** 2 + 4.0 * spin ** 2 * z ** 2)) \
        / math.sqrt(2.0)
    r = np.maximum(r, 1e-12)
    theta = np.arccos(np.clip(z / r, -1.0, 1.0))
    phi = np.arctan2(r * y - spin * x, spin * y + r * x)
    return r, theta, phi, rad


def _a_cks(which, a_norm, spin, x, y, z):
    """CKS component ``which`` of A = a_norm (1 - cos theta) dphi_ks with
    the r < 1 ramp (gr_monopole.cpp A1/A2/A3)."""
    r, theta, _, rad = _ks_coords(x, y, z, spin)
    zs = np.where((rad < 1.0) & (np.abs(z) < 1.0e-5), 1.0e-5, z)
    aphi = a_norm * (1.0 - np.cos(theta))
    sqrt_term = 2.0 * r ** 2 - rad ** 2 + spin ** 2
    w2 = np.maximum(x * x + y * y, 1e-300)
    if which == 1:
        val = aphi * (-y / w2 + spin * x * r
                      / ((spin ** 2 + r ** 2) * sqrt_term))
    elif which == 2:
        val = aphi * (x / w2 + spin * y * r
                      / ((spin ** 2 + r ** 2) * sqrt_term))
    else:
        val = aphi * (spin * zs / (r * sqrt_term))
    return np.where(r < 1.0, val * np.sin(0.5 * math.pi * r ** 2), val)


def init(pin, mesh, phys):
    if not getattr(phys, "is_gr", False) \
            or not getattr(phys, "is_mhd", False):
        raise ValueError("gr_monopole requires GR MHD "
                         "(<coord>/general_rel = true + <mhd>)")
    cd = phys.coord.coord_data
    spin = cd.bh_spin
    gm1 = phys.eos.gamma - 1.0
    sigma_norm = pin.get_or_add_real("problem", "sigma_norm", 1.0e2)
    sigma_pow = pin.get_or_add_real("problem", "sigma_pow", -1.0)
    rhomin = pin.get_or_add_real("problem", "rhomin", 1.0e-6)
    umin = pin.get_or_add_real("problem", "umin", 1.0e-8)
    a_norm = pin.get_or_add_real("problem", "a_norm", 1.0)
    pin.get_or_add_integer("problem", "nlevel", 10)   # read by final()
    rc = 10.0 * (1.0 + math.sqrt(1.0 - spin ** 2))

    mbi = mesh.mb_indcs
    n1, n2, n3 = mbi.ncells1, mbi.ncells2, mbi.ncells3
    w = np.zeros((mesh.nmb_total, phys.nvar, n3, n2, n1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    for gid in range(mesh.nmb_total):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        x1f, x2f, x3f = mesh.face_edges(gid)
        dxs = [float(mesh.mb_size[f"dx{d}"][gid]) for d in (1, 2, 3)]
        X = x1v[None, None, :] + 0.0 * x2v[None, :, None] \
            + 0.0 * x3v[:, None, None]
        Y = 0.0 * X + x2v[None, :, None]
        Z = 0.0 * X + x3v[:, None, None]
        r, _, _, _ = _ks_coords(X, Y, Z, spin)
        # power-law atmosphere, excised interior (gr_monopole.cpp:138-147)
        w[gid, IDN] = np.where(r > 1.0, rhomin + (r / rc) ** (-sigma_pow)
                               / r ** 4 / sigma_norm, cd.dexcise)
        w[gid, IEN] = np.where(r > 1.0, gm1 * (umin + (r / rc)
                                                ** (-sigma_pow)
                                                / r ** 4 / sigma_norm),
                               cd.pexcise) / gm1
        w[gid, IM1] = w[gid, IM2] = w[gid, IM3] = 0.0

        # the vector potential on the cell edges, its staggered curl
        X1v, X2v, X3v = x1v[None, None, :], x2v[None, :, None], \
            x3v[:, None, None]
        X1f = x1f[:n1 + 1][None, None, :]
        X2f = x2f[:n2 + 1][None, :, None]
        X3f = x3f[:n3 + 1][:, None, None]
        a1 = _a_cks(1, a_norm, spin, X1v + 0 * X2f + 0 * X3f,
                    0 * X1v + X2f + 0 * X3f, 0 * X1v + 0 * X2f + X3f)
        a2 = _a_cks(2, a_norm, spin, X1f + 0 * X2v + 0 * X3f,
                    0 * X1f + X2v + 0 * X3f, 0 * X1f + 0 * X2v + X3f)
        a3 = _a_cks(3, a_norm, spin, X1f + 0 * X2f + 0 * X3v,
                    0 * X1f + X2f + 0 * X3v, 0 * X1f + 0 * X2f + X3v)
        bfc["x1f"][gid] = (a3[:, 1:, :] - a3[:, :-1, :]) / dxs[1] \
            - (a2[1:, :, :] - a2[:-1, :, :]) / dxs[2]
        bfc["x2f"][gid] = (a1[1:, :, :] - a1[:-1, :, :]) / dxs[2] \
            - (a3[:, :, 1:] - a3[:, :, :-1]) / dxs[0]
        bfc["x3f"][gid] = (a2[:, :, 1:] - a2[:, :, :-1]) / dxs[0] \
            - (a1[:, 1:, :] - a1[:, :-1, :]) / dxs[1]
    return state_from_prims(phys, w, bfc)


def final(pin, mesh, phys, state):
    """The field-rotation diagnostic on a geodesic sphere at the horizon
    (MonopoleDiagnostic, gr_monopole.cpp:639-774): '<basename>-diag.dat'
    rows (theta, phi, Omega / Omega_H) for z > 0."""
    from ..pgen.errors import host
    from ..radiation.geodesic_grid import GeodesicGrid
    from ..z4c.ahf import interp_fields

    spin = phys.coord.coord_data.bh_spin
    rh = 1.0 + math.sqrt(1.0 - spin ** 2)
    grid = GeodesicGrid(pin.get_or_add_integer("problem", "nlevel", 10))
    pts = rh * grid.nh
    wn, bccn = host(state["w"]), host(state["bcc"])
    vx, vy, vz, bx, by, bz = interp_fields(
        mesh, [wn[:, IM1], wn[:, IM2], wn[:, IM3], bccn[:, 0], bccn[:, 1],
               bccn[:, 2]], pts)
    x, y, zz = pts[:, 0], pts[:, 1], pts[:, 2]
    gl, gu = host_metric(x, y, zz, spin)

    # u^mu from the utilde primitives (gr_monopole.cpp:692-703)
    q = (gl[1][1] * vx * vx + 2 * gl[1][2] * vx * vy
         + 2 * gl[1][3] * vx * vz + gl[2][2] * vy * vy
         + 2 * gl[2][3] * vy * vz + gl[3][3] * vz * vz)
    alpha = np.sqrt(-1.0 / gu[0][0])
    gamma = np.sqrt(1.0 + q)
    u0 = gamma / alpha
    u1 = vx - alpha * gamma * gu[0][1]
    u2 = vy - alpha * gamma * gu[0][2]
    u3 = vz - alpha * gamma * gu[0][3]
    u_1 = gl[1][0] * u0 + gl[1][1] * u1 + gl[1][2] * u2 + gl[1][3] * u3
    u_2 = gl[2][0] * u0 + gl[2][1] * u1 + gl[2][2] * u2 + gl[2][3] * u3
    u_3 = gl[3][0] * u0 + gl[3][1] * u1 + gl[3][2] * u2 + gl[3][3] * u3
    b0 = u_1 * bx + u_2 * by + u_3 * bz
    b1 = (bx + b0 * u1) / u0
    b2 = (by + b0 * u2) / u0
    b3 = (bz + b0 * u3) / u0

    # CKS -> spherical-KS r and phi components (gr_monopole.cpp:718-731)
    a2_ = spin ** 2
    rad2 = x * x + y * y + zz * zz
    r = rh
    r2 = r * r
    den = 2.0 * r2 - rad2 + a2_
    drdx, drdy = r * x / den, r * y / den
    drdz = (r * zz + a2_ * zz / r) / den
    w2 = np.maximum(x * x + y * y, 1e-300)
    dphdx = -y / w2 + (spin / (r2 + a2_)) * drdx
    dphdy = x / w2 + (spin / (r2 + a2_)) * drdy
    dphdz = (spin / (r2 + a2_)) * drdz
    ur = drdx * u1 + drdy * u2 + drdz * u3
    uph = dphdx * u1 + dphdy * u2 + dphdz * u3
    br = drdx * b1 + drdy * b2 + drdz * b3
    bph = dphdx * b1 + dphdy * b2 + dphdz * b3
    omega_h = 0.5 * spin / rh
    omega = np.where(zz > 0, (uph * br - ur * bph)
                     / np.maximum(u0 * br - ur * b0, 1e-12) / omega_h, 0.0)

    theta = np.arccos(np.clip(grid.nh[:, 2], -1.0, 1.0))
    phi = np.arctan2(grid.nh[:, 1], grid.nh[:, 0])
    fname = pin.get_string("job", "basename") + "-diag.dat"
    with open(fname, "w") as f:
        f.write("# theta  phi  omega\n")
        for n in range(grid.nangles):
            if zz[n] > 0.0:
                f.write(f"{theta[n]:12.5e} {phi[n]:12.5e} "
                        f"{omega[n]:12.5e}\n")
    return fname
