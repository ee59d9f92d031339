"""A radiation beam in (Cartesian Kerr-Schild) GR.

Counterpart of ``athenak_tpu/pgen/rad_beam.py`` (reference:
src/pgen/tests/rad_beam.cpp, src/srcterms/srcterms.cpp BeamSource): zero
initial intensities, a static injection n^0 n_0 dii/dt over the cells
within the proper width of the beam's origin and the angles within the
spread of its (null) direction, and zero intensity on the user sides.
Where the null direction has no real time component the square root is
of a negative number (ROADMAP F2): those cells get no beam, as in the
JAX package, and torch raises no warning for it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..comm import local_blocks


def side_mask(mesh, keys, device):
    """[nmb, 1, n3, n2, n1] bool on ``device``: the ghost cells of the
    physical faces ``keys`` (x1m, x1p, ...) of every block that has
    them."""
    mbi = mesh.mb_indcs
    ng = mbi.ng
    n = {"x1": mbi.ncells1, "x2": mbi.ncells2, "x3": mbi.ncells3}
    m = np.zeros((mesh.nmb_total, 1, mbi.ncells3, mbi.ncells2,
                  mbi.ncells1), dtype=bool)
    axis = {"x1": 4, "x2": 3, "x3": 2}
    for key in keys:
        ax, side = key[:2], key[2]
        sl = [slice(None)] * 5
        sl[axis[ax]] = slice(0, ng) if side == "m" \
            else slice(n[ax] - ng, n[ax])
        for gid in np.where(mesh.phys_bc_mask[key])[0]:
            sli = list(sl)
            sli[0] = gid
            m[tuple(sli)] = True
    return torch.as_tensor(m, device=device)


def user_sides(mesh, axes=("x1", "x2", "x3")):
    """The face keys of ``axes`` whose boundary flag is ``user``."""
    return [f"{ax}{side}" for ax in axes for side in ("m", "p")
            if mesh.mesh_bcs[("i" if side == "m" else "o") + ax] == "user"]


def cell_coords(rad):
    """float64 cell-centre coordinates [nmb, n3, n2, n1] on the run's
    device (broadcast views)."""
    xv, yv, zv = rad._coords[:3]
    shp = (xv.shape[0], zv.shape[1], yv.shape[1], xv.shape[1])

    def dev(a):
        return torch.as_tensor(a, dtype=torch.float64, device=rad.device)

    return (dev(xv)[:, None, None, :].expand(shp),
            dev(yv)[:, None, :, None].expand(shp),
            dev(zv)[:, :, None, None].expand(shp))


def beam_table(rad, gl, e, dx, dvec, width, spread, dii_dt):
    """n^0 n_0 dii_dt at the cells within the proper half-width of the
    origin (dx: the coordinate offsets) and the angles within half the
    spread of the null direction (dvec: its spatial components; the
    time component from g_mu_nu d^mu d^nu = 0), else 0, at the run's
    dtype (reference: BeamSource)."""
    d1, d2, d3 = dvec
    dx1, dx2, dx3 = dx
    dx_sq = (gl[1][1] * dx1 * dx1 + 2 * gl[1][2] * dx1 * dx2
             + 2 * gl[1][3] * dx1 * dx3 + gl[2][2] * dx2 * dx2
             + 2 * gl[2][3] * dx2 * dx3 + gl[3][3] * dx3 * dx3)
    mu_min = math.cos(spread / 2.0 * math.pi / 180.0)
    ta = gl[0][0]
    tb = 2.0 * (gl[0][1] * d1 + gl[0][2] * d2 + gl[0][3] * d3)
    tc_ = (gl[1][1] * d1 * d1 + 2 * gl[1][2] * d1 * d2
           + 2 * gl[1][3] * d1 * d3 + gl[2][2] * d2 * d2
           + 2 * gl[2][3] * d2 * d3 + gl[3][3] * d3 * d3)
    d0 = (-tb - torch.sqrt(tb * tb - 4.0 * ta * tc_)) / (2.0 * ta)
    dv = [d0, d1, d2, d3]
    dc = [sum(gl[a][b] * dv[b] for b in range(4)) for a in range(4)]
    # the covariant direction in the tetrad frame
    dt = [sum(e[a][mu] * dc[mu] for mu in range(4)) for a in range(4)]
    dtc = [dt[c] / (-dt[0]) for c in (1, 2, 3)]
    nh = rad.grid.nh
    mu_ang = sum(torch.as_tensor(nh[:, c], dtype=torch.float64,
                                 device=rad.device).reshape(1, -1, 1, 1, 1)
                 * dtc[c][:, None] for c in range(3))
    in_beam = (dx_sq[:, None] < (width / 2.0) ** 2) & (mu_ang > mu_min)
    nn = rad.n0.to(torch.float64) * rad.n_0.to(torch.float64) * dii_dt
    return torch.where(in_beam, nn, 0.0).to(rad.dtype)


def zero_bc_hook(mesh, rad, axes):
    """A user boundary function that zeroes the ghosts of the user sides
    of ``axes``, in place (reference: ZeroIntensity).  The mask is read
    through ``local_blocks``, so the hook also
    runs on one rank's blocks (JAX rad_beam.py:103-108)."""
    mask = side_mask(mesh, user_sides(mesh, axes), rad.device)

    def zero_bc(u, bv):
        return u.masked_fill_(local_blocks(mask), 0.0)

    zero_bc.shard_safe = True
    return zero_bc


def init(pin, mesh, phys):
    from ..gr.cks import metric
    from ..radiation.tetrad import tetrad

    rad = getattr(phys, "rad", phys)
    if rad is not phys:
        raise NotImplementedError("rad_beam with a coupled fluid not wired")
    blk = "rad_srcterms"
    dii_dt = pin.get_real(blk, "dii_dt")
    pos = [pin.get_real(blk, f"pos_{i}") for i in (1, 2, 3)]
    dvec = [pin.get_real(blk, f"dir_{i}") for i in (1, 2, 3)]
    width = pin.get_real(blk, "width")
    spread = pin.get_real(blk, "spread")

    X, Y, Z = cell_coords(rad)
    gl, _ = metric(X, Y, Z, rad.spin, rad.minkowski)
    e, _ = tetrad(X, Y, Z, rad.spin, rad.minkowski)
    rad.beam_dii0 = beam_table(rad, gl, e, (X - pos[0], Y - pos[1],
                                            Z - pos[2]),
                               dvec, width, spread, dii_dt)
    phys.bvals.user_bc_func = zero_bc_hook(mesh, rad, ("x1", "x2", "x3"))
    i0 = torch.zeros(rad.shape, dtype=rad.dtype, device=rad.device)
    return phys.make_state(i0)
