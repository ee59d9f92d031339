"""Coordinates / relativity mode flags.

Counterpart of ``athenak_tpu/coordinates.py`` (reference:
src/coordinates/coordinates.cpp:30-60): <coord>/special_rel and
<coord>/general_rel select the SR/GR variants of every physics module.
A copy of ``CoordData`` and ``Coordinates``, kept in the port so that it
never imports the JAX package, and ``GRGeometry``, the metric of a GR run.
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import local_tree


class CoordData:
    """GR coordinate parameters
    (reference: src/coordinates/coordinates.cpp:46-71)."""

    def __init__(self, pin) -> None:
        self.is_minkowski = pin.get_or_add_boolean("coord", "minkowski",
                                                   False)
        if not self.is_minkowski:
            self.bh_spin = pin.get_real("coord", "a")
            self.bh_excise = pin.get_or_add_boolean("coord", "excise", True)
        else:
            self.bh_spin = 0.0
            self.bh_excise = False
        if self.bh_excise:
            self.dexcise = pin.get_real("coord", "dexcise")
            self.pexcise = pin.get_real("coord", "pexcise")
            self.rexcise = 1.0
        else:
            self.dexcise = self.pexcise = -1.0
            self.rexcise = 0.0


class GRGeometry:
    """The Kerr-Schild metric of a mesh, computed once and kept.

    The JAX package bakes the cell-centre and face coordinates as host
    constants and recomputes the metric inside ``jit``, where XLA fuses
    it into its consumers.  The port has no ``jit``: recomputing would
    cost some 200 launches at every call.  So the metric at the cell
    centres and at the lower x1, x2 and x3 faces (``where`` = "cc", "x1",
    "x2", "x3"; the faces of the active directions only) and its
    derivatives at the cell centres are computed here once, in float64
    on the run's device, and stored at the run's dtype as [nmb, n3, n2,
    n1] tensors, one tensor shared between the components (i, j) and
    (j, i).  In float32 this is more accurate than the JAX package's
    float32 run, which computed the metric in float32.  About 110 arrays
    of the cell count (``nbytes``).  A refined mesh gets its own
    geometry at every rebuild, as the physics is rebuilt.
    ``ks_radius_cc`` and ``excision_floor_mask`` stay host numpy, as in
    the JAX package (reference: src/coordinates/excision.cpp)."""

    def __init__(self, mesh, coord_data: CoordData, device, dtype,
                 faces=("x1", "x2", "x3")) -> None:
        self.cd = coord_data
        mbi = mesh.mb_indcs
        nmb = mesh.nmb_total
        xc = np.empty((nmb, 1, 1, mbi.ncells1))
        yc = np.empty((nmb, 1, mbi.ncells2, 1))
        zc = np.empty((nmb, mbi.ncells3, 1, 1))
        xf, yf, zf = np.empty_like(xc), np.empty_like(yc), np.empty_like(zc)
        for gid in range(nmb):
            x1v, x2v, x3v = mesh.cell_centers(gid)
            x1e, x2e, x3e = mesh.face_edges(gid)
            xc[gid, 0, 0, :] = x1v
            yc[gid, 0, :, 0] = x2v
            zc[gid, :, 0, 0] = x3v
            xf[gid, 0, 0, :] = x1e[:mbi.ncells1]
            yf[gid, 0, :, 0] = x2e[:mbi.ncells2]
            zf[gid, :, 0, 0] = x3e[:mbi.ncells3]
        self.xc, self.yc, self.zc = xc, yc, zc
        pos = {"cc": (xc, yc, zc), "x1": (xf, yc, zc), "x2": (xc, yf, zc),
               "x3": (xc, yc, zf)}
        self.device = torch.device(device)
        self.dtype = dtype
        from .gr import cks

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float64,
                                   device=self.device)

        a, mink = coord_data.bh_spin, coord_data.is_minkowski
        self._metric = {}
        for where in ("cc",) + tuple(faces):
            x, y, z = (dev(c) for c in pos[where])
            gl, gu = cks.metric(x, y, z, a, mink)
            self._metric[where] = (self._store(gl), self._store(gu))
        x, y, z = (dev(c) for c in pos["cc"])
        self._dg = tuple(self._store(dg) for dg in
                         cks.metric_derivatives(x, y, z, a, mink))

    def _store(self, g):
        """Nested 4x4 float64 components -> the run's dtype, one tensor
        for (i, j) and (j, i)."""
        out = [[None] * 4 for _ in range(4)]
        for i in range(4):
            for j in range(i, 4):
                t = g[i][j].to(self.dtype).contiguous()
                out[i][j] = out[j][i] = t
        return out

    def metric(self, where: str = "cc"):
        """(glower, gupper) at the cell centres or the lower faces of
        one direction (nested 4x4 lists of [nmb, n3, n2, n1] tensors)."""
        if where not in self._metric:
            raise ValueError(where)
        return local_tree(self._metric[where])

    def metric_derivatives(self):
        """(dg_dx1, dg_dx2, dg_dx3) of glower at the cell centres."""
        return local_tree(self._dg)

    def nbytes(self) -> int:
        """Bytes of the kept metric tensors."""
        seen = {}
        for gl, gu in list(self._metric.values()) + [(d, []) for d in
                                                      self._dg]:
            for row in list(gl) + list(gu):
                for t in row:
                    seen[id(t)] = t.numel() * t.element_size()
        return sum(seen.values())

    def ks_radius_cc(self):
        """Spherical KS radius at the cell centres (host numpy; reference:
        KSRX, src/coordinates/excision.cpp:20-24)."""
        x, y, z = self.xc, self.yc, self.zc
        a = self.cd.bh_spin
        rad2 = x * x + y * y + z * z
        return np.sqrt((rad2 - a * a
                        + np.sqrt((rad2 - a * a) ** 2
                                  + 4 * a * a * z * z)) / 2.0)

    def excision_floor_mask(self):
        """Cells with r_ks <= rexcise (host numpy bool, broadcast shape;
        reference: Coordinates::SetExcisionMasks, excision.cpp:52-95)."""
        return self.ks_radius_cc() <= self.cd.rexcise


def excision_masks(geom: GRGeometry, mesh, device):
    """The excision masks of a GR run as [nmb, n3, n2, n1] bool tensors
    on ``device``, or (None, None) without excision: the c2p's (cells
    with r_ks <= rexcise) and first-order flux correction's (cells with
    r_ks <= 1 or a face neighbour there; the neighbours wrap inside each
    block, as in the JAX package; reference: SetExcisionMasks,
    excision.cpp:52-120)."""
    if not geom.cd.bh_excise:
        return None, None
    mbi = mesh.mb_indcs
    shape = (mesh.nmb_total, mbi.ncells3, mbi.ncells2, mbi.ncells1)
    floor = np.broadcast_to(geom.excision_floor_mask(), shape).copy()
    near = np.broadcast_to(geom.ks_radius_cc(), shape) <= 1.0
    flux = near.copy()
    for ax in (1, 2, 3):
        flux |= np.roll(near, 1, axis=ax) | np.roll(near, -1, axis=ax)
    return (torch.as_tensor(floor, device=device),
            torch.as_tensor(flux, device=device))


class Coordinates:
    def __init__(self, pin) -> None:
        if pin.does_block_exist("coord"):
            self.is_special_relativistic = pin.get_or_add_boolean(
                "coord", "special_rel", False)
            self.is_general_relativistic = pin.get_or_add_boolean(
                "coord", "general_rel", False)
        else:
            self.is_special_relativistic = False
            self.is_general_relativistic = False
        if self.is_special_relativistic and self.is_general_relativistic:
            raise ValueError("cannot specify both special_rel and general_rel")
        self.coord_data = CoordData(pin) \
            if self.is_general_relativistic else None
