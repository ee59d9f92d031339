"""Circularly polarised Alfven wave (CPAW), an exact nonlinear MHD
solution.

Counterpart of ``athenak_tpu/pgen/cpaw.py`` (reference:
src/pgen/tests/cpaw.cpp): the wavevector along an axis or the grid
diagonal, the face field from the curl of the analytic vector potential
(div B = 0 to round-off), ``time/tlim`` in wave periods at the Alfven
speed, and at the end the L1/Linf error file with the cell-centred
field (AlfvenWaveErrors).  On a refined mesh the potential on faces
shared with a finer neighbour is the mean of two fine samples
(cpaw.cpp "Correct A1/A2/A3").
"""

from __future__ import annotations

import math

import numpy as np

from ..indices import IDN, IEN, IVX, IVY, IVZ
from . import errors as err_mod
from . import state_from_prims, to_device
from .linear_wave import wave_geometry


class _AW:
    """Wave parameters shared by the potential/IC/error passes."""

    def __init__(self, pin, mesh):
        (self.cos_a2, self.sin_a2, self.cos_a3, self.sin_a3,
         self.lx, self.k_par) = wave_geometry(pin, mesh)
        self.b_par = pin.get_real("problem", "b_par")
        self.b_perp = pin.get_real("problem", "b_perp")
        self.v_par = pin.get_real("problem", "v_par")
        self.pres = pin.get_real("problem", "pres")
        self.den = 1.0
        self.v_perp = self.b_perp / math.sqrt(self.den)
        self.pol = 1.0 if pin.get_or_add_boolean(
            "problem", "right_polar", True) else -1.0

    # rotated-frame coordinates
    def _xy(self, x1, x2, x3):
        x = (x1 * self.cos_a2 * self.cos_a3
             + x2 * self.cos_a2 * self.sin_a3 + x3 * self.sin_a2)
        y = -x1 * self.sin_a3 + x2 * self.cos_a3
        return x, y

    # vector potential components in grid frame (cpaw.cpp A1/A2/A3)
    def a1(self, x1, x2, x3):
        x, y = self._xy(x1, x2, x3)
        ay = self.pol * (self.b_perp / self.k_par) * np.sin(self.k_par * x)
        az = ((self.b_perp / self.k_par) * np.cos(self.k_par * x)
              + self.b_par * y)
        return -ay * self.sin_a3 - az * self.sin_a2 * self.cos_a3

    def a2(self, x1, x2, x3):
        x, y = self._xy(x1, x2, x3)
        ay = self.pol * (self.b_perp / self.k_par) * np.sin(self.k_par * x)
        az = ((self.b_perp / self.k_par) * np.cos(self.k_par * x)
              + self.b_par * y)
        return ay * self.cos_a3 - az * self.sin_a2 * self.sin_a3

    def a3(self, x1, x2, x3):
        x, y = self._xy(x1, x2, x3)
        az = ((self.b_perp / self.k_par) * np.cos(self.k_par * x)
              + self.b_par * y)
        return az * self.cos_a2


def _fine_face_masks(mesh):
    """Per block: does face (axis, side) touch a finer neighbor?
    Used to average the vector potential at shared fine/coarse faces
    (cpaw.cpp neighbor-level checks)."""
    out = {}
    ml = getattr(mesh, "ml", None)
    for key in ("x1m", "x1p", "x2m", "x2p", "x3m", "x3p"):
        if ml is not None and key in ml and "fine_mask" in ml[key]:
            out[key] = np.asarray(ml[key]["fine_mask"], dtype=bool)
        else:
            out[key] = np.zeros(mesh.nmb_total, dtype=bool)
    return out


def _build(pin, mesh, phys, rescale_tlim: bool):
    aw = _AW(pin, mesh)
    eos = phys.eos
    mbi = mesh.mb_indcs
    nmb = mesh.nmb_total
    gm1 = eos.gamma - 1.0 if eos.is_ideal else None

    if rescale_tlim:
        # tlim is in wave periods; the wave travels at the Alfven speed
        # b_par/sqrt(den) along the wavevector (cpaw.cpp:208-212)
        tlim = pin.get_real("time", "tlim")
        pin.set_real("time", "tlim",
                     tlim * abs(aw.lx / (aw.b_par / math.sqrt(aw.den))))

    w = np.zeros((nmb, phys.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1))
    bfc = {k: np.zeros(s) for k, s in phys.fc_shapes.items()}
    act = (slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
           slice(mbi.is_, mbi.is_ + mbi.nx1))
    one_d = mbi.nx2 == 1
    fmask = _fine_face_masks(mesh)

    for gid in range(nmb):
        x1v, x2v, x3v = mesh.cell_centers(gid)
        x1f, x2f, x3f = mesh.face_edges(gid)
        dx1 = float(mesh.mb_size["dx1"][gid])
        dx2 = float(mesh.mb_size["dx2"][gid])
        dx3 = float(mesh.mb_size["dx3"][gid])

        # --- primitives on active cells (cpaw.cpp pgen_alfwave2)
        X3, X2, X1 = np.meshgrid(x3v[act[0]], x2v[act[1]], x1v[act[2]],
                                 indexing="ij")
        x, _ = aw._xy(X1, X2, X3)
        sn = np.sin(aw.k_par * x)
        cs = aw.pol * np.cos(aw.k_par * x)
        vx = aw.v_par
        vy = -aw.pol * aw.v_perp * sn
        vz = -aw.pol * aw.v_perp * cs
        w[gid, IDN][act] = aw.den
        w[gid, IVX][act] = (vx * aw.cos_a2 * aw.cos_a3 - vy * aw.sin_a3
                            - vz * aw.sin_a2 * aw.cos_a3)
        w[gid, IVY][act] = (vx * aw.cos_a2 * aw.sin_a3 + vy * aw.cos_a3
                            - vz * aw.sin_a2 * aw.sin_a3)
        w[gid, IVZ][act] = vx * aw.sin_a2 + vz * aw.cos_a2
        if eos.is_ideal:
            w[gid, IEN][act] = aw.pres / gm1

        if one_d:
            xc = x1v
            bfc["x1f"][gid, 0, 0, :] = aw.b_par
            bfc["x2f"][gid, 0, :, :] = (aw.pol * aw.b_perp
                                        * np.sin(aw.k_par * x1v))
            bfc["x3f"][gid, :, 0, :] = (aw.b_perp
                                        * np.cos(aw.k_par * x1v))
            continue

        # --- B = curl A on the staggered mesh.  A components live on
        # cell edges: A1 at (x1v, x2f, x3f), A2 at (x1f, x2v, x3f),
        # A3 at (x1f, x2f, x3v).
        x3f_use = x3f if mbi.nx3 > 1 else np.array([x3v[0], x3v[0]])
        x3v_use = x3v if mbi.nx3 > 1 else x3v[:1]

        def eval_edge(fn, c_axis):
            """Evaluate A_c on its edge set, with fine-neighbor averaging
            along the cell-centered axis c on touching boundary layers."""
            if c_axis == 0:    # A1 at (x1v, x2f, x3f)
                X3, X2, X1 = np.meshgrid(x3f_use, x2f, x1v, indexing="ij")
                d = dx1
            elif c_axis == 1:  # A2 at (x1f, x2v, x3f)
                X3, X2, X1 = np.meshgrid(x3f_use, x2v, x1f, indexing="ij")
                d = dx2
            else:              # A3 at (x1f, x2f, x3v)
                X3, X2, X1 = np.meshgrid(x3v_use, x2f, x1f, indexing="ij")
                d = dx3
            v = fn(X1, X2, X3)
            # fine-neighbor correction: on any face/edge layer adjacent
            # to a finer block, replace with the two-sample average
            need = any(fmask[k][gid] for k in fmask)
            if need:
                off = [0.0, 0.0, 0.0]
                off[c_axis] = d / 4.0
                vf = 0.5 * (fn(X1 + off[0], X2 + off[1], X3 + off[2])
                            + fn(X1 - off[0], X2 - off[1], X3 - off[2]))
                m = np.zeros(v.shape, dtype=bool)
                # boundary layers on the two *other* axes (the edge axes)
                edge_axes = [a for a in range(3) if a != c_axis]
                for a in edge_axes:
                    arr_ax = 2 - a  # (z,y,x) array order
                    if a == 2 and mbi.nx3 == 1:
                        continue
                    if a == 1 and mbi.nx2 == 1:
                        continue
                    keym, keyp = f"x{a + 1}m", f"x{a + 1}p"
                    if fmask[keym][gid]:
                        idx = [slice(None)] * 3
                        idx[arr_ax] = slice(0, 1)
                        m[tuple(idx)] = True
                    if fmask[keyp][gid]:
                        idx = [slice(None)] * 3
                        idx[arr_ax] = slice(v.shape[arr_ax] - 1, None)
                        m[tuple(idx)] = True
                v = np.where(m, vf, v)
            return v

        a1 = eval_edge(aw.a1, 0)                     # [n3(+1), n2+1, n1]
        a2 = eval_edge(aw.a2, 1)                     # [n3(+1), n2, n1+1]
        a3 = eval_edge(aw.a3, 2)                     # [n3, n2+1, n1+1]

        b1 = (a3[:, 1:, :] - a3[:, :-1, :]) / dx2
        b2 = -(a3[:, :, 1:] - a3[:, :, :-1]) / dx1
        b3 = ((a2[:, :, 1:] - a2[:, :, :-1]) / dx1
              - (a1[:, 1:, :] - a1[:, :-1, :]) / dx2)
        if mbi.nx3 > 1:
            b1 = b1 - (a2[1:, :, :] - a2[:-1, :, :]) / dx3
            b2 = b2 + (a1[1:, :, :] - a1[:-1, :, :]) / dx3
            bfc["x1f"][gid] = b1
            bfc["x2f"][gid] = b2
            bfc["x3f"][gid] = b3
        else:
            bfc["x1f"][gid] = b1[:1]
            bfc["x2f"][gid] = b2[:1]
            bfc["x3f"][gid][0] = b3[0]
            bfc["x3f"][gid][1] = b3[0]

    return w, bfc


def init(pin, mesh, phys):
    if not getattr(phys, "is_mhd", False):
        raise ValueError("cpaw requires the <mhd> block "
                         "(reference: cpaw.cpp MHD-only)")
    w, bfc = _build(pin, mesh, phys, rescale_tlim=True)
    return state_from_prims(phys, w, bfc)


def final(pin, mesh, phys, state):
    """AlfvenWaveErrors: L1/Linf against the initial condition after
    whole wave periods (cpaw.cpp:447-530)."""
    u = state["u"]
    w_ref, bfc_ref = _build(pin, mesh, phys, rescale_tlim=False)
    w_ref = to_device(phys, w_ref)
    bfc_ref = {k: to_device(phys, v) for k, v in bfc_ref.items()}
    bcc_ref = phys.compute_bcc(bfc_ref)
    u_ref = phys.prim_to_cons(w_ref, bcc_ref)

    nvars = phys.nmhd
    l1, linf = err_mod.compute_errors(mesh, u, u_ref, nvars)

    bcc = state["bcc"]
    mbi = mesh.mb_indcs
    sl = (slice(None), slice(None),
          slice(mbi.ks, mbi.ke + 1), slice(mbi.js, mbi.je + 1),
          slice(mbi.is_, mbi.ie + 1))
    diff_b = np.abs(err_mod.host(bcc[sl]) - err_mod.host(bcc_ref[sl]))
    ms = mesh.mesh_size
    vol = ((ms.x1max - ms.x1min) * (ms.x2max - ms.x2min)
           * (ms.x3max - ms.x3min))
    vol_cell = (np.asarray(mesh.mb_size["dx1"], dtype=np.float64)
                * np.asarray(mesh.mb_size["dx2"])
                * np.asarray(mesh.mb_size["dx3"]))
    l1_b = (vol_cell[:, None] * diff_b.sum(axis=(2, 3, 4))).sum(axis=0) / vol
    linf_b = (vol_cell.reshape(-1, 1, 1, 1, 1) * diff_b).max() / vol

    l1_all = np.concatenate([l1[:nvars], l1_b])
    linf_all = max(float(linf), float(linf_b))
    names = ["d", "M1", "M2", "M3"] + (["E"] if phys.eos.is_ideal else []) \
        + ["B1c", "B2c", "B3c"]
    err_mod.write_error_file(pin, mesh, l1_all, linf_all, names)
