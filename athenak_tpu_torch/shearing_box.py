"""Shearing box: local-frame source terms, orbital advection of the cell
and face variables, and the shear-periodic x1 boundaries.

Counterpart of ``athenak_tpu/shearing_box.py`` (reference:
src/shearing_box/shearing_box.cpp:24-68, shearing_box_srcterms.cpp:30-200,
orbital_advection_cc.cpp:244-290, orbital_advection_fc.cpp:180-361,
shearing_box_cc.cpp:63-140, shearing_box_fc.cpp:60-140,
remap_fluxes.hpp:15-69).  The evolved azimuthal velocity is the
deviation from the orbital shear flow vy_orb = -q Omega x1:

  * source terms (``src_terms``): dM1 += 2 Om M2 bdt, dM2 -= (2-q) Om M1
    bdt, dE += q Om (M1 M2 / rho - Bx By) bdt, and with
    ``<shearing_box>/stratified`` the vertical gravity -Om^2 z rho;
  * orbital advection once a cycle (``orbital_advect``): every
    x1-column moves in y by dy = -q Om x1 dt, by a conservative remap (an
    integer gather plus an upwind PLM flux for the fraction); the face
    field (``orbital_advect_fc``) takes the EMF form of Stone & Gardiner
    (2010), whose remap fluxes enter a CT update, so div(B) stays at
    round-off;
  * the shear-periodic x1 ghosts (``remap_ghosts``, ``remap_ghosts_fc``):
    each boundary block's ghost slab comes from the opposite boundary
    column's full azimuthal ring, shifted by +/- q Om Lx t with the same
    remap.

The 2-D box (nx3 = 1) is the r-z box: the toroidal direction is
component 3, there is no orbital advection and no sheared remap (the
boundary acts as periodic), and the orbital EMF enters the CT update as
a source (``src_terms_fc``).  On a refined mesh the rings are built level
by level, which needs z-slab refinement: every refined region spans the
whole x1-x2 extent (``_check_zslab`` raises otherwise).

The gathers run on the state's device with int64 index tensors.  The
JAX package's ``take_along_axis`` clamps an index out of range, while
``torch.gather`` on the card stops the run with a device-side assert, so
``orbital_advect`` checks the integer shift of this cycle's dt against
``maxjshift`` on the host first (in the state's dtype, as the device
computes it) and raises with the deck's numbers; nothing is clamped.
The remap moves the active x1 columns only: the JAX package also moves
the x1 ghost columns, whose shifts can pass the bound (clamped there),
and the fill that follows overwrites them in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from .comm import LocalAttr, local_blocks
from .indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ

_TINY = 1.0e-300


def _mc_slope(g, axis: int):
    """Monotonised-central slope along ``axis`` (periodic neighbours)."""
    dl = g - torch.roll(g, 1, dims=axis)
    dr = torch.roll(g, -1, dims=axis) - g
    return torch.where(dl * dr > 0.0, 2.0 * dl * dr / (dl + dr + _TINY),
                       torch.zeros_like(g))


def _axis_index(idx, ndim: int, axis: int):
    """A 1-D index along ``axis`` shaped to broadcast over ``ndim`` axes."""
    shape = [1] * ndim
    shape[axis] = idx.shape[0]
    return idx.reshape(shape)


def _plm_remap(f, s, axis: int):
    """Conservative periodic remap of ``f`` by ``s`` cells (a 0-d tensor)
    along ``axis``; a positive shift moves the profile toward +axis.  PLM
    with monotonised-central slopes (reference: remap_fluxes.hpp)."""
    n = f.shape[axis]
    jo = torch.floor(s).to(torch.int64)
    eps = s - jo.to(s.dtype)                      # in [0, 1)
    jgrid = torch.arange(n, device=f.device)
    idx = _axis_index(torch.remainder(jgrid - jo, n), f.ndim, axis)
    g = torch.gather(f, axis, idx.expand(f.shape))
    # the fraction: upwind PLM flux through j-1/2 and j+1/2
    gm = torch.roll(g, 1, dims=axis)
    sig_m = torch.roll(_mc_slope(g, axis), 1, dims=axis)
    flux = eps * (gm + 0.5 * (1.0 - eps) * sig_m)
    return g - (torch.roll(flux, -1, dims=axis) - flux)


def _remap_flux(ext, eps, axis: int):
    """Upwind PLM remap flux through face j (between cells j-1 and j) for
    a signed fraction ``eps`` (reference: remap_fluxes.hpp PLM_RemapFlx,
    both branches)."""
    sig = _mc_slope(ext, axis)
    um = torch.roll(ext, 1, dims=axis)
    sm = torch.roll(sig, 1, dims=axis)
    f_pos = eps * (um + 0.5 * (1.0 - eps) * sm)
    f_neg = eps * (ext - 0.5 * (1.0 + eps) * sig)
    return torch.where(eps > 0.0, f_pos, f_neg)


class ShearingBox:
    """The ``<shearing_box>`` block of a hydro or MHD deck.  On one
    rank's blocks of a group the per-block tables are read as the rank's
    rows (``comm.LocalAttr``, ``comm.local_blocks``), the remaps' donor
    slabs come through the rank exchange (every ring column and x2
    neighbour is a gid map, ``BlockTables.gather``), and the host check
    of the shift reads every block's table, so each rank raises alike."""

    # per-block tables [nmb, ...], read as the running cycle's rows
    _xc = LocalAttr()
    _xf = LocalAttr()
    _zc = LocalAttr()
    _dyb = LocalAttr()
    _qo_xv = LocalAttr()
    _qo_xf = LocalAttr()

    def __init__(self, pin, mesh, device, dtype) -> None:
        self.mesh = mesh
        self.device = torch.device(device)
        self.dtype = dtype
        self.qshear = pin.get_real("shearing_box", "qshear")
        self.omega0 = pin.get_real("shearing_box", "omega0")
        self.is_stratified = pin.get_or_add_boolean(
            "shearing_box", "stratified", False)
        ms = mesh.mesh_size
        self.lx = ms.x1max - ms.x1min
        mbi = mesh.mb_indcs
        if mbi.nx2 == 1:
            raise NotImplementedError(
                "1D shearing box is not a supported configuration")
        # the 2-D r-z box has no orbital advection and no sheared remap
        # (reference: mhd_tasks.cpp gates them on three_d)
        self.oa_active = mbi.nx3 > 1

        # the largest integer shift a cycle (reference:
        # orbital_advection.cpp:41-43)
        cfl = pin.get_or_add_real("time", "cfl_number", 0.8) \
            if pin.does_block_exist("time") else 0.8
        self.maxjshift = int(cfl * max(abs(ms.x1min), abs(ms.x1max))) + 1
        if self.oa_active and self.maxjshift > mbi.nx2:
            raise ValueError(
                f"orbital advection shift bound {self.maxjshift} exceeds "
                f"meshblock nx2={mbi.nx2}; use larger y-blocks")

        # x1 cell centres and faces and x3 centres per block, host float64
        nmb = mesh.nmb_total
        xc = np.empty((nmb, 1, 1, 1, mbi.ncells1))
        xf = np.empty((nmb, 1, 1, 1, mbi.ncells1 + 1))
        zc = np.empty((nmb, 1, mbi.ncells3, 1, 1))
        for gid in range(nmb):
            x1v, _, x3v = mesh.cell_centers(gid)
            xc[gid, 0, 0, 0, :] = x1v
            xf[gid, 0, 0, 0, :] = mesh.face_edges(gid)[0]
            zc[gid, 0, :, 0, 0] = x3v
        self.xc = xc
        self.dy = ms.dx2
        # per-block level and y spacing: the sheared remap works in the
        # block's own cells (reference: remap_fluxes.hpp)
        self.mb_lev = np.asarray(mesh.mb_lev)
        self.dyb = (ms.dx2 / (2.0 ** self.mb_lev)).reshape(-1, 1, 1, 1)
        if mesh.multilevel and self.oa_active:
            self._check_zslab(mesh)

        def dev(a):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        self._xc, self._xf, self._zc = dev(xc), dev(xf), dev(zc)
        self._dyb = dev(self.dyb)
        # the orbital EMF's (q Om x) factors of the 2-D r-z box, formed in
        # float64 on the host and rounded once, as the JAX package's numpy
        # factors are
        qo = self.qshear * self.omega0
        self._qo_xv = dev(qo * xc[:, 0])
        self._qo_xf = dev(qo * xf[:, 0][..., :-1])

        # the shear-periodic rings: for each x1 boundary block, the gids
        # of the opposite boundary column ordered by y, one table a level
        # (reference: the sheared-overlap target search of
        # shearing_box_cc.cpp:63-100)
        self.ring = {}
        self._bmask = {}
        if mesh.mesh_bcs["ix1"] == "shear_periodic":
            nrbx1, nrbx2 = self._nrbx(mesh)
            loc2gid = {(int(self.mb_lev[g]), int(l[0]), int(l[1]),
                        int(l[2])): g
                       for g, l in enumerate(mesh.lloc_eachmb)}
            levels = sorted(set(int(v) for v in self.mb_lev))
            for side in ("m", "p"):
                bmask = np.asarray(mesh.phys_bc_mask[f"x1{side}"])
                groups = []
                for lv in levels:
                    lmask = bmask & (self.mb_lev == lv)
                    if not lmask.any():
                        continue
                    n2b = nrbx2 << lv
                    src_lx1 = ((nrbx1 << lv) - 1) if side == "m" else 0
                    ring = np.zeros((nmb, n2b), dtype=np.int64)
                    for g in np.where(lmask)[0]:
                        l3 = int(mesh.lloc_eachmb[g][2])
                        for yi in range(n2b):
                            ring[g, yi] = loc2gid[(lv, src_lx1, yi, l3)]
                    # the gathers' maps: a block off this level's
                    # boundary column reads its own slab (masked out
                    # after), so under ranks no slab moves for it
                    cols = [np.where(lmask, ring[:, yi], np.arange(nmb))
                            for yi in range(n2b)]
                    groups.append((lv, ring, lmask, cols))
                if groups:
                    self.ring[side] = groups
                    self._bmask[side] = np.logical_or.reduce(
                        [grp[2] for grp in groups])
        self._win = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _nrbx(mesh):
        """Root-grid block counts (nrbx1, nrbx2)."""
        t = getattr(mesh, "tree_nrbx", None)
        if t is not None:
            return int(t[0]), int(t[1])
        return int(mesh.nmb_x1), int(mesh.nmb_x2)

    def _check_zslab(self, mesh) -> None:
        """A refined shearing box must refine z-slabs spanning the whole
        x1-x2 extent, so that the sheared rings pair same-level columns
        and every x2 neighbour is on the same level (the reference's
        MRI decks use only this layout)."""
        nrbx1, nrbx2 = mesh.tree_nrbx[0], mesh.tree_nrbx[1]
        have = {(int(self.mb_lev[g]), int(l[0]), int(l[1]), int(l[2]))
                for g, l in enumerate(mesh.lloc_eachmb)}
        for g, l in enumerate(mesh.lloc_eachmb):
            lv = int(self.mb_lev[g])
            l3 = int(l[2])
            for l1 in range(nrbx1 << lv):
                for l2 in range(nrbx2 << lv):
                    if (lv, l1, l2, l3) not in have:
                        raise NotImplementedError(
                            "shearing box with mesh refinement requires "
                            "z-slab refinement regions spanning the "
                            "full x1/x2 extent (block at level "
                            f"{lv}, lloc {tuple(int(v) for v in l)} has "
                            "a mixed-level x-row)")

    # ------------------------------------------------------------------
    def src_terms(self, u, w, beta_dt, is_ideal: bool, bcc=None):
        """Coriolis and tidal terms, and the work they do (reference:
        shearing_box_srcterms.cpp:30-150; the MHD energy source subtracts
        the Maxwell stress q Om Bx By).  Returns a new tensor."""
        om, q = self.omega0, self.qshear
        den = w[:, IDN]
        mom1 = den * w[:, IVX]
        u = u.clone()
        if not self.oa_active:
            # the r-z box: the toroidal momentum is component 3
            # (reference: shearing_box_srcterms.cpp:66-81, 132-150)
            mom3 = den * w[:, IVZ]
            u[:, IM1] += 2.0 * beta_dt * om * mom3
            u[:, IM3] += -(2.0 - q) * beta_dt * om * mom1
            if is_ideal:
                src = mom1 * mom3 / den
                if bcc is not None:
                    src = src - bcc[:, 0] * bcc[:, 2]
                u[:, IEN] += beta_dt * q * om * src
            return u
        mom2 = den * w[:, IVY]
        u[:, IM1] += 2.0 * beta_dt * om * mom2
        u[:, IM2] += -(2.0 - q) * beta_dt * om * mom1
        if self.is_stratified:
            u[:, IM3] += -beta_dt * om * om * den * self._zc[:, 0]
        if is_ideal:
            src = mom1 * mom2 / den
            if bcc is not None:
                src = src - bcc[:, 0] * bcc[:, 1]
            u[:, IEN] += beta_dt * q * om * src
        return u

    def src_terms_fc(self, e1, e2, bfc):
        """The r-z box's orbital EMF, E = -(v_K x B) with v_K = -q Om x
        e_3: E1 -= q Om x1v B2, E2 += q Om x1f B1 on the cell-indexed edge
        arrays (reference: SourceTermsFC, shearing_box_srcterms.cpp:
        159-200; only the 2-D box needs it)."""
        b1 = bfc["x1f"][..., :-1]      # face i-1/2 at cell index i
        b2 = bfc["x2f"][..., :-1, :]
        return e1 - self._qo_xv * b2, e2 + self._qo_xf * b1

    # ------------------------------------------------------------------
    def _y_extended(self, arr, pad: int):
        """The active y range of a cell [.., n3, n2, n1] or face array
        extended by ``pad`` cells on each side from the x2 neighbours."""
        mesh = self.mesh
        mbi = mesh.mb_indcs
        ng = mbi.ng
        ja = arr.ndim - 2
        n2 = arr.shape[ja]
        lo = mesh.tables.gather(arr.narrow(ja, n2 - ng - pad, pad),
                                mesh.nbr_gid["x2m"])
        hi = mesh.tables.gather(arr.narrow(ja, ng, pad),
                                mesh.nbr_gid["x2p"])
        mid = arr.narrow(ja, mbi.js, mbi.nx2)
        return torch.cat([lo, mid, hi], dim=ja)

    def _shift_cells(self, dt: float):
        """-q Om x1 dt / dy of each block's active x1 columns, on the host
        in the state's dtype and in the device's order of operations."""
        nt = np.float32 if self.dtype == torch.float32 else np.float64
        mbi = self.mesh.mb_indcs
        x1 = self.xc[..., mbi.is_:mbi.ie + 1].astype(nt)
        qo = nt(-(self.qshear * self.omega0))
        return (qo * x1 * nt(dt)) / self.dyb.astype(nt)[:, None]

    def check_shift(self, dt) -> None:
        """Raise unless this cycle's integer shift lies where the gathers
        of ``orbital_advect`` stay inside the extended profile: from
        -(maxjshift + 1) to maxjshift cells (``_eff_emf``'s truncated
        shift is bounded by the same).  ``dt`` may be a tensor: this
        check reads it on the host (it closes the window's graph)."""
        dt = float(dt)
        jo = np.floor(self._shift_cells(dt))
        m = self.maxjshift
        if jo.min() < -(m + 1) or jo.max() > m:
            ms = self.mesh.mesh_size
            xmax = max(abs(ms.x1min), abs(ms.x1max))
            raise ValueError(
                f"orbital advection: dt={dt:.6e} shifts x1-columns by "
                f"{int(jo.min())}..{int(jo.max())} cells (q Om |x1|max "
                f"dt / dy = {self.qshear * self.omega0 * xmax * dt / float(self.dyb.min()):.6e}), beyond "
                f"maxjshift={m} (time/cfl_number and the x1 extent set "
                "it)")

    def orbital_advect(self, u, dt):
        """Advect every x1-column by the orbital displacement
        dy = -q Om x1 dt (reference: orbital_advection_cc.cpp:240-290);
        the profile is extended by maxjshift+2 neighbour cells first, so
        any y decomposition works.  Returns a new tensor whose active x1
        columns are advected; its x1 ghost columns keep their old values
        (the fill that follows writes them; the JAX package advects them
        too, through clamped gathers, before the same fill)."""
        if not self.oa_active:
            return u
        self.check_shift(dt)
        mbi = self.mesh.mb_indcs
        js, nx2, is_, nx1 = mbi.js, mbi.nx2, mbi.is_, mbi.nx1
        pad = self.maxjshift + 2
        ja = u.ndim - 2
        ext = self._y_extended(u.narrow(-1, is_, nx1), pad)
        dtt = torch.as_tensor(dt, dtype=u.dtype, device=u.device)
        shift = (-(self.qshear * self.omega0)
                 * self._xc[..., is_:is_ + nx1] * dtt) / self._dyb[:, None]
        jo = torch.floor(shift).to(torch.int64)
        eps = shift - jo.to(u.dtype)
        jgrid = _axis_index(torch.arange(pad, pad + nx2, device=u.device),
                            u.ndim, ja)
        shp = ext.shape[:ja] + (nx2,) + ext.shape[ja + 1:]
        base = jgrid - jo                     # [nmb, 1, 1, nx2, nx1]

        def at(off):
            return torch.gather(ext, ja, (base + off).expand(shp))

        g, gm, gmm, gp = at(0), at(-1), at(-2), at(1)
        # the fractional flux through j-1/2 and j+1/2 (eps in [0, 1))
        dl, dr = gm - gmm, g - gm
        sig_m = torch.where(dl * dr > 0.0,
                            2.0 * dl * dr / (dl + dr + _TINY),
                            torch.zeros_like(g))
        flux = eps * (gm + 0.5 * (1.0 - eps) * sig_m)
        dl2, dr2 = g - gm, gp - g
        sig = torch.where(dl2 * dr2 > 0.0,
                          2.0 * dl2 * dr2 / (dl2 + dr2 + _TINY),
                          torch.zeros_like(g))
        flux_p = eps * (g + 0.5 * (1.0 - eps) * sig)
        out = u.clone()
        out.narrow(ja, js, nx2).narrow(-1, is_, nx1).copy_(
            g - (flux_p - flux))
        return out

    # ------------------------------------------------------------------
    def _eff_emf(self, arr, x1, dt):
        """Effective EMF at y-faces js..je+1 of a y-profile of B sampled
        like ``arr`` ([nmb, n3c, n2c, nX]): emf(j) = flx(j - jo) plus the
        sum over the jo cells crossed (a difference of cumulative sums;
        the sign handles jo < 0)."""
        nx2 = self.mesh.mb_indcs.nx2
        pad = self.maxjshift + 2
        ja = 2
        shift = (-(self.qshear * self.omega0) * x1[:, 0] * dt) / self._dyb
        jo = torch.trunc(shift).to(torch.int64)
        eps = shift - jo.to(shift.dtype)
        ext = self._y_extended(arr, pad)
        flx = _remap_flux(ext, eps, ja)
        csum = torch.cumsum(ext, dim=ja)
        tgt = torch.arange(pad, pad + nx2 + 1,
                           device=arr.device).reshape(1, 1, -1, 1)
        shp = ext.shape[:ja] + (nx2 + 1,) + ext.shape[ja + 1:]
        f_sh = torch.gather(flx, ja, (tgt - jo).expand(shp))
        c_hi = torch.gather(csum, ja, (tgt - 1).expand(shp))
        c_lo = torch.gather(csum, ja, (tgt - jo - 1).expand(shp))
        return f_sh + (c_hi - c_lo)

    def orbital_advect_fc(self, bfc, dt):
        """EMF-form orbital advection of the face field (reference:
        orbital_advection_fc.cpp:180-361, after Stone & Gardiner 2010
        eqs. 49-52): the y-remaps of B1 and B3 become effective
        (time-integrated, dy-normalised) EMFs, and a CT curl applies
        them, so div(B) is kept to round-off.  Returns a new dict; as in
        ``orbital_advect`` only the active x1 columns (and their x1
        faces) move, and the fill that follows writes the ghosts.  Call
        it after ``orbital_advect``, which checks the shift."""
        if not self.oa_active:
            return bfc
        mesh = self.mesh
        mbi = mesh.mb_indcs
        js, je, ks, ke = mbi.js, mbi.je, mbi.ks, mbi.ke
        is_, nx1, nx2 = mbi.is_, mbi.nx1, mbi.nx2
        ms = mesh.mesh_size
        x1f, x2f, x3f = bfc["x1f"], bfc["x2f"], bfc["x3f"]
        dtt = torch.as_tensor(dt, dtype=x1f.dtype, device=x1f.device)
        # emfz = +Vy Bx at the x1 faces (the B1 profile):
        # [nmb, n3c, nx2+1, nx1+1], y index 0..nx2 <-> faces js..je+1
        emfz = self._eff_emf(x1f.narrow(-1, is_, nx1 + 1),
                             self._xf[..., is_:is_ + nx1 + 1], dtt)
        # emfx = -Vy Bz at the x1 centres (the B3 profile), x3 faces
        emfx = -self._eff_emf(x3f.narrow(-1, is_, nx1),
                              self._xc[..., is_:is_ + nx1], dtt)
        # the CT update over the active region (reference:
        # orbital_advection_fc.cpp oaCT-b1/b2/b3 loops)
        ii = slice(is_, is_ + nx1)
        nb1 = x1f.clone()
        nb1[:, ks:ke + 1, js:je + 1, is_:is_ + nx1 + 1] += \
            -(emfz[:, ks:ke + 1, 1:nx2 + 1] - emfz[:, ks:ke + 1, 0:nx2])
        dydx = self.dy / ms.dx1       # the same ratio on every level
        dydz = self.dy / ms.dx3
        d_emfz = emfz[..., 1:] - emfz[..., :-1]        # x1 cell centres
        d_emfx = emfx[:, 1:] - emfx[:, :-1]
        nb2 = x2f.clone()
        nb2[:, ks:ke + 1, js:je + 2, ii] += dydx * d_emfz[:, ks:ke + 1]
        nb2[:, ks:ke + 1, js:je + 2, ii] += -dydz * d_emfx[:, ks:ke + 1]
        nb3 = x3f.clone()
        nb3[:, ks:ke + 2, js:je + 1, ii] += \
            emfx[:, ks:ke + 2, 1:nx2 + 1] - emfx[:, ks:ke + 2, 0:nx2]
        return {"x1f": nb1, "x2f": nb2, "x3f": nb3}

    # ------------------------------------------------------------------
    def _window(self, lo: int, hi: int, n2b: int, ndim: int, ja: int,
                device):
        """Each block's window [lx2*nx2 + lo, lx2*nx2 + hi) of global-y
        samples of a ring of ``n2b`` blocks (periodic), shaped for a
        gather along ``ja``; made once a shape and device for every
        block, read as the running cycle's rows."""
        key = (lo, hi, n2b, ndim, ja, str(device))
        if key not in self._win:
            nx2 = self.mesh.mb_indcs.nx2
            lx2 = np.asarray(self.mesh.lloc_eachmb[:, 1])
            win = (np.arange(lo, hi)[None, :]
                   + (lx2 * nx2)[:, None]) % (n2b * nx2)
            shape = (-1,) + (1,) * (ja - 1) + (hi - lo,) \
                + (1,) * (ndim - 1 - ja)
            self._win[key] = torch.as_tensor(
                win, dtype=torch.int64, device=device).reshape(shape)
        return local_blocks(self._win[key])

    def _ring_remap(self, u, side: str, s_phys, slab, ja: int,
                    win_lo: int, win_hi: int):
        """The sheared window of each boundary block of ``side``: the
        opposite column's ring (one level's gids, ``slab`` of each block
        concatenated in y) shifted by ``s_phys`` (physical y units, each
        level dividing by its own dy) and cut to the block's window.
        Returns the window rows, valid on ``side``'s boundary blocks."""
        out = None
        tables = self.mesh.tables
        for lv, _ring, lmask, cols in self.ring[side]:
            ring = torch.cat([tables.gather(slab, c) for c in cols], dim=ja)
            shifted = _plm_remap(ring, s_phys / (self.dy / (2.0 ** lv)), ja)
            idx = self._window(win_lo, win_hi, len(cols), u.ndim, ja,
                               u.device)
            shp = shifted.shape[:ja] + (win_hi - win_lo,) \
                + shifted.shape[ja + 1:]
            win = torch.gather(shifted, ja, idx.expand(shp))
            if out is None:
                out = win
            else:
                out = torch.where(
                    tables.mask(lmask, win.ndim, u.device), win, out)
        return out

    def remap_ghosts(self, u, t):
        """Shift the shear-periodic x1 ghost slabs of ``u`` in y by
        +/- q Om Lx t (reference: shearing_box_cc.cpp:63-140), in place
        (the y-corner rows of the slab too); returns ``u``."""
        if not self.oa_active:
            return u
        mbi = self.mesh.mb_indcs
        ng, n1, n2 = mbi.ng, mbi.ncells1, mbi.ncells2
        js, nx2 = mbi.js, mbi.nx2
        yshear = self.qshear * self.omega0 * self.lx * t
        ja = u.ndim - 2
        for side, sgn, src0, dst0 in (("m", 1.0, n1 - 2 * ng, 0),
                                      ("p", -1.0, ng, n1 - ng)):
            if side not in self.ring:
                continue
            slab = u[..., js:js + nx2, src0:src0 + ng]
            win = self._ring_remap(u, side, sgn * yshear, slab, ja,
                                   -ng, n2 - ng)
            cur = u[..., dst0:dst0 + ng]
            mb = self.mesh.tables.mask(self._bmask[side], u.ndim, u.device)
            cur.copy_(torch.where(mb, win, cur))
        return u

    def remap_ghosts_fc(self, bfc, t):
        """The face field's shear-periodic ghost slabs, remapped in y like
        the cell variables (reference: shearing_box_fc.cpp:60-140), in
        place; the shared x1 faces stay the block's own.  Returns
        ``bfc``."""
        if not self.oa_active:
            return bfc
        mbi = self.mesh.mb_indcs
        ng, nxa, n2c = mbi.ng, mbi.nx1, mbi.ncells2
        js, nx2 = mbi.js, mbi.nx2
        yshear = self.qshear * self.omega0 * self.lx * t
        for comp, arr in bfc.items():
            n1 = arr.shape[3]
            # the window is one sample longer for x2f (face layout); its
            # ring drops the duplicated closing face
            extra = 1 if comp == "x2f" else 0
            for side, sgn in (("m", 1.0), ("p", -1.0)):
                if side not in self.ring:
                    continue
                if comp == "x1f":
                    # the ghost faces strictly beyond the shared face
                    dn0, my0 = (nxa, 0) if side == "m" \
                        else (ng + 1, nxa + ng + 1)
                else:
                    dn0, my0 = (n1 - 2 * ng, 0) if side == "m" \
                        else (ng, n1 - ng)
                slab = arr[:, :, js:js + nx2, dn0:dn0 + ng]
                win = self._ring_remap(arr, side, sgn * yshear, slab, 2,
                                       -ng, n2c - ng + extra)
                cur = arr[..., my0:my0 + ng]
                mb = self.mesh.tables.mask(self._bmask[side], 4, arr.device)
                cur.copy_(torch.where(mb, win, cur))
        return bfc
