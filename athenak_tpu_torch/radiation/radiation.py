"""General-relativistic radiation transport: frequency-integrated
intensities on the geodesic angular grid, on torch tensors.

Counterpart of ``athenak_tpu/radiation/radiation.py`` (reference:
src/radiation/radiation.hpp:31-137, radiation_fluxes.cpp,
radiation_update.cpp, radiation_tetrad.cpp, radiation_source.cpp):

  * the evolved variable i0(n) = n^0 n_0 I for every angle n of the
    geodesic grid, n^mu = e_(a)^mu nh^(a) with the CKS orthonormal
    tetrad, held as [nmb, nangles, n3, n2, n1] (the angles are channels);
  * the "primitive" intensity n_0 I = i0 / n^0, n^0 = e_(0)^0 for every
    angle (the spatial legs have no time component);
  * spatial transport by PLM upwind fluxes F^d = n^d (n_0 I) with n^d
    from the face tetrads; angular transport (``angular_fluxes``) by the
    edge speeds na from the Ricci rotation coefficients and a divergence
    over the geodesic dual cells, two gathers along the angle axis;
  * the gray relaxation ``source`` of a radiation-only run and the
    intensity floor with the horizon excision; the implicit coupling to
    a fluid lives in ``coupling.py``, driven by ``rad_fluid.py``.

The geometry tables (n^0, n_0, the face n^d, na, and lazily n_mu, n^mu,
the covariant tetrad and the normal-to-tetrad map) are built once, on the
run's device, in float64 from the same closed forms, and kept at the
run's dtype (the JAX package builds them in numpy float64 on the host).
Where the tetrad is the same in every cell (flat space in Cartesian
coordinates, the default geometry) each table is evaluated at one cell
and broadcast (``expand``, no memory), with the same values.  Problem
generators may replace the geometry (``set_geometry``: the snake).

The radiation path has no kernel of its own: the ghost fills of i0 (and
of the coupled fluid's u) take kernels B and G where ``bvals.py``'s gates
admit them (a single fully periodic 3-D block, or a same-level periodic
pool, in float32 on the card).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..comm import LocalAttr, local_tree
from .geodesic_grid import GeodesicGrid

_SYM10 = [(0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3),
          (2, 2), (2, 3), (3, 3)]


class Radiation:
    """<radiation> transport (reference: the Radiation module)."""

    # per-block geometry read as the running cycle's rows (comm.LocalAttr;
    # the JAX package's _lb, radiation.py:41-48)
    dirs = LocalAttr()
    n0 = LocalAttr()
    n_0 = LocalAttr()
    nd_face = LocalAttr()
    na = LocalAttr()
    excise_mask = LocalAttr()
    beam_dii0 = LocalAttr()

    is_mhd = False

    def __init__(self, pin, mesh, bvals, device, dtype) -> None:
        from ..coordinates import Coordinates
        from .tetrad import norm_to_tet, ricci_rotation, tetrad

        self.mesh = mesh
        self.bvals = bvals
        self.device = torch.device(device)
        self.dtype = dtype
        nlevel = pin.get_or_add_integer("radiation", "nlevel", 2)
        self.multilevel = bool(getattr(mesh, "multilevel", False))
        self.grid = GeodesicGrid(nlevel)
        self.nvar = self.nangles = self.grid.nangles

        # Minkowski unless <coord> asks for GR on Kerr-Schild
        self.coord = Coordinates(pin)
        cd = self.coord.coord_data
        self.is_gr = self.coord.is_general_relativistic
        self.minkowski = (not self.is_gr) or cd.is_minkowski
        self.spin = 0.0 if self.minkowski else cd.bh_spin
        self.excise = bool(getattr(cd, "bh_excise", False)) \
            and not self.minkowski

        # angular fluxes need the edge tables (nlevel >= 1) and curvature
        default_af = (not self.minkowski) and self.grid.has_edges
        self.angular_fluxes = pin.get_or_add_boolean(
            "radiation", "angular_fluxes", default_af)
        if self.angular_fluxes and not self.grid.has_edges:
            raise ValueError("angular_fluxes requires nlevel >= 1")

        # gray opacities (power-law opacities through power_opacity)
        self.kappa_a = pin.get_or_add_real("radiation", "kappa_a", 0.0)
        self.kappa_s = pin.get_or_add_real("radiation", "kappa_s", 0.0)
        self.kappa_p = pin.get_or_add_real("radiation", "kappa_p", 0.0)
        self.power_opacity = pin.get_or_add_boolean(
            "radiation", "power_opacity", False)
        self.arad = pin.get_or_add_real("radiation", "arad", 1.0)
        self.is_compton = pin.get_or_add_boolean("radiation", "compton",
                                                 False)
        if self.is_compton:
            # the electron rest-mass temperature in code units needs the
            # units (reference: radiation.cpp:81-86)
            if not pin.does_block_exist("units"):
                raise ValueError(
                    "<radiation>/compton requires enabling units "
                    "(a <units> block)")
            from ..units import ELECTRON_REST_MASS_ENERGY_CGS, Units
            self.inv_t_electron = (Units(pin).temperature_cgs
                                   / ELECTRON_REST_MASS_ENERGY_CGS)
        self.fixed_fluid = pin.get_or_add_boolean("radiation",
                                                  "fixed_fluid", False)
        self.affect_fluid = pin.get_or_add_boolean("radiation",
                                                   "affect_fluid", True)
        self.n_0_floor = pin.get_or_add_real("radiation", "n_0_floor", 0.05)
        self.recon_method = pin.get_or_add_string("radiation",
                                                  "reconstruct", "plm")

        mbi = mesh.mb_indcs
        nmb = mesh.nmb_total
        self.shape = (nmb, self.nvar, mbi.ncells3, mbi.ncells2, mbi.ncells1)
        if self.multilevel:
            dx = {n: torch.as_tensor(mesh.mb_size[f"d{n}"], dtype=dtype,
                                     device=self.device).reshape(
                                         -1, 1, 1, 1, 1)
                  for n in ("x1", "x2", "x3")}
        else:
            ms = mesh.mesh_size
            dx = {"x1": ms.dx1, "x2": ms.dx2, "x3": ms.dx3}
        self.dirs = [("x1", 4, 0, dx["x1"])]
        if mbi.nx2 > 1:
            self.dirs.append(("x2", 3, 1, dx["x2"]))
        if mbi.nx3 > 1:
            self.dirs.append(("x3", 2, 2, dx["x3"]))

        # angle tables: nh^(a) with nh^(0) = 1 (host), weights and solid
        # angles [1, nangles, 1, 1, 1] at the run's dtype
        self.nh4 = np.concatenate([np.ones((self.nangles, 1)),
                                   self.grid.nh], axis=1)
        self.wgt = self._angles(self.grid.weights)
        self.sang = self._angles(self.grid.solid_angles)
        self.nh_b = [self._angles(self.nh4[:, a]) for a in range(4)]

        # cell-centre and face coordinates of every block (host)
        xv = np.empty((nmb, mbi.ncells1))
        yv = np.empty((nmb, mbi.ncells2))
        zv = np.empty((nmb, mbi.ncells3))
        xf = np.empty((nmb, mbi.ncells1 + 1))
        yf = np.empty((nmb, mbi.ncells2 + 1))
        zf = np.empty((nmb, mbi.ncells3 + 1))
        for g in range(nmb):
            xv[g], yv[g], zv[g] = mesh.cell_centers(g)
            xf[g], yf[g], zf[g] = mesh.face_edges(g)
        self._coords = (xv, yv, zv, xf, yf, zf)

        # the geometry functions (set_geometry replaces them)
        self._tet_fn = lambda X, Y, Z: tetrad(X, Y, Z, self.spin,
                                              self.minkowski)
        self._ricci_fn = lambda X, Y, Z: ricci_rotation(
            X, Y, Z, self.spin, self.minkowski)
        self._n2t_fn = lambda X, Y, Z: norm_to_tet(X, Y, Z, self.spin,
                                                   self.minkowski)
        self._uniform = self.minkowski
        self._build_tet_fields()
        if self.angular_fluxes:
            self._build_angular_speeds()

        self.time_evolution = "dynamic"
        self.pturb = self.ppart = self.psbox = self.pgrav = None
        self.eos = None
        self.srcterms_func = None
        self.user_hist_func = None
        # a beam source (rad_beam, rad_snake): dii0 [nmb, nangles, n3,
        # n2, n1] added at beta_dt a stage
        self.beam_dii0 = None

    # ------------------------------------------------------------------
    def _angles(self, v):
        """A host [nangles] table as [1, nangles, 1, 1, 1] at the run's
        dtype on its device."""
        return torch.as_tensor(np.asarray(v), dtype=self.dtype,
                               device=self.device).reshape(1, -1, 1, 1, 1)

    def _nh(self, a):
        """nh^(a) as a float64 [1, nangles, 1, 1, 1] tensor."""
        return torch.as_tensor(self.nh4[:, a], dtype=torch.float64,
                               device=self.device).reshape(1, -1, 1, 1, 1)

    def _points(self, x, y, z):
        """float64 coordinate tensors [nmb, 1, n3, n2, n1] (broadcast
        views) from the host rows x [nmb, n1], y [nmb, n2], z [nmb, n3];
        one cell of block 0 where the geometry is uniform.  Returns
        (X, Y, Z, full shape)."""
        shape = (x.shape[0], 1, z.shape[1], y.shape[1], x.shape[1])
        if self._uniform:
            x, y, z = x[:1, :1], y[:1, :1], z[:1, :1]

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float64,
                                   device=self.device)

        X = dev(x)[:, None, None, None, :]
        Y = dev(y)[:, None, None, :, None]
        Z = dev(z)[:, None, :, None, None]
        return X, Y, Z, shape

    def _keep(self, t, shape):
        """A float64 table -> the run's dtype, broadcast to ``shape``
        (a view where the geometry is uniform)."""
        t = torch.as_tensor(t, dtype=torch.float64, device=self.device)
        t = t.to(self.dtype)
        if self._uniform:
            return t.expand(shape)
        return torch.broadcast_to(t, shape).contiguous()

    def _contract(self, comps, shape):
        """sum_a comps[a] nh^(a) over the tetrad legs (the JAX package's
        order), kept at [nmb, nangles, ...] of ``shape``."""
        out = sum(comps[a] * self._nh(a) for a in range(4))
        return self._keep(out, (shape[0], self.nangles) + shape[2:])

    def _build_tet_fields(self) -> None:
        xv, yv, zv, xf, yf, zf = self._coords
        X, Y, Z, shape = self._points(xv, yv, zv)
        e, ecov = self._tet_fn(X, Y, Z)
        self.n0 = self._keep(e[0][0], shape)
        self.n_0 = self._contract([ecov[a][0] for a in range(4)], shape)
        self._n_mu = None      # n_mu, n^mu and the frame maps: lazily
        self.nd_face = {}
        for name, _ax, d, _dx in self.dirs:
            if name == "x1":
                Xf, Yf, Zf, fshape = self._points(xf, yv, zv)
            elif name == "x2":
                Xf, Yf, Zf, fshape = self._points(xv, yf, zv)
            else:
                Xf, Yf, Zf, fshape = self._points(xv, yv, zf)
            ef, _ = self._tet_fn(Xf, Yf, Zf)
            self.nd_face[name] = self._contract(
                [ef[a][d + 1] for a in range(4)], fshape)
        # excision: the KS radius inside the horizon
        if self.excise:
            r2 = X * X + Y * Y + Z * Z
            a2 = self.spin * self.spin
            rks = torch.sqrt((r2 - a2 + torch.sqrt((r2 - a2) ** 2
                                                   + 4.0 * a2 * Z * Z))
                             / 2.0)
            rh = 1.0 + math.sqrt(max(1.0 - a2, 0.0))
            self.excise_mask = torch.broadcast_to(
                rks <= rh, shape)[:, 0].contiguous()
        else:
            self.excise_mask = None

    def _build_angular_speeds(self) -> None:
        """Edge advection speeds na [nmb, nangles, nmax, n3, n2, n1] from
        the Ricci rotation coefficients (reference:
        radiation_tetrad.cpp:180-220); zero on the padded edges of the
        pentagon angles."""
        g = self.grid
        xv, yv, zv = self._coords[:3]
        X, Y, Z, shape = self._points(xv, yv, zv)
        om = self._ricci_fn(X[:, 0], Y[:, 0], Z[:, 0])
        cells = torch.broadcast_shapes(*(om[i][j][k].shape
                                         for i in (0, 1, 2, 3)
                                         for j in range(4)
                                         for k in range(4)))
        ncell = math.prod(cells)

        def stack(i):
            # omega[i][q][p] as [16, cells] (q, p flattened)
            return torch.stack([torch.broadcast_to(
                torch.as_tensor(om[i][q][p], dtype=torch.float64,
                                device=self.device), cells).reshape(ncell)
                for q in range(4) for p in range(4)])

        nmax = g.ind_neighbors.shape[1]
        valid = np.arange(nmax)[None, :] < g.num_neighbors[:, None]
        nhf = np.concatenate([np.ones((self.nangles, nmax, 1)),
                              g.cart_pos_mid], axis=2)   # [nang, nmax, 4]
        iszetaf = 1.0 / np.sqrt(np.where(valid, 1.0 - nhf[..., 3] ** 2,
                                         1.0))
        wqp = (nhf[..., :, None] * nhf[..., None, :]).reshape(-1, 16)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=torch.float64, device=self.device)

        w = dev(wqp)
        n0f, n1f, n2f, n3f = (dev(nhf[..., q].reshape(-1, 1))
                              for q in range(4))
        om0, om1, om2, om3 = (stack(i) for i in range(4))
        na1 = n0f * (w @ om3) - n3f * (w @ om0)
        na2 = n2f * (w @ om1) - n1f * (w @ om2)
        na = (dev((iszetaf * g.unit_flux[..., 0] * valid).reshape(-1, 1))
              * na1 + dev((g.unit_flux[..., 1] * valid).reshape(-1, 1))
              * na2)
        na = na.reshape((self.nangles, nmax) + tuple(cells))
        na = torch.movedim(na, 2, 0).to(self.dtype)
        nshape = (shape[0], self.nangles, nmax) + shape[2:]
        self.na = torch.broadcast_to(na, nshape).contiguous()
        self._nbr = [torch.as_tensor(g.ind_neighbors[:, nb].astype(np.int64),
                                     device=self.device)
                     for nb in range(nmax)]
        self._arc = [self._angles(g.arc_lengths[:, nb])
                     for nb in range(nmax)]

    # ------------------------------------------------------------------
    def set_geometry(self, tet_fn, ricci_fn=None, n2t_fn=None) -> None:
        """Per-cell metric and tetrad from user functions: every derived
        table is rebuilt (reference: the rad_snake problem generator
        overwrites tet_c, tetcov_c and na per cell,
        src/pgen/radiation/rad_snake.cpp:60-240).  ``tet_fn(X, Y, Z) ->
        (e, ecov)`` as ``tetrad.tetrad``, ``ricci_fn(X, Y, Z) ->
        omega[4][4][4]`` as ``ricci_rotation``, ``n2t_fn`` as
        ``norm_to_tet`` (the fluid coupling's only); X, Y, Z are float64
        tensors."""
        self._tet_fn = tet_fn
        if ricci_fn is not None:
            self._ricci_fn = ricci_fn
        if n2t_fn is not None:
            self._n2t_fn = n2t_fn
        self._uniform = False
        self._build_tet_fields()
        if self.angular_fluxes:
            self._build_angular_speeds()

    def tet_quantities(self):
        """(n0 [nmb, 1, ...], n_0 [nmb, nangles, ...], n_mu [4], the
        normal-to-tetrad map [4][4] of [nmb, n3, n2, n1]) for the problem
        generators and the coupling; n_mu, n^mu, the covariant tetrad and
        the map are made at the first call."""
        if self._n_mu is None:
            xv, yv, zv = self._coords[:3]
            X, Y, Z, shape = self._points(xv, yv, zv)
            e, ecov = self._tet_fn(X, Y, Z)
            self._n_mu = [self._contract([ecov[a][c] for a in range(4)],
                                         shape) for c in range(4)]
            self._n_up = [self._contract([e[a][c] for a in range(4)],
                                         shape) for c in range(4)]
            cshape = (shape[0],) + shape[2:]
            self._ecov = [[self._keep(ecov[a][c], shape)[:, 0]
                           for c in range(4)] for a in range(4)]
            n2t = self._n2t_fn(X[:, 0], Y[:, 0], Z[:, 0])
            self._n2t = [[self._keep(n2t[a][nu], cshape) for nu in range(4)]
                         for a in range(4)]
        return self.n0, self.n_0, local_tree(self._n_mu), \
            local_tree(self._n2t)

    # ------------------------------------------------------------------
    def fluxes(self, i0):
        """PLM upwind transport fluxes F^d = n^d (n_0 I), entry i the
        flux through the lower face of cell i (reference:
        radiation_fluxes.cpp:27-220)."""
        prim = i0 / self.n0
        out = {}
        for name, axis, _d, _dx in self.dirs:
            nd = self.nd_face[name]
            ndc = nd.narrow(axis, 0, nd.shape[axis] - 1)
            im1 = torch.roll(prim, 1, dims=axis)
            ip1 = torch.roll(prim, -1, dims=axis)
            im2 = torch.roll(prim, 2, dims=axis)
            # the PLM states at face i, between cells i-1 and i
            dql = im1 - im2
            dqr = prim - im1
            dq2 = dql * dqr
            dqm = torch.where(dq2 <= 0.0, 0.0,
                              2.0 * dq2 / (dql + dqr + 1e-300))
            il = im1 + 0.5 * dqm
            dql2 = prim - im1
            dqr2 = ip1 - prim
            dq22 = dql2 * dqr2
            dqm2 = torch.where(dq22 <= 0.0, 0.0,
                               2.0 * dq22 / (dql2 + dqr2 + 1e-300))
            ir = prim - 0.5 * dqm2
            out[name] = torch.where(ndc > 0.0, ndc * il, ndc * ir)
        return out

    def divfa(self, i0):
        """The angular flux divergence over the dual cells (reference:
        radiation_fluxes.cpp:225-246): the upwind neighbour of every
        edge gathered along the angle axis.  A pentagon's padded sixth
        edge points at the angle itself with zero arc length and zero
        speed, so it adds nothing."""
        prim = i0 / self.n0
        out = 0.0
        for nb, idx in enumerate(self._nbr):
            na = self.na[:, :, nb]
            nbr = prim.index_select(1, idx)
            upw = torch.where(na < 0.0, nbr, prim)
            out = out + self._arc[nb] * na * upw
        return out / self.sang

    # ------------------------------------------------------------------
    def rk_update(self, i0, i1, flx, gam0, gam1, beta_dt):
        """gam0 i0 + gam1 i1 - beta_dt (div F + the angular divergence),
        with the flux correction on a refined mesh."""
        if self.multilevel:
            from ..refinement import flux_correct_cc
            flx = flux_correct_cc(flx, self.mesh, [d[0] for d in self.dirs])
        divf = None
        for name, axis, _d, dx in self.dirs:
            f = flx[name]
            d = (torch.roll(f, -1, dims=axis) - f) / dx
            divf = d if divf is None else divf + d
        out = gam0 * i0 + gam1 * i1 - beta_dt * divf
        if self.angular_fluxes:
            out = out - beta_dt * self.divfa(i0)
        return out

    def source(self, i0, beta_dt):
        """The implicit gray relaxation of a radiation-only run against a
        fixed medium (the radiation-only limit of the coupling)."""
        if self.kappa_a == 0.0 and self.kappa_s == 0.0:
            return i0
        prim = i0 / self.n0
        J = torch.sum(self.wgt * prim, dim=1, keepdim=True)
        ka, ks = self.kappa_a, self.kappa_s
        denom = 1.0 + beta_dt * (ka + ks)
        return self.n0 * (prim + beta_dt * ks * J) / denom

    def floor(self, i0):
        """I >= 0 through the primitive (n_0 < 0, so i0 <= 0 where n^0 >
        0), and zero intensity in the excised cells and at angles with
        |n_0| below ``n_0_floor`` there."""
        nn = self.n0 * self.n_0
        i0 = nn * torch.clamp(i0 / nn, min=0.0)
        if self.excise_mask is not None:
            i0 = torch.where(self.excise_mask[:, None], 0.0, i0)
            i0 = torch.where(torch.abs(self.n_0) < self.n_0_floor, 0.0, i0)
        return i0

    def add_beam(self, i0, beta_dt):
        """The beam source's injection over a stage."""
        if self.beam_dii0 is None:
            return i0
        return i0 + beta_dt * self.beam_dii0

    # ------------------------------------------------- state-dict interface
    def make_state(self, i0):
        return {"u": i0, "w": i0}

    def save_state(self, state):
        return {"u1": state["u"]}

    def accumulate_rk4(self, saved, state, delta):
        return {"u1": saved["u1"] + delta * state["u"]}

    def unpack_state(self, state):
        return state

    def init_ghosts(self, state):
        i0 = self.bvals.fill_ghosts(state["u"])
        return dict(state, u=i0, w=i0)

    def stage_update(self, state, saved, gam0, gam1, beta_dt):
        i0 = state["u"]
        flx = self.fluxes(i0)
        i0 = self.rk_update(i0, saved["u1"], flx, gam0, gam1, beta_dt)
        i0 = self.source(i0, beta_dt)
        i0 = self.floor(self.add_beam(i0, beta_dt))
        i0 = self.bvals.fill_ghosts(i0)
        return dict(state, u=i0, w=i0), {}

    def dt_from_state(self, state):
        """The light-speed CFL bound: the smallest cell size (reference:
        radiation_newdt.cpp)."""
        mbi = self.mesh.mb_indcs
        names = ["x1"] + (["x2"] if mbi.nx2 > 1 else []) \
            + (["x3"] if mbi.nx3 > 1 else [])
        if self.multilevel:
            dt = min(float(np.min(self.mesh.mb_size[f"d{n}"]))
                     for n in names)
        else:
            ms = self.mesh.mesh_size
            dt = min(getattr(ms, f"d{n}") for n in names)
        # filled in on the device: no host copy in the cycle
        return torch.full((), dt, dtype=state["u"].dtype,
                          device=state["u"].device)

    # ------------------------------------------------------------- moments
    def moments(self, i0):
        """Coordinate-frame (E, [F^1, F^2, F^3]) = (R^00, R^0i): the sums
        over angles of I (n^0)^2 dOmega and I n^0 n^i dOmega, n^i the
        mean of the two face values."""
        II = i0 / (self.n0 * self.n_0)
        E = torch.sum(self.sang * II * self.n0 * self.n0, dim=1)
        F = []
        for name, axis, _d, _dx in self.dirs:
            nd = self.nd_face[name]
            n = nd.shape[axis] - 1
            ndc = 0.5 * (nd.narrow(axis, 0, n) + nd.narrow(axis, 1, n))
            F.append(torch.sum(self.sang * II * self.n0 * ndc, dim=1))
        while len(F) < 3:
            F.append(torch.zeros_like(E))
        return E, F

    def coord_moments(self, state):
        """(labels, [nmb, 10, ...]) of the symmetric coordinate-frame
        moments R^{munu} (the rad_coord output; reference:
        derived_variables.cpp:1076-1143)."""
        i0 = state["u"] if "u" in state else state["i0"]
        return ([f"r{a}{b}" for a, b in _SYM10],
                torch.stack(self._moments10(i0), dim=1))

    def _moments10(self, i0):
        """R^{munu} = sum over angles of I n^mu n^nu dOmega."""
        self.tet_quantities()
        II = i0 / (self.n0 * self.n_0)
        return [torch.sum(self.sang * II * self._n_up[a] * self._n_up[b],
                          dim=1) for a, b in _SYM10]

    def metric_cc(self):
        """The cell-centre (glower, gupper) [nmb, n3, n2, n1] at the run's
        dtype, from float64, made once."""
        if getattr(self, "_gcc", None) is None:
            from ..gr import cks
            xv, yv, zv = self._coords[:3]
            X, Y, Z, shape = self._points(xv, yv, zv)
            gl, gu = cks.metric(X[:, 0], Y[:, 0], Z[:, 0], self.spin,
                                self.minkowski)
            cshape = (shape[0],) + shape[2:]
            self._gcc = tuple([[self._keep(g[i][j], cshape)
                                for j in range(4)] for i in range(4)]
                              for g in (gl, gu))
        return local_tree(self._gcc)

    def fluid_moments(self, i0, w, gl=None):
        """(labels, [nmb, 10, ...]) fluid-frame moments: R^{munu} taken
        to the tetrad frame (the covariant tetrad, the 0i signs flipped)
        and boosted into the fluid's rest frame (reference:
        derived_variables.cpp:1145-1260)."""
        Rs = self._moments10(i0)
        idx = {p: c for c, p in enumerate(_SYM10)}

        def Rc(a, b):
            return Rs[idx[(a, b) if a <= b else (b, a)]]

        ec = self._ecov
        Rt = {}
        for c, (a, b) in enumerate(_SYM10):
            v = 0.0
            for m1 in range(4):
                for m2 in range(4):
                    v = v + ec[a][m1] * ec[b][m2] * Rc(m1, m2)
            Rt[(a, b)] = -v if c in (1, 2, 3) else v

        def Rtet(a, b):
            return Rt[(a, b) if a <= b else (b, a)]

        if gl is None:
            gl = self.metric_cc()[0]
        uu = (w[:, 1], w[:, 2], w[:, 3])
        q = (gl[1][1] * uu[0] ** 2 + gl[2][2] * uu[1] ** 2
             + gl[3][3] * uu[2] ** 2
             + 2.0 * (gl[1][2] * uu[0] * uu[1] + gl[1][3] * uu[0] * uu[2]
                      + gl[2][3] * uu[1] * uu[2]))
        u4 = (torch.sqrt(1.0 + q),) + uu
        n2t = self._n2t
        ut = [sum(n2t[a][nu] * u4[nu] for nu in range(4)) for a in range(4)]
        L = [[None] * 4 for _ in range(4)]
        L[0][0] = ut[0]
        for a in range(1, 4):
            L[0][a] = L[a][0] = -ut[a]
            for b in range(a, 4):
                L[a][b] = L[b][a] = ut[a] * ut[b] / (1.0 + ut[0]) \
                    + (1.0 if a == b else 0.0)
        out = []
        for a, b in _SYM10:
            v = 0.0
            for m1 in range(4):
                for m2 in range(4):
                    v = v + L[a][m1] * L[b][m2] * Rtet(m1, m2)
            out.append(v)
        return [f"fr{a}{b}" for a, b in _SYM10], torch.stack(out, dim=1)

    def coord_energy_density(self, state):
        """R^00 [nmb, n3, n2, n1] (the rad_coord_e refinement variable)."""
        E, _ = self.moments(state["i0"] if "i0" in state else state["u"])
        return E
