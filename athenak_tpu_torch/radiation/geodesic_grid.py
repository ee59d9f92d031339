"""Geodesic (icosahedral) angular grid.

Counterpart of ``athenak_tpu/radiation/geodesic_grid.py``, a copy kept
in the port (reference: src/geodesic-grid/geodesic_grid.{hpp,cpp}): an
nlevel-subdivided icosahedron with nangles = 10*nlevel^2 + 2 directions,
unit vectors and solid-angle quadrature weights, and the neighbour,
arc-length and edge tables of the angular fluxes.

Host-side numpy construction, run once, like the reference.  The
radiation transport (``radiation.py``) and the psi4 extraction spheres
(``z4c/weyl.py``) use it.
"""

from __future__ import annotations

import math

import numpy as np


def _icosahedron():
    """12 vertices of the unit icosahedron, poles on +/- z."""
    verts = [(0.0, 0.0, 1.0)]
    zu = 1.0 / math.sqrt(5.0)
    ru = 2.0 / math.sqrt(5.0)
    for k in range(5):
        ph = 2.0 * math.pi * k / 5.0
        verts.append((ru * math.cos(ph), ru * math.sin(ph), zu))
    for k in range(5):
        ph = 2.0 * math.pi * (k + 0.5) / 5.0
        verts.append((ru * math.cos(ph), ru * math.sin(ph), -zu))
    verts.append((0.0, 0.0, -1.0))
    v = np.array(verts)
    faces = []
    for k in range(5):
        kp = (k + 1) % 5
        faces.append((0, 1 + k, 1 + kp))                 # top cap
        faces.append((1 + k, 6 + k, 1 + kp))             # upper band
        faces.append((1 + kp, 6 + k, 6 + kp))            # lower band
        faces.append((6 + k, 11, 6 + kp))                # bottom cap
    return v, faces


def _subdivide(verts, faces, n):
    """n-fold subdivision of each face, projected to the sphere."""
    vlist = []
    index = {}

    def get(p):
        norm = math.sqrt(p[0] ** 2 + p[1] ** 2 + p[2] ** 2)
        q = (p[0] / norm, p[1] / norm, p[2] / norm)
        key = (round(q[0], 9), round(q[1], 9), round(q[2], 9))
        if key not in index:
            index[key] = len(vlist)
            vlist.append(q)
        return index[key]

    tris = []
    for (a, b, c) in faces:
        A, B, C = np.array(verts[a]), np.array(verts[b]), np.array(verts[c])
        # barycentric lattice points
        grid = {}
        for i in range(n + 1):
            for j in range(n + 1 - i):
                p = (A * (n - i - j) + B * i + C * j) / n
                grid[(i, j)] = get(tuple(p))
        for i in range(n):
            for j in range(n - i):
                tris.append((grid[(i, j)], grid[(i + 1, j)],
                             grid[(i, j + 1)]))
                if j < n - i - 1:
                    tris.append((grid[(i + 1, j)], grid[(i + 1, j + 1)],
                                 grid[(i, j + 1)]))
    return np.array(vlist), tris


def _spherical_area(a, b, c):
    """Spherical triangle area via the l'Huilier/Girard formula."""
    def ang(u, v):
        return math.atan2(np.linalg.norm(np.cross(u, v)), float(u @ v))
    ab, bc, ca = ang(a, b), ang(b, c), ang(c, a)
    s = 0.5 * (ab + bc + ca)
    t = math.tan(s / 2) * math.tan((s - ab) / 2) \
        * math.tan((s - bc) / 2) * math.tan((s - ca) / 2)
    return 4.0 * math.atan(math.sqrt(max(t, 0.0)))


def _circumcenter(a, b, c):
    """Normalized circumcenter of the spherical triangle (a, b, c)
    (reference: CircumcenterNormalized, geodesic_grid.cpp:473-500)."""
    la = np.linalg.norm(c - b)
    lb = np.linalg.norm(a - c)
    lc = np.linalg.norm(b - a)
    wa = la * la * (lb * lb + lc * lc - la * la)
    wb = lb * lb * (lc * lc + la * la - lb * lb)
    wc = lc * lc * (la * la + lb * lb - lc * lc)
    p = wa * a + wb * b + wc * c
    return p / np.linalg.norm(p)


def _unit_flux_dir(zetav, psiv, zetaf, psif):
    """Unit vector (zeta, psi components) of the flux direction along
    the great circle from the angle center to an edge midpoint
    (reference: UnitFluxDir + GreatCircleParam,
    geodesic_grid.cpp:639-672)."""
    if abs(psif - psiv) < 1e-10 or abs(abs(math.cos(zetaf)) - 1.0) < 1e-10 \
            or abs(abs(math.cos(zetav)) - 1.0) < 1e-10:
        return math.copysign(1.0, zetaf - zetav), 0.0
    atil = (math.sin(psif) / math.tan(zetav)
            - math.sin(psiv) / math.tan(zetaf)) / math.sin(psif - psiv)
    btil = (math.cos(psif) / math.tan(zetav)
            - math.cos(psiv) / math.tan(zetaf)) / math.sin(psiv - psif)
    p_par = math.atan2(btil, atil)
    a_par = math.sqrt(atil * atil + btil * btil)
    zeta_deriv = (a_par * math.sin(psif - p_par)
                  / (1.0 + (a_par * math.cos(psif - p_par)) ** 2))
    denom = 1.0 / math.sqrt(zeta_deriv ** 2 + math.sin(zetaf) ** 2)
    sgn = math.copysign(1.0, psif - psiv) \
        * math.copysign(1.0, math.pi - abs(psif - psiv))
    return sgn * zeta_deriv * denom, sgn * denom


class GeodesicGrid:
    """Angles + quadrature weights; nangles = 10 nlevel^2 + 2 (nlevel>=1)
    or the 8-per-octant testing grid (nlevel=0, reference:
    geodesic_grid.cpp:345-375)."""

    def __init__(self, nlevel: int) -> None:
        if nlevel < 0:
            raise ValueError("nlevel >= 0 required")
        self.nlevel = nlevel
        if nlevel == 0:
            # one angle per octant; positions scaled so first AND second
            # angular moments are exact (reference values)
            self.nangles = 8
            zetav = (math.pi / 4.0, 3.0 * math.pi / 4.0)
            psiv = tuple((2 * k + 1) * math.pi / 4.0 for k in range(4))
            nh = np.empty((8, 3))
            n = 0
            for zv in zetav:
                for pv in psiv:
                    nh[n] = (math.sin(zv) * math.cos(pv)
                             * math.sqrt(4.0 / 3.0),
                             math.sin(zv) * math.sin(pv)
                             * math.sqrt(4.0 / 3.0),
                             math.cos(zv) * math.sqrt(2.0 / 3.0))
                    n += 1
            self.nh = nh
            self.solid_angles = np.full(8, 4.0 * math.pi / 8.0)
            self.weights = self.solid_angles / (4.0 * math.pi)
            self.has_edges = False
            return
        v0, f0 = _icosahedron()
        verts, tris = _subdivide(v0, f0, nlevel)
        self.nangles = len(verts)
        assert self.nangles == 10 * nlevel ** 2 + 2, \
            (self.nangles, nlevel)
        self.nh = np.asarray(verts)  # unit direction vectors [nangles, 3]

        # ---- neighbor tables: cyclically-ordered vertex adjacency
        # (reference: Neighbors, geodesic_grid.cpp:430-466)
        adj = [set() for _ in range(self.nangles)]
        for (a, b, c) in tris:
            adj[a].update((b, c))
            adj[b].update((a, c))
            adj[c].update((a, b))
        nbrs = []
        for n in range(self.nangles):
            ring = sorted(adj[n])
            # order cyclically by azimuth in the tangent plane at x0
            x0 = self.nh[n]
            ref = np.array([1.0, 0.0, 0.0]) if abs(x0[0]) < 0.9 \
                else np.array([0.0, 1.0, 0.0])
            t1 = np.cross(x0, ref)
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(x0, t1)
            ordered = sorted(
                ring, key=lambda q: math.atan2(float(self.nh[q] @ t2),
                                               float(self.nh[q] @ t1)))
            nbrs.append(ordered)
        nmax = max(len(r) for r in nbrs)
        self.num_neighbors = np.array([len(r) for r in nbrs],
                                      dtype=np.int32)
        self.ind_neighbors = np.zeros((self.nangles, nmax), dtype=np.int32)
        for n, r in enumerate(nbrs):
            self.ind_neighbors[n, :len(r)] = r
            # pad with self (zero-flux edges via arc length 0)
            self.ind_neighbors[n, len(r):] = n

        # ---- dual-cell geometry: circumcenter polygon around each angle
        # (reference: SolidAngleAndArcLengths, geodesic_grid.cpp:500-532)
        w = np.zeros(self.nangles)
        self.arc_lengths = np.zeros((self.nangles, nmax))
        self.cart_pos_mid = np.zeros((self.nangles, nmax, 3))
        for n, ring in enumerate(nbrs):
            nn = len(ring)
            x0 = self.nh[n]
            for nb in range(nn):
                p1 = self.nh[ring[(nb - 1) % nn]]
                p2 = self.nh[ring[nb]]
                p3 = self.nh[ring[(nb + 1) % nn]]
                c1 = _circumcenter(x0, p1, p2)
                c2 = _circumcenter(x0, p2, p3)
                self.arc_lengths[n, nb] = math.acos(
                    np.clip(c1 @ c2, -1.0, 1.0))
                w[n] += _spherical_area(x0, c1, c2)
                mid = 0.5 * (x0 + p2)
                self.cart_pos_mid[n, nb] = mid / np.linalg.norm(mid)
        self.solid_angles = w          # sums to 4 pi
        self.weights = w / (4.0 * math.pi)

        # ---- reverse edge index: ind_neighbors_edges[n, nb] = index of n
        # in its neighbor's table
        self.ind_neighbors_edges = np.zeros((self.nangles, nmax),
                                            dtype=np.int32)
        for n, ring in enumerate(nbrs):
            for nb, q in enumerate(ring):
                self.ind_neighbors_edges[n, nb] = nbrs[q].index(n)

        # ---- unit flux direction (zeta, psi) at each edge midpoint,
        # symmetrized across shared edges like the reference
        self.unit_flux = np.zeros((self.nangles, nmax, 2))
        for n, ring in enumerate(nbrs):
            x0 = self.nh[n]
            zetav = math.acos(np.clip(x0[2], -1.0, 1.0))
            psiv = math.atan2(x0[1], x0[0])
            for nb in range(len(ring)):
                xm = self.cart_pos_mid[n, nb]
                zetaf = math.acos(np.clip(xm[2], -1.0, 1.0))
                psif = math.atan2(xm[1], xm[0])
                self.unit_flux[n, nb] = _unit_flux_dir(zetav, psiv,
                                                       zetaf, psif)
        for n, ring in enumerate(nbrs):
            for nb in range(len(ring)):
                q, eb = ring[nb], self.ind_neighbors_edges[n, nb]
                uz, up = self.unit_flux[n, nb]
                vz, vp = self.unit_flux[q, eb]
                az = 0.5 * (abs(uz) + abs(vz))
                ap = 0.5 * (abs(up) + abs(vp))
                self.unit_flux[n, nb] = (math.copysign(az, uz),
                                         math.copysign(ap, up))
                self.unit_flux[q, eb] = (math.copysign(az, vz),
                                         math.copysign(ap, vp))
        self.has_edges = True
