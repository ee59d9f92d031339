"""Derived-grid and statistics outputs: cbin, pdf, cartgrid, sphsurf.

Counterpart of ``athenak_tpu/outputs/grids.py``, with its file names,
layouts and host arithmetic, so that a deck writes the same files:

  - ``CoarsenedBinaryOutput``: reference src/outputs/coarsened_binary.cpp
    (a preheader with "number of moments" and "coarsening factor", a
    float32 payload of factor^3 block means, optionally the first four
    raw moments);
  - ``PDFOutput``: reference src/outputs/pdf.cpp (1-D and 2-D volume- or
    mass-weighted histograms with under- and overflow bins, linear or
    log10 spacing, a bins file and a table a dump);
  - ``CartesianGridOutput``: reference src/outputs/cartgrid.cpp and
    src/utils/cart_grid.cpp (trilinear resampling onto a uniform or
    Chebyshev box, the packed-struct binary format);
  - ``SphericalSurfaceOutput``: reference
    src/outputs/spherical_surface.cpp and src/utils/spherical_surface.cpp
    (uniform mu x uniform phi spheres, a legacy-VTK STRUCTURED_GRID file
    of weights and variables).

Each resolves its variable on the device (``variables.resolve``), moves
that one family to the host (the interior alone for ``cbin`` and
``pdf``; the interpolations read the ghosts) and reduces or interpolates
there in numpy, in the JAX package's order of operations: ``np.add.at``
in cell order for the histograms, the host trilinear interpolation of
``z4c.ahf.interp_fields`` (refined meshes too) for the resamplings.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from ..indices import IDN
from ..z4c.ahf import interp_fields
from . import (BaseOutput, BinaryOutput, block_record,
               resolve_or_fallback)


def _host(t) -> np.ndarray:
    return t.to(device="cpu", dtype=torch.float64).numpy()


def _resolve_host(out, mesh, state, variable, interior=False):
    """(labels, host float64 array [nmb, nvar, n3, n2, n1]) of an output
    variable, ghosts included unless ``interior``; a name ``resolve``
    does not know falls back as ``bin`` does."""
    labels, dev = resolve_or_fallback(out.phys, mesh, state, variable)
    if interior:
        dev = dev[_interior(mesh)]
    return labels, _host(dev)


def _interior(mesh):
    mbi = mesh.mb_indcs
    return (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
            slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))


class CoarsenedBinaryOutput(BinaryOutput):
    """Coarsened binary dumps (``cbin``; reference:
    src/outputs/coarsened_binary.cpp:149-470): each variable's means over
    cubes of ``coarsen_factor`` cells a side (with
    ``compute_moments = true`` also the raw 2nd, 3rd and 4th moments,
    labelled var_1st .. var_4th), in the version-1.1 binary layout with a
    7-line preheader, float32 cells.  Every moment is divided by the
    factor cubed whatever axes collapse, as the reference does.  Files:
    cbin_{variable}_{factor}/{basename}.{variable}.NNNNN.cbin."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.factor = pin.get_or_add_integer(block, "coarsen_factor", 2)
        self.moments = pin.get_or_add_boolean(block, "compute_moments",
                                              False)
        mbi = mesh.mb_indcs
        for n, lab in ((mbi.nx1, "nx1"), (mbi.nx2, "nx2"),
                       (mbi.nx3, "nx3")):
            if n > 1 and n % self.factor != 0:
                raise ValueError(
                    f"meshblock/{lab}={n} not divisible by "
                    f"coarsen_factor={self.factor}")

    def write(self, mesh, state) -> None:
        p = self.params
        mbi = mesh.mb_indcs
        labels, arr = _resolve_host(self, mesh, state, p.variable,
                                    interior=True)
        F = self.factor
        nmb, nvar, n3, n2, n1 = arr.shape
        f3 = F if n3 > 1 else 1
        f2 = F if n2 > 1 else 1
        c3, c2, c1 = n3 // f3, n2 // f2, n1 // F
        blocks = arr.reshape(nmb, nvar, c3, f3, c2, f2, c1, F)
        norm = F ** 3 / (f3 * f2 * F)
        powers = [1, 2, 3, 4] if self.moments else [1]
        moms = [blocks.__pow__(q).mean(axis=(3, 5, 7)) / norm
                for q in powers]
        # the moments of a variable together: v0_1st v0_2nd .. v1_1st ..
        out = np.stack(moms, axis=2).reshape(nmb, nvar * len(powers),
                                             c3, c2, c1)
        if self.moments:
            sfx = ["_1st", "_2nd", "_3rd", "_4th"]
            labels = [lab + s for lab in labels for s in sfx]

        base_dir = os.path.dirname(self.basename) or "."
        dname = os.path.join(base_dir, f"cbin_{p.variable}_{F}")
        os.makedirs(dname, exist_ok=True)
        fname = os.path.join(
            dname, os.path.basename(self.basename)
            + f".{p.variable}.{p.file_number:05d}.cbin")
        header_bytes = self.pin.dump().encode()
        with open(fname, "wb") as f:
            f.write(b"Athena binary output version=1.1\n")
            f.write(b"  size of preheader=7\n")
            f.write(f"  time={mesh.time:.16e}\n".encode())
            f.write(f"  cycle={mesh.ncycle}\n".encode())
            f.write(f"  number of moments={len(powers)}\n".encode())
            f.write(f"  coarsening factor={F}\n".encode())
            f.write(b"  size of location=8\n")
            f.write(b"  size of variable=4\n")
            f.write(f"  number of variables={out.shape[1]}\n".encode())
            f.write(("  variables:  " + "  ".join(labels) + "\n").encode())
            f.write(f"  header offset={len(header_bytes)}\n".encode())
            f.write(header_bytes)
            for gid in range(mesh.nmb_total):
                f.write(np.array(
                    [mbi.is_, mbi.is_ + c1 - 1, mbi.js, mbi.js + c2 - 1,
                     mbi.ks, mbi.ks + c3 - 1], dtype=np.int32).tobytes())
                f.write(block_record(mesh, gid))
                f.write(np.ascontiguousarray(out[gid],
                                             dtype=np.float32).tobytes())


class PDFOutput(BaseOutput):
    """1-D and 2-D histograms (``pdf``; reference: src/outputs/pdf.cpp):
    nbin bins (and the two outlier bins) over [bin_min, bin_max], log10
    spaced by default, optionally joint with ``variable_2`` (nbin2,
    bin2_min, bin2_max, logscale2), weighted by cell volume or, with
    ``mass_weighted = true``, by mass.  Writes {basename}.bins.pdf once
    and {basename}.NNNNN.pdf a dump into pdf_{variable}[_{variable_2}]/,
    which the constructor makes."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        p = self.params
        self.bin_min = pin.get_real(block, "bin_min")
        self.bin_max = pin.get_real(block, "bin_max")
        self.nbin = pin.get_integer(block, "nbin")
        self.logscale = pin.get_or_add_boolean(block, "logscale", True)
        self.mass_weighted = pin.get_or_add_boolean(
            block, "mass_weighted", False)
        self.var2 = None
        if pin.does_parameter_exist(block, "variable_2"):
            self.var2 = pin.get_string(block, "variable_2")
            self.bin2_min = pin.get_real(block, "bin2_min")
            self.bin2_max = pin.get_real(block, "bin2_max")
            self.nbin2 = pin.get_or_add_integer(block, "nbin2", 0)
            self.logscale2 = pin.get_or_add_boolean(block, "logscale2",
                                                    True)
        if self.logscale and self.bin_min <= 0.0:
            raise ValueError("pdf: logscale=true requires bin_min > 0")
        self.bins = self._edges(self.bin_min, self.bin_max, self.nbin,
                                self.logscale)
        if self.var2 is not None:
            self.bins2 = self._edges(self.bin2_min, self.bin2_max,
                                     self.nbin2, self.logscale2)
        base_dir = os.path.dirname(self.basename) or "."
        dn = f"pdf_{p.variable}"
        if self.var2 is not None:
            dn += f"_{self.var2}"
        self.dname = os.path.join(base_dir, dn)
        os.makedirs(self.dname, exist_ok=True)
        self._bins_written = False

    @staticmethod
    def _edges(lo, hi, n, log):
        if log:
            return np.logspace(np.log10(lo), np.log10(hi), n + 1)
        return np.linspace(lo, hi, n + 1)

    @staticmethod
    def _bin_index(vals, lo, hi, n, log):
        """The reference's binning (pdf.cpp:246-260): 0 the underflow,
        n + 1 the overflow, the rest from the uniform (log) step."""
        if log:
            step = (np.log10(hi) - np.log10(lo)) / n
            idx = (np.log10(np.maximum(vals, 1e-300) / lo)
                   / step).astype(np.int64) + 1
        else:
            step = (hi - lo) / n
            idx = ((vals - lo) / step).astype(np.int64) + 1
        idx = np.clip(idx, 0, n + 1)
        idx[vals < lo] = 0
        idx[vals >= hi] = n + 1
        return idx

    def histogram(self, mesh, state) -> np.ndarray:
        """The weights of each bin, [1 or nbin2 + 2, nbin + 2]."""
        _, x = _resolve_host(self, mesh, state, self.params.variable,
                             interior=True)
        xv = x[:, 0]
        xb = self._bin_index(xv.reshape(xv.shape[0], -1), self.bin_min,
                             self.bin_max, self.nbin, self.logscale)
        vol = (np.asarray(mesh.mb_size["dx1"], dtype=np.float64)
               * np.asarray(mesh.mb_size["dx2"])
               * np.asarray(mesh.mb_size["dx3"]))
        wgt = np.broadcast_to(vol[:, None], xb.shape).copy()
        if self.mass_weighted:
            dens = _host(state["u"][_interior(mesh)][:, IDN])
            wgt *= dens.reshape(dens.shape[0], -1)
        if self.var2 is None:
            result = np.zeros((1, self.nbin + 2))
            np.add.at(result[0], xb.reshape(-1), wgt.reshape(-1))
            return result
        _, y = _resolve_host(self, mesh, state, self.var2, interior=True)
        yv = y[:, 0]
        yb = self._bin_index(yv.reshape(yv.shape[0], -1), self.bin2_min,
                             self.bin2_max, self.nbin2, self.logscale2)
        result = np.zeros((self.nbin2 + 2, self.nbin + 2))
        np.add.at(result, (yb.reshape(-1), xb.reshape(-1)),
                  wgt.reshape(-1))
        return result

    def write(self, mesh, state) -> None:
        p = self.params
        result = self.histogram(mesh, state)
        fmt = p.data_format
        base = os.path.basename(self.basename)
        if not self._bins_written:
            with open(os.path.join(self.dname, base + ".bins.pdf"),
                      "w") as f:
                f.write("# pdf bins \n")
                f.write(f"# [1]= {p.variable} \n")
                if self.var2 is not None:
                    f.write(f"# [2]= {self.var2} \n")
                f.write(" ".join(fmt % b for b in self.bins) + "\n")
                if self.var2 is not None:
                    f.write(" ".join(fmt % b for b in self.bins2) + "\n")
            self._bins_written = True
        fname = os.path.join(self.dname,
                             base + f".{p.file_number:05d}.pdf")
        with open(fname, "w") as f:
            f.write("# time= " + (fmt % mesh.time) + "\n")
            for row in result:
                f.write(" ".join(fmt % v for v in row) + "\n")
            f.write("\n")


class CartesianGridOutput(BaseOutput):
    """Interpolation onto a Cartesian box (``cartgrid``; reference:
    src/outputs/cartgrid.cpp and src/utils/cart_grid.cpp):
    numpoints_{x,y,z} points over center +- extent on each axis, uniform
    or at the Chebyshev nodes x_i = c + e cos(i pi / (N - 1))
    (``chebyshev = true``), trilinear from the (possibly refined) mesh.
    The file is the reference's packed MetaData struct (int cycle, float
    time, float center[3], float extent[3], int numpoints[3], bool
    is_cheb and 3 pad bytes, int noutvars), then [int len][the labels
    joined by spaces], then float32 values in (var, z, y, x) order.
    Files: cart/{basename}.{variable}.NNNNN.bin."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.center = [pin.get_or_add_real(block, f"center_{d}", 0.0)
                       for d in "xyz"]
        self.extent = [pin.get_or_add_real(block, f"extent_{d}", 2.0)
                       for d in "xyz"]
        self.npts = [pin.get_or_add_integer(block, f"numpoints_{d}", 32)
                     for d in "xyz"]
        self.cheb = pin.get_or_add_boolean(block, "chebyshev", False)
        self.dname = os.path.join(
            os.path.dirname(self.basename) or ".", "cart")
        os.makedirs(self.dname, exist_ok=True)

    def axis(self, d):
        c, e, n = self.center[d], self.extent[d], self.npts[d]
        if self.cheb:
            return c + e * np.cos(np.arange(n) * np.pi / max(n - 1, 1))
        return np.linspace(c - e, c + e, n)

    def write(self, mesh, state) -> None:
        p = self.params
        labels, arr = _resolve_host(self, mesh, state, p.variable)
        xs, ys, zs = self.axis(0), self.axis(1), self.axis(2)
        Z, Y, X = np.meshgrid(zs, ys, xs, indexing="ij")
        pts = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)],
                       axis=1)
        fields = [arr[:, n] for n in range(arr.shape[1])]
        vals = interp_fields(mesh, fields, pts).reshape(
            len(fields), len(zs), len(ys), len(xs))
        fname = os.path.join(
            self.dname, os.path.basename(self.basename)
            + f".{p.variable}.{p.file_number:05d}.bin")
        with open(fname, "wb") as f:
            f.write(struct.pack(
                "=if3f3f3i?3xi", mesh.ncycle, float(mesh.time),
                *[float(c) for c in self.center],
                *[float(e) for e in self.extent],
                *self.npts, self.cheb, len(labels)))
            names = " ".join(labels).encode()
            f.write(struct.pack("=i", len(names)))
            f.write(names)
            f.write(vals.astype(np.float32).tobytes())


class SphericalSurfaceOutput(BaseOutput):
    """Interpolation onto spheres (``sphsurf``; reference:
    src/outputs/spherical_surface.cpp and
    src/utils/spherical_surface.cpp): 2 ntheta^2 directions (uniform mu
    in [-1, 1] x uniform phi of step pi / ntheta) on one radius
    (``radius``) or a linear or log ladder (nradii, r_min, r_max,
    r_spacing) about (xc, yc, zc).  The file is the reference's
    legacy-VTK STRUCTURED_GRID (big-endian floats): the points as
    (r, theta, phi), TIME, CYCLE and RADII field data, the r^2-scaled
    quadrature weights, then a SCALARS record a variable, radius
    fastest.  Files: sph/{basename}.r=...{variable}.NNNNN.vtk."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.ntheta = pin.get_or_add_integer(block, "ntheta", 32)
        self.center = [pin.get_or_add_real(block, c, 0.0)
                       for c in ("xc", "yc", "zc")]
        if pin.does_parameter_exist(block, "radius"):
            self.radii = [pin.get_real(block, "radius")]
        else:
            nr = pin.get_integer(block, "nradii")
            rmin = pin.get_real(block, "r_min")
            rmax = pin.get_real(block, "r_max")
            spacing = pin.get_or_add_string(block, "r_spacing", "linear")
            fr = np.arange(nr) / max(nr - 1, 1)
            if spacing == "log":
                self.radii = list(rmin * (rmax / rmin) ** fr)
            else:
                self.radii = list(rmin + (rmax - rmin) * fr)
        nt = self.ntheta
        mu = -1.0 + 2.0 * np.arange(nt) / (nt - 1)
        phi = np.pi / nt * np.arange(2 * nt)
        # angle index n = i_phi * ntheta + j_mu (spherical_surface.cpp:84)
        self.theta = np.repeat(np.arccos(np.clip(mu, -1, 1))[None, :],
                               2 * nt, axis=0).reshape(-1)
        self.phi = np.repeat(phi[:, None], nt, axis=1).reshape(-1)
        self.weight = (np.pi / nt) * (2.0 / nt)
        self.dname = os.path.join(
            os.path.dirname(self.basename) or ".", "sph")
        os.makedirs(self.dname, exist_ok=True)

    def write(self, mesh, state) -> None:
        p = self.params
        labels, arr = _resolve_host(self, mesh, state, p.variable)
        nang = len(self.theta)
        nrad = len(self.radii)
        st, ct = np.sin(self.theta), np.cos(self.theta)
        cp, sp = np.cos(self.phi), np.sin(self.phi)
        # point index = r * nangles + angle; the file is radius-fastest
        pts = np.empty((nrad * nang, 3))
        for r, rad in enumerate(self.radii):
            s = slice(r * nang, (r + 1) * nang)
            pts[s, 0] = self.center[0] + rad * st * cp
            pts[s, 1] = self.center[1] + rad * st * sp
            pts[s, 2] = self.center[2] + rad * ct
        fields = [arr[:, n] for n in range(arr.shape[1])]
        vals = interp_fields(mesh, fields, pts).reshape(
            len(fields), nrad, nang)

        if nrad == 1:
            rtag = f"r={self.radii[0]:.2f}"
        else:
            rtag = f"r={self.radii[0]:.2f}-{self.radii[-1]:.2f}"
        fname = os.path.join(
            self.dname, os.path.basename(self.basename)
            + f".{rtag}.{p.variable}.{p.file_number:05d}.vtk")
        with open(fname, "wb") as f:
            f.write(b"# vtk DataFile Version 3.0\n")
            f.write((f"# AthenaK data at time={mesh.time:g}"
                     f" cycle={mesh.ncycle} nradii={nrad}"
                     f" rmin={self.radii[0]:g} rmax={self.radii[-1]:g}"
                     f" xc={self.center[0]:g} yc={self.center[1]:g}"
                     f" zc={self.center[2]:g}\n").encode())
            f.write(b"BINARY\nDATASET STRUCTURED_GRID\n")
            f.write((f"DIMENSIONS {nrad} {self.ntheta}"
                     f" {2 * self.ntheta}\n").encode())
            f.write(f"POINTS {nrad * nang} float\n".encode())
            tri = np.empty((nang, nrad, 3), dtype=np.float64)
            tri[:, :, 0] = np.asarray(self.radii)[None, :]
            tri[:, :, 1] = self.theta[:, None]
            tri[:, :, 2] = self.phi[:, None]
            f.write(tri.astype(">f4").tobytes())
            f.write(b"\nFIELD FieldData 3\nTIME 1 1 float\n")
            f.write(np.float32(mesh.time).astype(">f4").tobytes())
            f.write(b"\nCYCLE 1 1 int\n")
            f.write(np.int32(mesh.ncycle).astype(">i4").tobytes())
            f.write(f"\nRADII 1 {nrad} float\n".encode())
            f.write(np.asarray(self.radii).astype(">f4").tobytes())
            f.write(f"\nPOINT_DATA {nrad * nang}\n".encode())
            f.write(b"SCALARS weights float 1\nLOOKUP_TABLE default\n")
            wts = (np.asarray(self.radii)[None, :] ** 2
                   * self.weight) * np.ones((nang, 1))
            f.write(wts.astype(">f4").tobytes())
            for n, lab in enumerate(labels):
                f.write(f"\nSCALARS {lab} float 1\n".encode())
                f.write(b"LOOKUP_TABLE default\n")
                f.write(vals[n].T.astype(">f4").tobytes())
