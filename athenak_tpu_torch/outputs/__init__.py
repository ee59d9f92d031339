"""Outputs: history sums, reference-format binary dumps, formatted
tables, restart files, legacy VTK, gravitational waveforms, tracked
particles, the event log, the coarsened binary dumps, histograms, the
Cartesian and spherical resamplings, and the CCE and horizon dumps.

Counterpart of ``athenak_tpu/outputs/__init__.py`` and ``grids.py``
(reference: src/outputs/ — BaseTypeOutput and the <outputN> factory,
src/outputs/outputs.cpp:224-260): ``hst``, ``bin``, ``tab``, ``rst``,
``vtk``, ``wave``, ``trk``, ``log``, ``cbin``, ``pdf``, ``cartgrid`` and
``sphsurf``, under the JAX package's file names and formats.  A Z4c deck
also gets its CCE worldtubes from ``<cce>`` and its horizon cube dumps
from ``<z4c>/dump_horizon_N`` (reference: z4c.cpp:195-233).  Every
writer reads the state the driver hands it (``phys.unpack_state``: u, w,
under MHD bfc and bcc, the turbulence driver's entries, the puncture
trackers' ``co_pos``) and moves what it writes to the host.  ``bin`` and
the grid outputs take every name of ``variables.resolve``; ``tab`` and
``vtk`` take the fluid's first five channels and the Z4c and radiation
families, as the JAX package's do.
"""

from __future__ import annotations

import json
import os
import re
from typing import List

import numpy as np
import torch

from ..indices import IDN, IEN, IM1, IM2, IM3, IVX, IVY, IVZ
from ..state import state_to_numpy
from .variables import (fluid_name, is_rad_variable, is_z4c_variable,
                        resolve, resolve_rad, resolve_z4c)


class OutputParameters:
    def __init__(self, pin, block: str) -> None:
        self.block = block
        self.file_type = pin.get_string(block, "file_type")
        self.variable = pin.get_or_add_string(block, "variable", "hydro_u")
        self.dt = pin.get_or_add_real(block, "dt", 0.0)
        self.dcycle = pin.get_or_add_integer(block, "dcycle", 0)
        self.data_format = pin.get_or_add_string(block, "data_format",
                                                 "%12.5e").strip()
        self.slice_x2 = self._maybe_real(pin, block, "slice_x2")
        self.slice_x3 = self._maybe_real(pin, block, "slice_x3")
        self.file_number = 0
        self.last_time = -1e300

    @staticmethod
    def _maybe_real(pin, block, key):
        if pin.does_parameter_exist(block, key):
            return pin.get_real(block, key)
        return None


class BaseOutput:
    """An output block.  ``write`` takes the current mesh; ``phys`` is
    the current tree's (an AMR rebuild re-points it) and ``driver`` the
    run's."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        self.params = OutputParameters(pin, block)
        self.basename = pin.get_string("job", "basename")
        self.phys = phys
        self.driver = None

    def due(self, mesh) -> bool:
        p = self.params
        if p.dcycle > 0:
            return mesh.ncycle % p.dcycle == 0
        if p.dt > 0.0:
            # float32 compare like the reference (driver.cpp:432-445)
            return np.float32(mesh.time) >= np.float32(p.last_time + p.dt)
        return False

    def maybe_write(self, mesh, state, force: bool = False) -> None:
        if force or self.due(mesh):
            self.write(mesh, state)
            if self.params.dt > 0.0:
                if self.params.last_time < -1e299:
                    self.params.last_time = mesh.time
                else:
                    self.params.last_time += self.params.dt
            self.params.file_number += 1

    def write(self, mesh, state) -> None:
        raise NotImplementedError


class HistoryOutput(BaseOutput):
    """Volume-weighted history sums, one row a write (reference:
    src/outputs/history.cpp; the JAX package's ``HistoryOutput``): the
    header and columns of Athena++ history data, the sums taken in
    float64 on the host over the interior, each row in
    ``data_format``.  A problem generator may enroll
    ``phys.user_hist_func(mesh, state) -> (labels, values)`` for extra
    columns (reference: pgen user_hist_func, src/pgen/pgen.hpp:55);
    ``<outputN>/user_hist_only = true`` writes only those, into a
    ``.user.hst`` file."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.user_only = pin.get_or_add_boolean(block, "user_hist_only",
                                                False)

    def write(self, mesh, state) -> None:
        mbi = mesh.mb_indcs
        sl = (slice(None), slice(None), slice(mbi.ks, mbi.ke + 1),
              slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
        user_fn = getattr(self.phys, "user_hist_func", None)
        labels, data = [], []
        if not (self.user_only and user_fn is not None):
            ua, wa = (state[k][sl].to(device="cpu",
                                      dtype=torch.float64).numpy()
                      for k in ("u", "w"))
            # per-block cell volume (level-dependent on a refined mesh)
            vol = (np.asarray(mesh.mb_size["dx1"], dtype=np.float64)
                   * np.asarray(mesh.mb_size["dx2"])
                   * np.asarray(mesh.mb_size["dx3"]))

            def vsum(q):
                return float((q.sum(axis=(1, 2, 3)) * vol).sum())

            labels += ["mass", "1-mom", "2-mom", "3-mom"]
            data += [vsum(ua[:, IDN]), vsum(ua[:, IM1]), vsum(ua[:, IM2]),
                     vsum(ua[:, IM3])]
            if self.phys.eos.is_ideal:
                labels.append("tot-E")
                data.append(vsum(ua[:, IEN]))
            for n, lab in ((IVX, "1-KE"), (IVY, "2-KE"), (IVZ, "3-KE")):
                labels.append(lab)
                data.append(vsum(0.5 * wa[:, IDN] * wa[:, n] ** 2))
        if user_fn is not None:
            ulabels, uvals = user_fn(mesh, state)
            labels += list(ulabels)
            data += [float(v) for v in uvals]

        suffix = ".user.hst" if (self.user_only and user_fn is not None) \
            else ".hst"
        fname = self.basename + suffix
        new = not os.path.exists(fname)
        fmt = self.params.data_format + " "
        with open(fname, "a") as f:
            if new:
                f.write("# Athena++ history data\n")
                cols = "#  [1]=time      [2]=dt       "
                for i, lab in enumerate(labels):
                    cols += f"[{i + 3}]={lab[:10]}    "
                f.write(cols + "\n")
            f.write(fmt % mesh.time)
            f.write(fmt % mesh.dt)
            for v in data:
                f.write(fmt % v)
            f.write("\n")


class BinaryOutput(BaseOutput):
    """Reference-format binary dumps, version 1.1 (reference:
    src/outputs/binary.cpp:52-260; the layout ``vis.readers.read_binary``
    parses): an ASCII preheader, the athinput dump, then per block 6
    int32 output indices, 4 int32 logical-location entries, 6 float64
    block extents and the float64 cell data.  The variable is resolved
    on the device (``variables.resolve``) and only the interior crosses
    to the host; a name ``resolve`` does not know falls back to the
    fluid's fields as in the JAX package (``resolve_or_fallback``)."""

    _VARIABLES = {
        "hydro_u": ("u", ["dens", "mom1", "mom2", "mom3", "ener"]),
        "hydro_w": ("w", ["dens", "velx", "vely", "velz", "eint"]),
        "mhd_u": ("u", ["dens", "mom1", "mom2", "mom3", "ener"]),
        "mhd_w": ("w", ["dens", "velx", "vely", "velz", "eint"]),
        "mhd_w_bcc": ("w_bcc", ["dens", "velx", "vely", "velz", "eint",
                                "bcc1", "bcc2", "bcc3"]),
        "mhd_u_bcc": ("u_bcc", ["dens", "mom1", "mom2", "mom3", "ener",
                                "bcc1", "bcc2", "bcc3"]),
    }

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.pin = pin
        # read, as the JAX package and the reference read it, so that
        # the parameter dump in the header holds it (one file a rank is
        # all the port writes)
        pin.get_or_add_boolean(block, "single_file_per_rank", False)

    def write(self, mesh, state) -> None:
        p = self.params
        mbi = mesh.mb_indcs
        interior = (slice(None), slice(None),
                    slice(mbi.ks, mbi.ke + 1),
                    slice(mbi.js, mbi.je + 1),
                    slice(mbi.is_, mbi.ie + 1))
        labels, base = resolve_or_fallback(self.phys, mesh, state,
                                           p.variable)
        # only the interior crosses to the host
        arr = base[interior].to(device="cpu", dtype=torch.float64).numpy()
        header_bytes = self.pin.dump().encode()
        fname = f"{self.basename}.{p.variable}.{p.file_number:05d}.bin"
        with open(fname, "wb") as f:
            f.write(b"Athena binary output version=1.1\n")
            f.write(b"  size of preheader=5\n")
            f.write(f"  time={mesh.time:.16e}\n".encode())
            f.write(f"  cycle={mesh.ncycle}\n".encode())
            f.write(b"  size of location=8\n")
            f.write(b"  size of variable=8\n")
            f.write(f"  number of variables={arr.shape[1]}\n".encode())
            f.write(("  variables:  " + "  ".join(labels) + "\n").encode())
            f.write(f"  header offset={len(header_bytes)}\n".encode())
            f.write(header_bytes)
            for gid in range(mesh.nmb_total):
                f.write(np.array([mbi.is_, mbi.ie, mbi.js, mbi.je,
                                  mbi.ks, mbi.ke], dtype=np.int32).tobytes())
                f.write(block_record(mesh, gid))
                f.write(np.ascontiguousarray(arr[gid]).tobytes())


def resolve_or_fallback(phys, mesh, state, variable):
    """``variables.resolve``; for a name it does not know, as the JAX
    package's ``bin`` does, the name's ``BinaryOutput._VARIABLES`` row,
    else w: the first five channels (the ``*_bcc`` rows with the
    field)."""
    try:
        return resolve(variable, phys, state, mesh)
    except ValueError:
        pass
    kind, labels = BinaryOutput._VARIABLES.get(
        variable, ("w", ["dens", "velx", "vely", "velz", "eint"]))
    base = state[kind[0]]
    if kind in ("u", "w"):
        nvar = min(base.shape[1], 5)
        return labels[:nvar], base[:, :nvar]
    return labels, torch.cat([base[:, :5], state["bcc"].to(base.dtype)],
                             dim=1)


def block_record(mesh, gid) -> bytes:
    """A block's logical location with its root-relative level
    (reference: binary.cpp:193), then its six float64 extents."""
    loc = mesh.lloc_eachmb[gid]
    sz = mesh.mb_size
    return np.array([loc[0], loc[1], loc[2], int(mesh.mb_lev[gid])],
                    dtype=np.int32).tobytes() + np.array(
        [sz["x1min"][gid], sz["x1max"][gid], sz["x2min"][gid],
         sz["x2max"][gid], sz["x3min"][gid], sz["x3max"][gid]],
        dtype=np.float64).tobytes()


class TabularOutput(BaseOutput):
    """Formatted tables, one row a cell of the interior (reference:
    src/outputs/formatted_table.cpp; the JAX package's
    ``TabularOutput``): a degenerate axis, or one given by
    ``slice_x2``/``slice_x3``, is cut at one cell."""

    _VARIABLES = {
        "hydro_u": ("u", ["dens", "mom1", "mom2", "mom3", "ener"]),
        "hydro_w": ("w", ["dens", "velx", "vely", "velz", "eint"]),
        "mhd_u": ("u", ["dens", "mom1", "mom2", "mom3", "ener"]),
        "mhd_w": ("w", ["dens", "velx", "vely", "velz", "eint"]),
    }

    def write(self, mesh, state) -> None:
        p = self.params
        if is_z4c_variable(p.variable):
            labels, arr = resolve_z4c(p.variable, self.phys, state)
        elif is_rad_variable(p.variable):
            labels, arr = resolve_rad(p.variable, self.phys, state)
        else:
            kind, labels = self._VARIABLES.get(
                fluid_name(p.variable),
                ("w", ["dens", "velx", "vely", "velz", "eint"]))
            arr = state[kind]
        arr = arr.to(device="cpu", dtype=torch.float64).numpy()
        nvar = min(arr.shape[1], len(labels))
        mbi = mesh.mb_indcs
        fname = f"{self.basename}.{p.variable}.{p.file_number:05d}.tab"
        with open(fname, "w") as f:
            f.write(f"# Athena++ data at time={mesh.time:e}"
                    f"  cycle={mesh.ncycle} \n")
            slice2 = p.slice_x2 is not None or mbi.nx2 == 1
            slice3 = p.slice_x3 is not None or mbi.nx3 == 1
            f.write("# gid  ")
            f.write(" i       x1v     ")
            if not slice2:
                f.write(" j       x2v     ")
            if not slice3:
                f.write(" k       x3v     ")
            for lab in labels[:nvar]:
                f.write(f"    {lab}     ")
            f.write("\n")
            fmt = p.data_format
            for gid in range(mesh.nmb_total):
                x1v, x2v, x3v = mesh.cell_centers(gid)
                j_range = range(mbi.js, mbi.je + 1)
                k_range = range(mbi.ks, mbi.ke + 1)
                if slice2:
                    jmid = self._slice_index(x2v, mbi.js, mbi.je,
                                             p.slice_x2)
                    if jmid is None:
                        continue
                    j_range = [jmid]
                if slice3:
                    kmid = self._slice_index(x3v, mbi.ks, mbi.ke,
                                             p.slice_x3)
                    if kmid is None:
                        continue
                    k_range = [kmid]
                for k in k_range:
                    for j in j_range:
                        for i in range(mbi.is_, mbi.ie + 1):
                            f.write(f"{gid:05d}")
                            f.write(f"  {i - mbi.is_:04d}  " + fmt % x1v[i])
                            if not slice2:
                                f.write(f"  {j - mbi.js:04d}  "
                                        + fmt % x2v[j])
                            if not slice3:
                                f.write(f"  {k - mbi.ks:04d}  "
                                        + fmt % x3v[k])
                            for n in range(nvar):
                                f.write("  " + fmt % arr[gid, n, k, j, i])
                            f.write("\n")

    @staticmethod
    def _slice_index(xv, lo, hi, slice_pos):
        if slice_pos is None:
            return lo  # degenerate axis
        # does the block hold the slice position?
        if xv[lo] - 1e-12 <= slice_pos <= xv[hi] + 1e-12 or lo == hi:
            return int(np.argmin(np.abs(np.asarray(xv[lo:hi + 1])
                                        - slice_pos))) + lo
        return None


class RestartOutput(BaseOutput):
    """Checkpoints for ``-r`` (reference: src/outputs/restart.cpp:207-310;
    the JAX package's ``RestartOutput``): the parameter dump, the time,
    dt and cycle, and every entry of the state, in the JAX package's npz
    container under its key names (``params``, ``time``, ``dt``,
    ``ncycle``, ``tree_leaves`` on a refined mesh, ``amr_ncyc_since_ref``
    on an adaptive one, ``treedef``, ``leaf{i}``), so that either package
    reads the other's files, and the cadence of the CCE and horizon dumps
    (``cce_last``, ``horizon_last``, ``horizon_count``) where the run
    writes them.  The
    turbulence driver's threefry key is stored as the JAX package's two
    uint32 words (``state.state_to_numpy``)."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        self.pin = pin
        self.outputs = []   # the run's outputs (``make_outputs``)

    def write(self, mesh, state) -> None:
        fname = f"{self.basename}.{self.params.file_number:05d}.rst"
        payload = {
            "params": np.frombuffer(self.pin.dump().encode(),
                                    dtype=np.uint8),
            "time": np.float64(mesh.time),
            "dt": np.float64(mesh.dt),
            "ncycle": np.int64(mesh.ncycle),
        }
        leaves = getattr(mesh, "leaves", None)
        if leaves is not None:
            payload["tree_leaves"] = np.array(
                [list(leaf) for leaf in leaves], dtype=np.int64)
        pamr = getattr(self.driver, "pamr", None)
        if pamr is not None:
            payload["amr_ncyc_since_ref"] = np.asarray(
                pamr.ncyc_since_ref, dtype=np.int64)
        for out in self.outputs:
            if hasattr(out, "restart_record"):
                payload.update(out.restart_record())
        keys, flat = _flatten_state(state_to_numpy(state))
        payload["treedef"] = np.frombuffer(json.dumps(keys).encode(),
                                           dtype=np.uint8)
        payload.update({f"leaf{i}": leaf for i, leaf in enumerate(flat)})
        with open(fname, "wb") as f:   # the .rst name, no .npz suffix
            np.savez(f, **payload)


def _flatten_state(state):
    """(keys, leaves) of the state in sorted key order, one level of
    nesting (bfc) named "bfc/x1f" and so on."""
    keys, flat = [], []
    for k in sorted(state):
        v = state[k]
        if isinstance(v, dict):
            for k2 in sorted(v):
                keys.append(f"{k}/{k2}")
                flat.append(v[k2])
        else:
            keys.append(k)
            flat.append(v)
    return keys, flat


def unflatten_state(keys, leaves):
    """Inverse of ``_flatten_state``."""
    out = {}
    for k, leaf in zip(keys, leaves):
        if "/" in k:
            k1, k2 = k.split("/")
            out.setdefault(k1, {})[k2] = leaf
        else:
            out[k] = leaf
    return out


def load_restart(fname, with_extras: bool = False):
    """A ``.rst`` file (the port's or the JAX package's) ->
    (params_text, time, dt, ncycle, state of host numpy arrays
    [, extras]); the caller moves the state to its device and dtype.
    ``extras`` holds the evolved tree (``tree_leaves``, a list of
    (l1, l2, l3, lev)), the AMR bookkeeping (``amr_ncyc_since_ref``) and
    the cadence of the CCE and horizon dumps where the file has them."""
    z = np.load(fname)
    leaves = []
    while f"leaf{len(leaves)}" in z:
        leaves.append(np.asarray(z[f"leaf{len(leaves)}"]))
    state = unflatten_state(json.loads(bytes(z["treedef"]).decode()),
                            leaves)
    out = (bytes(z["params"]).decode(), float(z["time"]), float(z["dt"]),
           int(z["ncycle"]), state)
    if not with_extras:
        return out
    extras = {}
    if "tree_leaves" in z:
        extras["tree_leaves"] = [tuple(int(x) for x in row)
                                 for row in z["tree_leaves"]]
    for key in ("amr_ncyc_since_ref", "cce_last", "horizon_last",
                "horizon_count"):
        if key in z:
            extras[key] = np.asarray(z[key])
    return out + (extras,)


class VtkOutput(BaseOutput):
    """Legacy VTK dumps (STRUCTURED_POINTS, BINARY, big-endian float32)
    of the whole mesh, readable by VisIt and ParaView (reference:
    src/outputs/vtk_mesh.cpp:56-160; the JAX package's ``VtkOutput``).
    Uniform meshes only, like the reference."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        if mesh.multilevel:
            raise NotImplementedError(
                "vtk output requires a uniform mesh (use bin on SMR)")

    def write(self, mesh, state) -> None:
        p = self.params
        if is_z4c_variable(p.variable):
            labels, arr = resolve_z4c(p.variable, self.phys, state)
        elif is_rad_variable(p.variable):
            labels, arr = resolve_rad(p.variable, self.phys, state)
        else:
            kind, labels = BinaryOutput._VARIABLES.get(
                fluid_name(p.variable),
                ("w", ["dens", "velx", "vely", "velz", "eint"]))
            arr = state[kind[0]][:, :5]
            if kind.endswith("_bcc"):
                arr = torch.cat([arr, state["bcc"].to(arr.dtype)], dim=1)
            else:
                labels = labels[:arr.shape[1]]
        mbi = mesh.mb_indcs
        act = arr[:, :, mbi.ks:mbi.ke + 1, mbi.js:mbi.je + 1,
                  mbi.is_:mbi.ie + 1].to(device="cpu",
                                         dtype=torch.float32).numpy()
        # the global grid from the blocks' logical locations
        n1 = mesh.nmb_x1 * mbi.nx1
        n2 = mesh.nmb_x2 * mbi.nx2
        n3 = mesh.nmb_x3 * mbi.nx3
        g = np.empty((act.shape[1], n3, n2, n1), dtype=np.float32)
        for gid in range(mesh.nmb_total):
            l1, l2, l3 = mesh.lloc_eachmb[gid][:3]
            g[:, l3 * mbi.nx3:(l3 + 1) * mbi.nx3,
              l2 * mbi.nx2:(l2 + 1) * mbi.nx2,
              l1 * mbi.nx1:(l1 + 1) * mbi.nx1] = act[gid]

        ms = mesh.mesh_size
        nc1 = n1 + 1 if n1 > 1 else n1
        nc2 = n2 + 1 if n2 > 1 else n2
        nc3 = n3 + 1 if n3 > 1 else n3
        fname = f"{self.basename}.{p.variable}.{p.file_number:05d}.vtk"
        with open(fname, "wb") as f:
            f.write(b"# vtk DataFile Version 2.0\n")
            f.write((f"# Athena++ data at time= {mesh.time:.15e}"
                     f"  level= 0  nranks= 1  cycle={mesh.ncycle}"
                     f"  variables={p.variable}\n").encode())
            f.write(b"BINARY\nDATASET STRUCTURED_POINTS\n")
            f.write(f"DIMENSIONS {nc1} {nc2} {nc3}\n".encode())
            f.write((f"ORIGIN {ms.x1min:.15e} {ms.x2min:.15e} "
                     f"{ms.x3min:.15e} \n").encode())
            f.write((f"SPACING {ms.dx1:.15e} {ms.dx2:.15e} "
                     f"{ms.dx3:.15e} \n").encode())
            f.write(f"\nCELL_DATA {n1 * n2 * n3}\n".encode())
            for v, label in enumerate(labels):
                f.write(f"\nSCALARS {label} float\n".encode())
                f.write(b"LOOKUP_TABLE default\n")
                f.write(g[v].astype(">f4").tobytes())


class WaveformOutput(BaseOutput):
    """Gravitational-wave diagnostics of a Z4c run: psi4 (l, m) modes on
    extraction spheres and the compact-object trackers (reference:
    src/z4c/z4c_wave_extr.cpp, src/z4c/compact_object_tracker.cpp; the
    JAX package's ``WaveformOutput``, its file names and columns:
    ``<basename>.co_<n>.txt`` rows of time and position, and
    ``<basename>.waveform.txt``, a header and one row a radius a write).
    Deck keys of <z4c>: nrad_wave_extraction, extraction_radius_N,
    extraction_nlev, lmax_wave_extraction, nco.  The tracker positions
    are the device's ``co_pos`` (``Z4c.post_cycle``), and only those
    [nco, 3] floats and the two psi4 channels cross to the host, at
    output cadence; psi4 is computed with the current tree's physics."""

    def __init__(self, pin, mesh, phys, block: str) -> None:
        super().__init__(pin, mesh, phys, block)
        from ..z4c.weyl import WaveExtractor
        nrad = pin.get_or_add_integer("z4c", "nrad_wave_extraction", 0)
        radii = [pin.get_real("z4c", f"extraction_radius_{n + 1}")
                 for n in range(nrad)]
        nlev = pin.get_or_add_integer("z4c", "extraction_nlev", 16)
        lmax = pin.get_or_add_integer("z4c", "lmax_wave_extraction", 4)
        self.extractor = WaveExtractor(radii, lmax=lmax, nlevel=nlev) \
            if radii else None
        self.nco = pin.get_or_add_integer("z4c", "nco", 0)
        self._wrote_header = False

    def write(self, mesh, state) -> None:
        if self.nco > 0:
            pos = state["co_pos"].detach().to(
                device="cpu", dtype=torch.float64).numpy()
            for n, (x, y, z) in enumerate(pos):
                with open(f"{self.basename}.co_{n}.txt", "a") as f:
                    f.write(f"{mesh.time:.10e} {x:.10e} {y:.10e} {z:.10e}\n")
        if self.extractor is None:
            return
        from ..z4c.weyl import weyl_scalars
        rp, ip = weyl_scalars(self.phys, state["u"])
        rp, ip = rp.cpu().numpy(), ip.cpu().numpy()
        keys = sorted(self.extractor.ylm.keys())
        if not self._wrote_header:
            with open(f"{self.basename}.waveform.txt", "a") as f:
                cols = " ".join(f"Re_l{l}_m{m} Im_l{l}_m{m}"
                                for l, m in keys)
                f.write(f"# time radius {cols}\n")
            self._wrote_header = True
        for rad, modes in self.extractor.modes(mesh, rp, ip):
            with open(f"{self.basename}.waveform.txt", "a") as f:
                vals = " ".join(f"{modes[k][0]:.10e} {modes[k][1]:.10e}"
                                for k in keys)
                f.write(f"{mesh.time:.10e} {rad:.6e} {vals}\n")


class CCEOutput:
    """Cadenced CCE worldtube dumps (reference: Z4c::CCEDump,
    z4c_tasks.cpp:345-360: a float32 time comparison, every worldtube at
    each dump time), into ``cce/cce_<time>.bin``.  ``due`` is its own
    cadence (the JAX package's class has none, ROADMAP F11); a restart
    file carries it (``restart_record``, ``resume``)."""

    def __init__(self, pin, mesh, phys) -> None:
        from ..z4c.cce import CCE
        self.phys = phys
        self.driver = None
        self.cce_dt = pin.get_or_add_real("cce", "cce_dt", 1.0)
        ncce = pin.get_integer("cce", "num_radii")
        self.worldtubes = [CCE(pin, mesh, i) for i in range(ncce)]
        self.last = -100.0  # reference cce_dump_last_output_time

    def due(self, mesh) -> bool:
        return bool(np.float32(mesh.time)
                    >= np.float32(self.last + self.cce_dt))

    def maybe_write(self, mesh, state, force: bool = False) -> None:
        if not (force or self.due(mesh)):
            return
        self.write(mesh, state)
        self.last = float(np.float32(mesh.time))

    def write(self, mesh, state) -> None:
        """Every worldtube's dump of the whole state (under ranks rank
        0's collected one; the other ranks' ``write`` does nothing)."""
        for wt in self.worldtubes:
            wt.dump(mesh, self.phys, state["u"])

    def restart_record(self):
        return {"cce_last": np.float64(self.last)}

    def resume(self, extras) -> None:
        self.last = float(_cadence(extras, "cce_last"))


class HorizonDumpOutput:
    """Cadenced horizon cube dumps (reference: Z4c::DumpHorizons,
    z4c_tasks.cpp:554-575), into ``horizon_<n>/output_<count>/``; the
    first at t = 0, then every ``<z4c>/horizon_dt`` (a float32
    comparison).  Horizon n is centred on tracker n, the device's
    ``co_pos[n]``; a horizon without a tracker (n >= nco) stays at its
    deck centre ``co_<n>_x/y/z``.  ``due`` is its own cadence (ROADMAP
    F11); a restart file carries it and the dump counts."""

    def __init__(self, pin, mesh, phys) -> None:
        from ..z4c.cce import HorizonDump
        self.phys = phys
        self.driver = None
        self.dumps = []
        n = 0
        while pin.get_or_add_boolean("z4c", f"dump_horizon_{n}", False):
            self.dumps.append(HorizonDump(pin, mesh, n))
            n += 1
        self.nco = pin.get_or_add_integer("z4c", "nco", 0)
        self.last = 0.0

    def due(self, mesh) -> bool:
        if not self.dumps:
            return False
        return bool(np.float32(mesh.time)
                    >= np.float32(self.last + self.dumps[0].horizon_dt)
                    or (mesh.time == 0.0 and self.dumps[0].output_count == 0))

    def maybe_write(self, mesh, state, force: bool = False) -> None:
        if not (force or self.due(mesh)):
            return
        counts = [hd.output_count for hd in self.dumps]
        self.write(mesh, state)
        # the dump counts advance on every rank, written or not
        for hd, n in zip(self.dumps, counts):
            hd.output_count = n + 1
        self.last = float(np.float32(mesh.time))

    def write(self, mesh, state) -> None:
        """Every horizon's cube of the whole state (under ranks rank 0's
        collected one; the other ranks' ``write`` does nothing)."""
        if self.nco > 0:
            pos = state["co_pos"].detach().to(
                device="cpu", dtype=torch.float64).numpy()
        for n, hd in enumerate(self.dumps):
            hd.dump(mesh, self.phys, state["u"],
                    center=pos[n] if n < self.nco else None)

    def restart_record(self):
        return {"horizon_last": np.float64(self.last),
                "horizon_count": np.array(
                    [hd.output_count for hd in self.dumps], dtype=np.int64)}

    def resume(self, extras) -> None:
        self.last = float(_cadence(extras, "horizon_last"))
        for hd, count in zip(self.dumps, _cadence(extras, "horizon_count")):
            hd.output_count = int(count)


def _cadence(extras, key):
    if key not in extras:
        raise ValueError(
            f"the restart file holds no '{key}': it was not written with "
            "this deck's CCE or horizon dumps, so their cadence cannot "
            "be resumed")
    return extras[key]


class TrackedParticleOutput(BaseOutput):
    """Tracked-particle trajectories (reference: src/outputs/
    track_prtcl.cpp, the ``trk`` type; the JAX package's
    ``TrackedParticleOutput``): a row of time, id, position and velocity
    for each of the first ``<particles>/ntrack`` particles, appended to
    ``<basename>.trk`` at each write.  A state without particles writes
    nothing."""

    def maybe_write(self, mesh, state, force: bool = False) -> None:
        if "prtcl_x" in state:
            super().maybe_write(mesh, state, force)

    def write(self, mesh, state) -> None:
        x = state["prtcl_x"].detach().cpu().numpy()
        v = state["prtcl_v"].detach().cpu().numpy()
        ntrack = min(self.phys.ppart.ntrack, x.shape[0])
        fname = self.basename + ".trk"
        new = not os.path.exists(fname)
        with open(fname, "a") as f:
            if new:
                f.write("# time  id  x1  x2  x3  v1  v2  v3\n")
            for p in range(ntrack):
                f.write(f"{mesh.time:.10e}  {p:d}  "
                        + "  ".join(f"{q:.10e}" for q in
                                    list(x[p]) + list(v[p])) + "\n")


class EventLogOutput(BaseOutput):
    """The event-counter log (reference: src/outputs/eventlog.cpp:35-71;
    the JAX package's ``EventLogOutput``): at each write a row of the
    time, the cycle and the driver's counters summed over the run
    (``Driver.ecounters``: the floor hits, the c2p failures, ``nfofc``),
    in sorted order, appended to ``<basename>.log``.  Nothing is written
    before the first cycle has counted."""

    def maybe_write(self, mesh, state, force: bool = False) -> None:
        if self.driver is None or not (force or self.due(mesh)):
            return
        if not self.driver.ecounters:
            return
        super().maybe_write(mesh, state, force=True)

    def write(self, mesh, state) -> None:
        counters = dict(self.driver.ecounters)
        fname = self.basename + ".log"
        new = not os.path.exists(fname)
        with open(fname, "a") as f:
            if new:
                f.write("# time  cycle  " + "  ".join(sorted(counters))
                        + "\n")
            f.write(f"{mesh.time:.10e}  {mesh.ncycle:d}  "
                    + "  ".join(str(counters[k]) for k in sorted(counters))
                    + "\n")


_TYPES = {"hst": HistoryOutput, "bin": BinaryOutput, "tab": TabularOutput,
          "rst": RestartOutput, "vtk": VtkOutput, "wave": WaveformOutput,
          "trk": TrackedParticleOutput, "log": EventLogOutput}


def make_outputs(pin, mesh, phys, driver=None) -> List[BaseOutput]:
    outs: List[BaseOutput] = []
    for block in list(pin.blocks):
        if re.match(r"^output\d+$", block):
            ftype = pin.get_string(block, "file_type")
            cls = _TYPES.get(ftype)
            if cls is None:
                # a deck's typo is an error, as in the reference's
                # factory (reference: src/outputs/outputs.cpp:224-260)
                raise ValueError(
                    f"<{block}>/file_type = '{ftype}' is not a valid "
                    f"output type (valid: {sorted(_TYPES)})")
            outs.append(cls(pin, mesh, phys, block))
            outs[-1].driver = driver
    # CCE worldtubes and horizon cube dumps come from their own deck
    # blocks, not <outputN> (reference: z4c.cpp:195-233; task-list
    # cadence in z4c_tasks.cpp:345, 555)
    if pin.does_block_exist("z4c"):
        if pin.does_block_exist("cce") and \
                pin.get_or_add_integer("cce", "num_radii", 0) > 0:
            outs.append(CCEOutput(pin, mesh, phys))
        if pin.does_parameter_exist("z4c", "dump_horizon_0"):
            outs.append(HorizonDumpOutput(pin, mesh, phys))
    # restart files last, so that one holds the cadence of the outputs
    # written in the same cycle
    outs.sort(key=lambda out: isinstance(out, RestartOutput))
    for out in outs:
        if isinstance(out, RestartOutput):
            out.outputs = outs
    return outs


def _register_grid_outputs():
    # grids.py subclasses the writers above
    from .grids import (CartesianGridOutput, CoarsenedBinaryOutput,
                        PDFOutput, SphericalSurfaceOutput)
    _TYPES.update(cbin=CoarsenedBinaryOutput, pdf=PDFOutput,
                  cartgrid=CartesianGridOutput,
                  sphsurf=SphericalSurfaceOutput)


_register_grid_outputs()
