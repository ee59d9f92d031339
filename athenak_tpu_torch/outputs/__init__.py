"""Outputs: reference-format binary dumps and formatted tables.

Counterpart of ``athenak_tpu/outputs/__init__.py`` (reference:
src/outputs/ — BaseTypeOutput and the <outputN> factory,
src/outputs/outputs.cpp:224-260).  Only ``bin`` and ``tab`` are ported
so far; the other file types raise.
"""

from __future__ import annotations

import re
from typing import List

import numpy as np
import torch


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
    def __init__(self, pin, mesh, phys, block: str) -> None:
        self.params = OutputParameters(pin, block)
        self.basename = pin.get_string("job", "basename")
        self.phys = phys

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


class BinaryOutput(BaseOutput):
    """Reference-format binary dumps, version 1.1 (reference:
    src/outputs/binary.cpp:52-260; the layout the reader
    athenak_tpu.vis.readers.read_binary parses): an ASCII preheader, the
    athinput dump, then per block 6 int32 output indices, 4 int32
    logical-location entries, 6 float64 block extents and the float64
    cell data."""

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
        if self.params.variable not in self._VARIABLES:
            raise NotImplementedError(
                f"<{block}>/variable = '{self.params.variable}' is not "
                f"ported to athenak_tpu_torch yet "
                f"(ported: {sorted(self._VARIABLES)})")

    def write(self, mesh, state) -> None:
        p = self.params
        mbi = mesh.mb_indcs
        interior = (slice(None), slice(None),
                    slice(mbi.ks, mbi.ke + 1),
                    slice(mbi.js, mbi.je + 1),
                    slice(mbi.is_, mbi.ie + 1))
        kind, labels = self._VARIABLES[p.variable]
        base = state[kind[0]][:, :5]
        if kind.endswith("_bcc"):
            base = torch.cat([base, state["bcc"]], dim=1)
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
                loc = mesh.lloc_eachmb[gid]
                # root-relative level (reference: binary.cpp:193)
                level = int(mesh.mb_lev[gid])
                f.write(np.array([loc[0], loc[1], loc[2], level],
                                 dtype=np.int32).tobytes())
                f.write(np.array(
                    [mesh.mb_size["x1min"][gid], mesh.mb_size["x1max"][gid],
                     mesh.mb_size["x2min"][gid], mesh.mb_size["x2max"][gid],
                     mesh.mb_size["x3min"][gid], mesh.mb_size["x3max"][gid]],
                    dtype=np.float64).tobytes())
                f.write(np.ascontiguousarray(arr[gid]).tobytes())


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
        kind, labels = self._VARIABLES.get(
            p.variable, ("w", ["dens", "velx", "vely", "velz", "eint"]))
        arr = state[kind].to(device="cpu", dtype=torch.float64).numpy()
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


_TYPES = {"bin": BinaryOutput, "tab": TabularOutput}


def make_outputs(pin, mesh, phys) -> List[BaseOutput]:
    outs: List[BaseOutput] = []
    for block in list(pin.blocks):
        if re.match(r"^output\d+$", block):
            ftype = pin.get_string(block, "file_type")
            cls = _TYPES.get(ftype)
            if cls is None:
                raise NotImplementedError(
                    f"<{block}>/file_type = '{ftype}' is not ported to "
                    f"athenak_tpu_torch yet (ported: {sorted(_TYPES)})")
            outs.append(cls(pin, mesh, phys, block))
    return outs
