"""Readers for run outputs: bin, hst, tab and vtk.

A copy of ``athenak_tpu/vis/readers.py`` (numpy only), kept in the port
so that the port never imports the JAX package.

Functional parity with the reference post-processing tools
(reference: vis/python/athena_read.py, bin_convert.py:92-260).  The bin
reader accepts both our files and the reference's (same format v1.1).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def read_binary(filename: str) -> Dict:
    """Read a version-1.1 Athena binary dump into a dict.

    Keys mirror the reference reader (bin_convert.py): time, cycle,
    var_names, mb_index, mb_logical, mb_geometry, mb_data, ...
    """
    out: Dict = {}
    with open(filename, "rb") as fp:
        fp.seek(0, 2)
        filesize = fp.tell()
        fp.seek(0)

        first = fp.readline().split()
        if not first or first[0] != b"Athena":
            raise TypeError("not an Athena binary file")
        version = first[-1].split(b"=")[-1]
        if version != b"1.1":
            raise TypeError(f"unsupported version {version!r}")

        n_pre = int(fp.readline().split(b"=")[-1])
        pre = {}
        for _ in range(n_pre - 1):
            k, v = fp.readline().decode().split("=")
            pre[k.strip()] = v.strip()
        time = float(pre["time"])
        cycle = int(pre["cycle"])
        locsize = int(pre["size of location"])
        varsize = int(pre["size of variable"])

        nvars = int(fp.readline().split(b"=")[-1])
        var_list = [v.decode() for v in fp.readline().split()[1:]]
        header_size = int(fp.readline().split(b"=")[-1])
        header_text = fp.read(header_size).decode()
        header = [ln.split("#")[0].strip()
                  for ln in header_text.split("\n")]
        header = [ln for ln in header if ln]

        locdt = np.float64 if locsize == 8 else np.float32
        vardt = np.float64 if varsize == 8 else np.float32

        def from_header(block, key):
            cur = None
            for ln in header:
                if ln.startswith("<"):
                    cur = ln.strip("<>")
                    continue
                k, v = ln.split("=", 1)
                if cur == block and k.strip() == key:
                    return v.strip()
            raise KeyError(f"{block}/{key}")

        nghost = int(from_header("mesh", "nghost"))

        mb_index, mb_logical, mb_geometry = [], [], []
        mb_data: Dict[str, list] = {v: [] for v in var_list}
        while fp.tell() < filesize:
            idx = np.frombuffer(fp.read(24), np.int32).astype(np.int64) \
                - nghost
            mb_index.append(idx)
            n1 = int(idx[1] - idx[0]) + 1
            n2 = int(idx[3] - idx[2]) + 1
            n3 = int(idx[5] - idx[4]) + 1
            mb_logical.append(np.frombuffer(fp.read(16), np.int32))
            mb_geometry.append(
                np.frombuffer(fp.read(6 * locsize), locdt))
            data = np.frombuffer(
                fp.read(n1 * n2 * n3 * nvars * varsize), vardt)
            data = data.reshape(nvars, n3, n2, n1)
            for vi, v in enumerate(var_list):
                mb_data[v].append(data[vi])

    out["header"] = header
    out["time"] = time
    out["cycle"] = cycle
    out["var_names"] = var_list
    out["nvars"] = nvars
    out["n_mbs"] = len(mb_index)
    out["mb_index"] = np.array(mb_index)
    out["mb_logical"] = np.array(mb_logical)
    out["mb_geometry"] = np.array(mb_geometry)
    out["mb_data"] = {v: np.array(d) for v, d in mb_data.items()}
    for key in ("nx1", "nx2", "nx3"):
        out["N" + key[1:]] = int(from_header("mesh", key))
    return out


def read_hst(filename: str) -> Dict[str, np.ndarray]:
    """Read a history file -> dict of column name -> array
    (reference: vis/python/athena_read.py hst())."""
    with open(filename) as f:
        lines = f.readlines()
    header = None
    for ln in lines:
        if ln.startswith("#") and "[1]" in ln:
            header = ln
    if header is None:
        raise ValueError("no hst column header found")
    import re
    names = re.findall(r"\[\d+\]=(\S+)", header)
    data = np.loadtxt(filename)
    data = np.atleast_2d(data)
    return {name: data[:, i] for i, name in enumerate(names)}


def read_tab(filename: str) -> Dict[str, np.ndarray]:
    """Read a formatted table dump -> dict of column name -> array."""
    with open(filename) as f:
        f.readline()
        cols = f.readline().lstrip("#").split()
    data = np.atleast_2d(np.loadtxt(filename))
    return {name: data[:, i] for i, name in enumerate(cols)}


def read_vtk(filename: str):
    """Read a legacy VTK STRUCTURED_POINTS file written by VtkOutput
    (reference reader: vis/python/athena_read.py vtk()).

    Returns (meta, dict of variable -> [n3, n2, n1] float array).
    """
    meta = {}
    data = {}
    with open(filename, "rb") as f:
        assert f.readline().startswith(b"# vtk DataFile")
        meta["title"] = f.readline().decode().strip()
        assert f.readline().strip() == b"BINARY"
        assert f.readline().strip() == b"DATASET STRUCTURED_POINTS"
        dims = f.readline().split()[1:]
        nc1, nc2, nc3 = (int(d) for d in dims)
        meta["origin"] = [float(v) for v in f.readline().split()[1:4]]
        meta["spacing"] = [float(v) for v in f.readline().split()[1:4]]
        n1 = nc1 - 1 if nc1 > 1 else 1
        n2 = nc2 - 1 if nc2 > 1 else 1
        n3 = nc3 - 1 if nc3 > 1 else 1
        line = f.readline()
        while not line.strip():
            line = f.readline()
        assert line.startswith(b"CELL_DATA")
        meta["ncells"] = int(line.split()[1])
        while True:
            line = f.readline()
            if not line:
                break
            if not line.strip():
                continue
            assert line.startswith(b"SCALARS"), line
            name = line.split()[1].decode()
            f.readline()  # LOOKUP_TABLE default
            raw = f.read(4 * n1 * n2 * n3)
            data[name] = np.frombuffer(raw, dtype=">f4").reshape(
                n3, n2, n1).astype(np.float64)
    return meta, data
