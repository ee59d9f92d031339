"""L1/L-infinity error files of the convergence tests.

A copy of ``athenak_tpu/pgen/errors.py`` (reference:
src/pgen/pgen.cpp:680-899): one ``<basename>-errs.dat`` row a run with
Nx1 Nx2 Nx3 Ncycle RMS-L1 L-infty and then the L1 error of each
variable.  The arrays may be tensors on any device or numpy arrays.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def host(a):
    """A tensor or array as a float64 numpy array on the host."""
    if torch.is_tensor(a):
        return a.detach().to(device="cpu", dtype=torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def compute_errors(mesh, u_num, u_ref, nvars: int):
    """Volume-weighted L1 error of each of the first ``nvars`` variables
    of [nmb, nvar, n3, n2, n1] arrays and the global L-infinity error;
    returns (l1_err[nvars], linfty)."""
    mbi = mesh.mb_indcs
    sl = (slice(None), slice(0, nvars), slice(mbi.ks, mbi.ke + 1),
          slice(mbi.js, mbi.je + 1), slice(mbi.is_, mbi.ie + 1))
    diff = np.abs(host(u_num[sl]) - host(u_ref[sl]))
    ms = mesh.mesh_size
    vol = ((ms.x1max - ms.x1min) * (ms.x2max - ms.x2min)
           * (ms.x3max - ms.x3min))
    # per-block cell volume (level-dependent on a refined mesh)
    vol_cell = (np.asarray(mesh.mb_size["dx1"], dtype=np.float64)
                * np.asarray(mesh.mb_size["dx2"])
                * np.asarray(mesh.mb_size["dx3"]))
    l1 = (vol_cell[:, None] * diff.sum(axis=(2, 3, 4))).sum(axis=0) / vol
    linf = (vol_cell.reshape(-1, 1, 1, 1, 1) * diff).max() / vol
    return l1, linf


def write_error_file(pin, mesh, l1_err, linfty, header_vars) -> str:
    """Append a row to <basename>-errs.dat; returns the file name."""
    basename = pin.get_string("job", "basename")
    fname = basename + "-errs.dat"
    rms = float(np.sqrt(np.sum(np.square(l1_err))))
    new_file = not os.path.exists(fname)
    with open(fname, "a") as f:
        if new_file:
            cols = "".join(f"{v + '_L1':<14}" for v in header_vars)
            f.write("# Nx1  Nx2  Nx3   Ncycle   RMS-L1       L-infty       "
                    + cols + "\n")
        f.write(f"{mesh.mesh_indcs.nx1:04d}  {mesh.mesh_indcs.nx2:04d}  "
                f"{mesh.mesh_indcs.nx3:04d}  {mesh.ncycle:05d}  "
                f"{rms:e} {float(linfty):e}")
        for v in l1_err:
            f.write(f"  {float(v):e}")
        f.write("\n")
    return fname
