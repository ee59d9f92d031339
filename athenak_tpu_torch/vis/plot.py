"""Quick-look plotting: slices of bin dumps and history time series.

Parity target: reference vis/python/plot_slice.py / plot_hst.py — a
matplotlib CLI for snapshot slices (AMR-aware: each block drawn as its
own pcolormesh at its own resolution) and .hst column plots.

CLI:
  python -m athenak_tpu_torch.vis.plot slice <dump.bin> <variable> <out.png>
         [--dim x3] [--coord 0.0] [--log] [--vmin V] [--vmax V]
  python -m athenak_tpu_torch.vis.plot hst <file.hst> <column> <out.png> [--log]

A copy of ``athenak_tpu/vis/plot.py``; ``matplotlib`` is imported
only when a figure is drawn.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .readers import read_binary, read_hst


def plot_slice(binname: str, variable: str, outname: str,
               dim: str = "x3", coord: float = 0.0, log: bool = False,
               vmin=None, vmax=None, cmap: str = "viridis") -> str:
    """Slice plot of one variable at dim=coord (reference:
    plot_slice.py).  Blocks not intersecting the slice are skipped;
    intersecting blocks are drawn individually, which renders SMR/AMR
    meshes correctly without any resampling."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    f = read_binary(binname)
    if variable not in f["var_names"]:
        raise ValueError(f"variable '{variable}' not in dump "
                         f"(has {f['var_names']})")
    idim = {"x1": 0, "x2": 1, "x3": 2}[dim]
    pdims = [d for d in (0, 1, 2) if d != idim]
    labels = ["x1", "x2", "x3"]

    fig, ax = plt.subplots(figsize=(7, 6))
    norm = None
    if log:
        from matplotlib.colors import LogNorm
        norm = LogNorm(vmin=vmin, vmax=vmax)
    im = None
    for mb in range(f["n_mbs"]):
        g = f["mb_geometry"][mb]
        lo, hi = g[2 * idim], g[2 * idim + 1]
        if not (lo <= coord <= hi):
            continue
        data = f["mb_data"][variable][mb]  # [n3, n2, n1]
        n = data.shape[::-1][idim]
        k = min(int((coord - lo) / max(hi - lo, 1e-300) * n), n - 1)
        sl = [slice(None)] * 3
        sl[2 - idim] = k
        plane = data[tuple(sl)]
        e0 = np.linspace(g[2 * pdims[0]], g[2 * pdims[0] + 1],
                         plane.shape[1] + 1)
        e1 = np.linspace(g[2 * pdims[1]], g[2 * pdims[1] + 1],
                         plane.shape[0] + 1)
        im = ax.pcolormesh(e0, e1, plane, norm=norm, cmap=cmap,
                           vmin=None if log else vmin,
                           vmax=None if log else vmax)
    if im is None:
        raise ValueError(f"no meshblock intersects {dim}={coord}")
    ax.set_xlabel(labels[pdims[0]])
    ax.set_ylabel(labels[pdims[1]])
    ax.set_aspect("equal")
    ax.set_title(f"{variable}  t={f['time']:.4g}")
    fig.colorbar(im, ax=ax)
    fig.savefig(outname, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return outname


def plot_hst(hstname: str, column: str, outname: str,
             log: bool = False) -> str:
    """Time-series plot of one history column (reference: plot_hst.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h = read_hst(hstname)
    if column not in h:
        raise ValueError(f"column '{column}' not in {hstname} "
                         f"(has {list(h)})")
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(h["time"], h[column])
    if log:
        ax.set_yscale("log")
    ax.set_xlabel("time")
    ax.set_ylabel(column)
    ax.grid(alpha=0.3)
    fig.savefig(outname, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return outname


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="athenak_tpu_torch.vis.plot")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("slice")
    ps.add_argument("binfile")
    ps.add_argument("variable")
    ps.add_argument("outfile")
    ps.add_argument("--dim", default="x3", choices=("x1", "x2", "x3"))
    ps.add_argument("--coord", type=float, default=0.0)
    ps.add_argument("--log", action="store_true")
    ps.add_argument("--vmin", type=float, default=None)
    ps.add_argument("--vmax", type=float, default=None)
    ps.add_argument("--cmap", default="viridis")
    ph = sub.add_parser("hst")
    ph.add_argument("hstfile")
    ph.add_argument("column")
    ph.add_argument("outfile")
    ph.add_argument("--log", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "slice":
        print(plot_slice(args.binfile, args.variable, args.outfile,
                         dim=args.dim, coord=args.coord, log=args.log,
                         vmin=args.vmin, vmax=args.vmax, cmap=args.cmap))
    else:
        print(plot_hst(args.hstfile, args.column, args.outfile,
                       log=args.log))
    return 0


if __name__ == "__main__":
    sys.exit(main())
