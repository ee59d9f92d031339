"""Z4c refinement strategies.

Counterpart of ``athenak_tpu/z4c/z4c_amr.py`` (reference:
src/z4c/z4c_amr.{hpp,cpp}): the ``<z4c_amr>`` methods ``trivial``,
``chi`` and ``dchi`` (a per-block reduction of the conformal factor on
the device) and the ``radius_N_rad`` / ``radius_N_reflevel``
minimum-level shells (host logic on the block extents).  The ``tracker``
method and the trilinear interpolation it takes its puncture positions
from need the puncture trackers (``<z4c>/nco > 0``), which are not
ported yet; the method raises.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..amr import block_interior, centred_diff_sq
from ..utils import not_ported
from .z4c import I_CHI


class Z4cAMR:
    """Parsed <z4c_amr> block (reference: Z4c_AMR::Z4c_AMR,
    z4c_amr.cpp:27-57): one exclusive method (trivial/chi/dchi) plus
    optional radius_N_rad / radius_N_reflevel minimum-level shells."""

    def __init__(self, pin) -> None:
        self.method = pin.get_or_add_string("z4c_amr", "method", "trivial")
        # deck aliases (reference inputs/z4c decks use chi_min / dchi_max
        # for what z4c_amr.cpp:30-43 calls chi / dchi)
        self.method = {"chi_min": "chi", "dchi_max": "dchi"}.get(
            self.method, self.method)
        if self.method == "tracker":
            raise not_ported("<z4c_amr> method=tracker (the puncture "
                             "trackers)")
        if self.method not in ("trivial", "chi", "dchi"):
            raise ValueError(
                f"<z4c_amr> method={self.method} unknown "
                "(trivial/tracker/chi/dchi)")
        self.chi_thresh = pin.get_or_add_real("z4c_amr", "chi_min", 0.2) \
            if self.method == "chi" else None
        self.dchi_thresh = pin.get_or_add_real(
            "z4c_amr", "dchi_max", 0.01) if self.method == "dchi" else None
        self.radius: List[float] = []
        self.reflevel: List[int] = []
        for nr in range(16):
            name = f"radius_{nr}_rad"
            if not pin.does_parameter_exist("z4c_amr", name):
                break
            self.radius.append(pin.get_real("z4c_amr", name))
            self.reflevel.append(pin.get_or_add_integer(
                "z4c_amr", f"radius_{nr}_reflevel", -1))

    # -- device part: chi / dchi block reductions -----------------------
    def device_flags(self, u, mesh):
        """int32 [nmb] flags of the chi/dchi methods on ``u``'s device
        (reference: RefineChiMin / RefineDchiMax, z4c_amr.cpp:133-226)."""
        mbi = mesh.mb_indcs
        chi = u[:, I_CHI]
        zero = torch.zeros(chi.shape[0], dtype=torch.int32, device=u.device)
        if self.method == "chi":
            qmin = torch.amin(block_interior(chi, mbi), dim=(1, 2, 3))
            t = self.chi_thresh
            return torch.where(qmin < t, 1,
                               torch.where(qmin > 1.25 * t, -1, zero))
        if self.method == "dchi":
            dmax = torch.amax(block_interior(
                torch.sqrt(centred_diff_sq(chi, mbi)), mbi), dim=(1, 2, 3))
            t = self.dchi_thresh
            return torch.where(dmax > t, 1,
                               torch.where(dmax < 0.5 * t, -1, zero))
        return zero

    # -- host part: the radial shells ------------------------------------
    def host_flags(self, flags, state, mesh, phys) -> np.ndarray:
        """The RefineRadii minimum-level shells (z4c_amr.cpp:228-275):
        a block whose nearest corner lies inside a shell is refined up to
        the shell's level and not derefined at it."""
        if not self.radius:
            return flags
        sz = mesh.mb_size
        lev = np.asarray(mesh.mb_lev)
        x1min, x1max = sz["x1min"], sz["x1max"]
        x2min, x2max = sz["x2min"], sz["x2max"]
        x3min, x3max = sz["x3min"], sz["x3max"]
        corners = [x1min ** 2 + x2min ** 2 + x3min ** 2]
        for cx in (x1min, x1max):
            for cy in (x2min, x2max):
                for cz in (x3min, x3max):
                    corners.append(cx ** 2 + cy ** 2 + cz ** 2)
        rmin2 = np.min(np.stack(corners), axis=0)
        for r, rl in zip(self.radius, self.reflevel):
            sel = rmin2 < r * r
            flags[sel & (lev < rl)] = 1
            flags[sel & (lev == rl) & (flags == -1)] = 0
        return flags
