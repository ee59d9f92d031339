"""Primitive-solver EOS framework for dynamical GR(M)HD.

Counterpart of ``athenak_tpu/eos_ps/`` (reference:
src/eos/primitive-solver/): pluggable EOS policies (ideal gas, piecewise
polytrope, tabulated CompOSE with exact or NQT fast logs, the cold-table
hybrid) behind a whole-tensor Kastaun-style con-to-prim solver.
"""

from .policies import (CompOSEPS, HybridPS, IdealGasPS, NQTLogs, NormalLogs,
                       PiecewisePolytropePS, make_policy)
from .primitive_solver import (PrimitiveSolverPS, lower, raise_, contract,
                               spatial_det, spatial_inv, sym6)

__all__ = [
    "CompOSEPS", "HybridPS", "IdealGasPS", "NQTLogs", "NormalLogs",
    "PiecewisePolytropePS", "make_policy", "PrimitiveSolverPS",
    "lower", "raise_", "contract", "spatial_det", "spatial_inv", "sym6",
]
