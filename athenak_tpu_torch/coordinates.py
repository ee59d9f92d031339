"""Coordinates / relativity mode flags.

Counterpart of ``athenak_tpu/coordinates.py`` (reference:
src/coordinates/coordinates.cpp:30-60): <coord>/special_rel and
<coord>/general_rel select the SR/GR variants of every physics module.
A copy of ``CoordData`` and ``Coordinates``, kept in the port so that it
never imports the JAX package; ``GRGeometry`` is not ported yet.
"""

from __future__ import annotations


class CoordData:
    """GR coordinate parameters
    (reference: src/coordinates/coordinates.cpp:46-71)."""

    def __init__(self, pin) -> None:
        self.is_minkowski = pin.get_or_add_boolean("coord", "minkowski",
                                                   False)
        if not self.is_minkowski:
            self.bh_spin = pin.get_real("coord", "a")
            self.bh_excise = pin.get_or_add_boolean("coord", "excise", True)
        else:
            self.bh_spin = 0.0
            self.bh_excise = False
        if self.bh_excise:
            self.dexcise = pin.get_real("coord", "dexcise")
            self.pexcise = pin.get_real("coord", "pexcise")
            self.rexcise = 1.0
        else:
            self.dexcise = self.pexcise = -1.0
            self.rexcise = 0.0


class Coordinates:
    def __init__(self, pin) -> None:
        if pin.does_block_exist("coord"):
            self.is_special_relativistic = pin.get_or_add_boolean(
                "coord", "special_rel", False)
            self.is_general_relativistic = pin.get_or_add_boolean(
                "coord", "general_rel", False)
        else:
            self.is_special_relativistic = False
            self.is_general_relativistic = False
        if self.is_special_relativistic and self.is_general_relativistic:
            raise ValueError("cannot specify both special_rel and general_rel")
        self.coord_data = CoordData(pin) \
            if self.is_general_relativistic else None
