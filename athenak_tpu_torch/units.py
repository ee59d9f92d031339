"""Code units and physical constants.

Counterpart of ``athenak_tpu/units.py`` (reference: ``units::Units``,
src/units/units.hpp:22-102, units.cpp:17-40): three base code scales in
cgs (length/mass/time) plus the mean molecular weight; in GR runs the
scales are derived from the BH mass and a density scale instead.  A copy
kept in the port so that it never imports the JAX package.
"""

from __future__ import annotations

# cgs values of named units (cgs unit per X)
CM_CGS = 1.0
PC_CGS = 3.0856775809623245e+18
KPC_CGS = 3.0856775809623245e+21
G_CGS = 1.0
MSUN_CGS = 1.98841586e+33
ATOMIC_MASS_UNIT_CGS = 1.660538921e-24
S_CGS = 1.0
YR_CGS = 3.15576e+7
MYR_CGS = 3.15576e+13
KM_S_CGS = 1.0e5

# physical constants (cgs)
K_BOLTZMANN_CGS = 1.3806488e-16
GRAV_CONSTANT_CGS = 6.67408e-8
SPEED_OF_LIGHT_CGS = 2.99792458e10
RAD_CONSTANT_CGS = 7.56573325e-15
ELECTRON_REST_MASS_ENERGY_CGS = 5.93e9  # kelvin

ROSSELAND_COEF_CGS = 1.95705e24
PLANCK_MINUS_ROSSELAND_COEF_CGS = 7.04536e25


class Units:
    """Code-unit scalings in cgs (multiply code value -> cgs value)."""

    def __init__(self, pin) -> None:
        self.length_cgs = pin.get_or_add_real("units", "length_cgs", 1.0)
        self.mass_cgs = pin.get_or_add_real("units", "mass_cgs", 1.0)
        self.time_cgs = pin.get_or_add_real("units", "time_cgs", 1.0)
        self.mu = pin.get_or_add_real("units", "mu", 1.0)

        # GR runs: fix geometric units from BH mass + density scale
        # (reference: src/units/units.cpp:24-32)
        if pin.get_or_add_boolean("coord", "general_rel", False):
            density_scale = pin.get_real("units", "density_cgs")
            bhmass_cgs = pin.get_real("units", "bhmass_msun") * MSUN_CGS
            self.length_cgs = (GRAV_CONSTANT_CGS * bhmass_cgs
                               / SPEED_OF_LIGHT_CGS ** 2)
            self.mass_cgs = density_scale * self.length_cgs ** 3
            self.time_cgs = self.length_cgs / SPEED_OF_LIGHT_CGS

    # derived code scales in cgs
    @property
    def velocity_cgs(self):
        return self.length_cgs / self.time_cgs

    @property
    def density_cgs(self):
        return self.mass_cgs / self.length_cgs ** 3

    @property
    def energy_cgs(self):
        return self.mass_cgs * self.velocity_cgs ** 2

    @property
    def pressure_cgs(self):
        return self.energy_cgs / self.length_cgs ** 3

    @property
    def temperature_cgs(self):
        """Temperature unit so T_cgs = temperature_cgs * (p/rho in code)."""
        return (self.velocity_cgs ** 2 * self.mu * ATOMIC_MASS_UNIT_CGS
                / K_BOLTZMANN_CGS)

    # constants in code units
    @property
    def k_boltzmann(self):
        return K_BOLTZMANN_CGS / (self.energy_cgs / self.temperature_cgs)

    @property
    def grav_constant(self):
        return GRAV_CONSTANT_CGS * self.density_cgs * self.time_cgs ** 2

    @property
    def speed_of_light(self):
        return SPEED_OF_LIGHT_CGS / self.velocity_cgs
