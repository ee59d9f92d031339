"""Variable-index conventions and global enums.

A copy of ``athenak_tpu/indices.py``, kept in the port so that the port
never imports the JAX package.

Parity with the reference enums (reference: src/athena.hpp:65-83).  Conserved
hydro variables are (density, momenta, total energy); primitives are
(density, velocities, internal energy density e) with p = (gamma-1) e for the
ideal gas EOS — matching the reference's storage of ``w0(m,IEN,...)`` as
internal energy, not pressure (reference: src/eos/ideal_hyd.cpp).
"""

# conserved / primitive variable indices
IDN = 0
IM1 = 1
IVX = 1
IM2 = 2
IVY = 2
IM3 = 3
IVZ = 3
IEN = 4
IPR = 4
IYF = 5

# magnetic field components (cell- or face-centered arrays)
IBX = 0
IBY = 1
IBZ = 2
NMAG = 3

RECONSTRUCTION_METHODS = ("dc", "plm", "ppm4", "ppmx", "wenoz")

# number of ghost cells each reconstruction method requires
# (reference enforces ng>=2 for plm, >=3 for ppm4/ppmx/wenoz:
#  src/hydro/hydro.cpp constructor checks)
RECON_NGHOST = {"dc": 2, "plm": 2, "ppm4": 3, "ppmx": 3, "wenoz": 3,
                "teno": 3}

HYDRO_RSOLVERS = ("advect", "llf", "hlle", "hllc", "roe")
MHD_RSOLVERS = ("advect", "llf", "hlle", "hlld")
