"""PyTorch + CUDA port of athenak_tpu for NVIDIA Hopper (H100).

The JAX package ``athenak_tpu`` is the reference; this package takes the
same athinput decks and CLI flags and keeps its module names and array
layouts, so each module here has a counterpart there.  It imports nothing
of the JAX package: the modules it needs that import only numpy there
(``athinput``, ``indices``, ``mesh``, ``coordinates``, ``utils``) are
copied here.  Plain tensor code is PyTorch; each Pallas kernel on the
ported paths is a hand-written CUDA kernel under ``csrc/``, built with
nvcc at first use (``kernels/``).

Ported so far: 3-D ideal MHD on single-level meshes, Newtonian (PLM +
HLLD) and special-relativistic (PLM + HLLE or LLF, the Kastaun c2p),
with driven turbulence; vacuum Z4c numerical relativity (the single
puncture); RK1-RK4, periodic or outflow boundaries, the blast, turb and
z4c_one_puncture problem generators and ``bin`` outputs.
"""

__version__ = "0.1.0"
