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
with driven turbulence; Newtonian and SR hydrodynamics; static and
adaptive mesh refinement; vacuum Z4c numerical relativity with its
generators, puncture trackers, waveforms, constraints and CCE and
horizon dumps; RK1-RK4, the history, binary, table, restart, VTK and
waveform outputs (README.md lists the decks).
"""

__version__ = "0.1.0"
