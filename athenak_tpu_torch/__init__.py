"""PyTorch + CUDA port of athenak_tpu for NVIDIA Hopper (H100).

The JAX package ``athenak_tpu`` is the reference; this package takes the
same athinput decks and CLI flags and keeps its module names and array
layouts, so each module here has a counterpart there.  Modules of the JAX
package that import only numpy (``athinput``, ``indices``, ``mesh``,
``coordinates``, ``vis.readers``, ``utils``) are imported, not copied.
Plain tensor code is PyTorch; each Pallas kernel on the ported path is a
hand-written CUDA kernel under ``csrc/``, built with nvcc at first use
(``kernels/``).  This package never imports jax.

Ported so far: the 3-D Newtonian ideal-MHD main path (PLM + HLLD, RK2,
periodic or outflow single-level meshes, the blast problem generator and
``bin`` outputs).
"""

__version__ = "0.1.0"
