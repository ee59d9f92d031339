"""Which adaptive runs take the block-pool route.

Counterpart of ``athenak_tpu/amr_pool.py`` (reference:
src/mesh/mesh.hpp:121 nmb_maxperrank).  The JAX package pads every
block-axis array of an adaptive run to a fixed capacity and feeds the
tree's tables to one compiled cycle as traced inputs, so that a tree
update never recompiles: pad slots clone block 0, the capacity climbs a
ladder, and ``installed`` swaps the tables at trace time.  All of that
exists for XLA's compile step, which the port does not have (a torch
cycle reads the mesh's tables as it runs), so none of it is ported: the
port rebuilds the mesh, boundaries and physics at every tree update and
remaps the state onto exactly ``nmb_total`` blocks.

What the pool also does is choose a route: ``<mesh_refinement>/block_pool``
(default ``supports_pool``) puts an adaptive mesh on the mixed-level
general path from its first cycle, flat tree or not (``mesh.py``).  The
port keeps that choice, so that it runs the kernels the JAX package
runs on the same deck.
"""

from __future__ import annotations


def supports_pool(pin) -> bool:
    """Pool mode covers Newtonian hydro/MHD adaptive runs: physics with
    global-module state or per-epoch geometry (Z4c, radiation, GR
    metrics, ion-neutral, particles, turbulence, gravity, shearing box)
    stays on the rebuild-per-epoch route (the JAX ``supports_pool``)."""
    for block in ("z4c", "adm", "radiation", "ion-neutral", "particles",
                  "turb_driving", "gravity", "shearing_box", "coord"):
        if pin.does_block_exist(block):
            return False
    return pin.does_block_exist("hydro") or pin.does_block_exist("mhd")
