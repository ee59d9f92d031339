"""A radiation beam in snake coordinates (sinusoidally sheared flat
space).

Counterpart of ``athenak_tpu/pgen/rad_snake.py`` (reference:
src/pgen/radiation/rad_snake.cpp, inputs/radiation/snake.athinput): the
per-cell metric and tetrad override.  Flat spacetime in the coordinates
y' = y, x' = x + A sin(k pi y) has the off-diagonal g_12 = -A k pi
cos(k pi y); the tetrad is the Cartesian-aligned or the snake-aligned
one (``snake_tet``), the beam's direction follows the snake, and the
user sides hold zero intensity.  ``Radiation.set_geometry`` rebuilds
every derived table (n^0, n_0, the face n^d, na) from the snake metric,
as the reference's generator overwrites tet_c, tetcov_c and na
(rad_snake.cpp:60-240).
"""

from __future__ import annotations

import math

import torch

from ..radiation.tetrad import rotation_coefficients
from .rad_beam import beam_table, cell_coords, zero_bc_hook


def _snake_terms(Y, mag, kym):
    ct = -mag * kym * math.pi * torch.cos(kym * math.pi * Y)
    st = mag * (kym * math.pi) ** 2 * torch.sin(kym * math.pi * Y)
    return ct, st


def snake_metric(X, Y, Z, mag, kym):
    """(glower, gupper), nested 4x4 lists of tensors
    (rad_snake.cpp:270-300)."""
    ct, _ = _snake_terms(Y, mag, kym)
    zero = torch.zeros(torch.broadcast_shapes(X.shape, Y.shape, Z.shape),
                       dtype=Y.dtype, device=Y.device)
    one = 1.0 + zero
    g = [[-one, zero, zero, zero],
         [zero, one, -ct + zero, zero],
         [zero, -ct + zero, 1.0 + ct * ct, zero],
         [zero, zero, zero, one]]
    gi = [[-one, zero, zero, zero],
          [zero, 1.0 + ct * ct, ct + zero, zero],
          [zero, ct + zero, one, zero],
          [zero, zero, zero, one]]
    return g, gi


def snake_geometry(X, Y, Z, mag, kym, snake_tet):
    """(g, gi, e, ecov, omega): the whole snake geometry
    (ComputeSnakeMetricAndTetrad, rad_snake.cpp:270-370)."""
    ct, st = _snake_terms(Y, mag, kym)
    g, gi = snake_metric(X, Y, Z, mag, kym)
    zero = g[0][1]
    one = g[1][1]
    # dg[k][i][j] = d_k g_ij and de[k][a][mu] = d_k e_(a)^mu (k = 0 the
    # time derivative)
    dg = [[[zero for _ in range(4)] for _ in range(4)] for _ in range(4)]
    dg[2][1][2] = -st + zero
    dg[2][2][1] = -st + zero
    dg[2][2][2] = 2.0 * ct * st
    de = [[[zero for _ in range(4)] for _ in range(4)] for _ in range(4)]
    if not snake_tet:
        # the Cartesian-aligned tetrad (rad_snake.cpp:305-315)
        e = [[one, zero, zero, zero],
             [zero, one, zero, zero],
             [zero, ct + zero, one, zero],
             [zero, zero, zero, one]]
        de[2][2][1] = st + zero
    else:
        # the snake-aligned tetrad (rad_snake.cpp:317-330)
        rt = torch.sqrt(1.0 + ct * ct)
        e = [[one, zero, zero, zero],
             [zero, rt, ct / rt, zero],
             [zero, zero, 1.0 / rt, zero],
             [zero, zero, zero, one]]
        de[2][1][1] = ct * st / rt
        de[2][1][2] = st / rt ** 3
        de[2][2][2] = -ct * st / rt ** 3
    ecov = [[sum(g[j][k] * e[i][k] for k in range(4)) for j in range(4)]
            for i in range(4)]
    omega = rotation_coefficients(e, ecov, gi, dg, de)
    return g, gi, e, ecov, omega


def init(pin, mesh, phys):
    rad = getattr(phys, "rad", phys)
    mag = pin.get_real("problem", "snake_mag")
    kym = pin.get_real("problem", "snake_kym")
    snake_tet = pin.get_or_add_boolean("problem", "snake_tet", False)
    dii_dt = pin.get_or_add_real("radiation", "dii_dt", 1.0)
    pin.get_or_add_boolean("radiation", "beam_source", True)
    pos = [pin.get_real("problem", f"pos_{i}") for i in (1, 2, 3)]
    width = pin.get_real("problem", "width")
    spread = pin.get_real("problem", "spread")

    # install the snake geometry: every derived table is rebuilt
    rad.set_geometry(
        lambda X, Y, Z: snake_geometry(X, Y, Z, mag, kym, snake_tet)[2:4],
        lambda X, Y, Z: snake_geometry(X, Y, Z, mag, kym, snake_tet)[4])

    # the beam in snake coordinates (rad_snake.cpp:192-265): its
    # direction follows the snake, d ~ (-A k pi cos(k pi y), 1, 0)
    X, Y, Z = cell_coords(rad)
    gl, _gi, e, _ecov, _ = snake_geometry(X, Y, Z, mag, kym, snake_tet)
    dmag = torch.sqrt(1.0 + (mag * kym * math.pi
                             * torch.cos(kym * math.pi * Y)) ** 2)
    d1 = (-mag * kym * math.pi * torch.cos(kym * math.pi * Y)) / dmag
    d2 = 1.0 / dmag
    rad.beam_dii0 = beam_table(rad, gl, e, (X - pos[0], Y - pos[1],
                                            Z - pos[2]),
                               (d1, d2, torch.zeros_like(d2)), width,
                               spread, dii_dt)
    # zero intensity on the user sides of x1 and x2
    phys.bvals.user_bc_func = zero_bc_hook(mesh, rad, ("x1", "x2"))
    i0 = torch.zeros(rad.shape, dtype=rad.dtype, device=rad.device)
    return phys.make_state(i0)
