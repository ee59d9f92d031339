"""Radiation support: the geodesic angular grid (``geodesic_grid.py``);
the transport itself is not ported yet."""
