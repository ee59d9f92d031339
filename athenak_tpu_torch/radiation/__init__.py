"""Radiation transport: the geodesic angular grid (``geodesic_grid.py``),
the tetrads (``tetrad.py``), the transport (``radiation.py``), the
implicit coupling (``coupling.py``) and radiation with a fluid
(``rad_fluid.py``)."""
