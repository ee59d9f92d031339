"""General relativity on a fixed spacetime (Cartesian Kerr-Schild)."""
