"""Tensor operators: EOS, reconstruction, Riemann solver, kernel wrappers."""
