"""Z4c numerical relativity (vacuum, puncture gauge) on torch tensors."""
