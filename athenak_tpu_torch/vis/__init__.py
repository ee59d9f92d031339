"""Post-processing: readers, the bin -> athdf converter and quick-look
plots (parity with the reference's vis/python tools).
"""
