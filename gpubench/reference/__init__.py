"""Plain references for the benchmark's comparison that decides
``correct``: NumPy, PyTorch and the standard library only, never the
program under test."""
