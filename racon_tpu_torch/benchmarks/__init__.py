"""Microbenchmarks of the port's kernels on one GPU (counterparts of the
repository's benchmarks/ scripts of the same names)."""
