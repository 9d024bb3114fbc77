"""Tensor operations of the port: positional encoding, lattice resample,
and the hand-written CUDA kernels under `ops.kernels`."""
