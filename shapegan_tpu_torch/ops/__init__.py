"""Tensor ops: coordinates, the SDF MLP and its CUDA kernels, mesh extraction."""
