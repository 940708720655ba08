"""Primitives, the CUDA kernels' wrappers and their dispatch (``fused``)."""
