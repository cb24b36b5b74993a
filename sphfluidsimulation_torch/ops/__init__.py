"""Operators of the torch port: elementwise SPH math, the sorted frame, the
CUDA kernels and their plain versions."""
