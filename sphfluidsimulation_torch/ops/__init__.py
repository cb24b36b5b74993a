"""Operators of the torch port: elementwise SPH math, the sorted frame, the
CUDA kernels and their plain versions. Importing the package builds and
loads no kernel: that happens at a kernel's first launch."""

from . import sph_math, noise, brute, grid, cellops  # noqa: F401
