"""Hand-written Hopper kernels with their plain PyTorch versions.

Each kernel's CUDA source lives in ``csrc/``; ``_build`` compiles it
with ``nvcc`` at first use and binds it through ``ctypes``.
"""
