"""Wrappers of the port's hand-written Hopper kernels: ``nms`` (B5, CUDA
C++), ``stem`` (B3 and B4, CUDA C++), ``efm3`` (B2, Triton), ``mining``
(B1, CUDA C++) and ``front9`` (B6, CUDA C++).

Each wrapper launches its kernel for a CUDA tensor and runs the kernel's
plain PyTorch version for a CPU tensor, and counts its launches in the
module's ``launches``. ``_build`` compiles the CUDA sources of ``csrc/``.
"""
