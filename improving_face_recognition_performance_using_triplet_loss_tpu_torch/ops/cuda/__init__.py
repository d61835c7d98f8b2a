"""Wrappers of the port's hand-written Hopper kernels, all CUDA C++: ``nms``
(B5), ``stem`` (B3 and B4), ``efm3`` (B2 and its backward ``efm3_bwd``),
``mining`` (B1) and ``front9``
(B6: f32 on the CUDA cores, bf16 on the tensor cores).

Each wrapper launches its kernel for a CUDA tensor and runs the kernel's
plain PyTorch version for a CPU tensor, and counts its launches in the
module's ``launches``. ``_build`` compiles the CUDA sources of ``csrc/``.
"""
