"""Tensor ops of the port: MFM/EFM activations, gallery distances, box ops
and NMS, the space-to-depth stem. ``ops/cuda/`` wraps the hand-written
Hopper kernels."""
