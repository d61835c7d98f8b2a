"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. A CUDA device on a machine without CUDA
    raises: the port never falls back to the CPU silently — pass
    ``device="cpu"`` to run there on purpose."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's "
            "plain PyTorch path on the CPU")
    return dev


def full_f32() -> None:
    """Compute float32 convolutions and matrix products in full float32.

    PyTorch's default runs cuDNN's float32 convolutions in TF32 (about
    three decimal digits), while the JAX twin computes them in full f32.
    The CLIs call this once in ``main``; a library caller sets the flags
    itself. Hand-written kernels are not affected by either flag."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
