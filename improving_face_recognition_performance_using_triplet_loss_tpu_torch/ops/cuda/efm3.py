"""Kernel B2: the 3-way EFM activation, written in Triton.

``efm3_rows(x)`` maps ``[rows, C]`` to ``[rows, 2C/3]`` as
``concat(max(s0, s1, s2), min(s0, s1, s2))`` over the channel thirds, for
any float dtype. A CUDA tensor launches the Triton kernel; a CPU tensor
runs ``efm3_rows_plain``.

Replaces: ``ops/pallas/mfm_kernel.py::efm3_pallas`` of the JAX package.

What bounds it on the H100: device-memory bytes. It reads each input once
and writes 2/3 of it, with two compares per output element and no reuse,
about 0.3 operations per byte against a ridge of some 20 (f32 rate over
memory rate).

What the design does about it: one pass, nothing staged. A program owns
``BLOCK_R`` rows and loads the three thirds of each row as masked
``[BLOCK_R, BLOCK_T]`` blocks (``BLOCK_T`` the third rounded up to a power
of two), so neighbouring lanes read neighbouring addresses, and stores the
max and min halves of the output row. About 4,096 elements per program keep
enough loads in flight to cover memory latency. ``max`` and ``min``
propagate NaN as ``torch.maximum`` does, so the result equals the plain
version bit for bit.
"""

import functools

import torch

from ._build import LaunchCount, require_cuda_or_cpu

launches = LaunchCount("efm3")

tl = None  # triton.language, bound by _kernel() at the first launch

_BLOCK_ELEMS = 4096


def efm3_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``[rows, C] -> [rows, 2C/3]``."""
    t = x.shape[1] // 3
    s0, s1, s2 = x[:, :t], x[:, t:2 * t], x[:, 2 * t:]
    mx = torch.maximum(torch.maximum(s0, s1), s2)
    mn = torch.minimum(torch.minimum(s0, s1), s2)
    return torch.cat([mx, mn], dim=1)


@functools.cache
def _kernel():
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def efm3_kernel(x_ptr, out_ptr, rows, third,
                    BLOCK_R: tl.constexpr, BLOCK_T: tl.constexpr):
        r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)[:, None]
        t = tl.arange(0, BLOCK_T)[None, :]
        mask = (r < rows) & (t < third)
        src = x_ptr + r.to(tl.int64) * (3 * third) + t
        s0 = tl.load(src, mask=mask)
        s1 = tl.load(src + third, mask=mask)
        s2 = tl.load(src + 2 * third, mask=mask)
        mx = tl.maximum(tl.maximum(s0, s1, propagate_nan=tl.PropagateNan.ALL),
                        s2, propagate_nan=tl.PropagateNan.ALL)
        mn = tl.minimum(tl.minimum(s0, s1, propagate_nan=tl.PropagateNan.ALL),
                        s2, propagate_nan=tl.PropagateNan.ALL)
        dst = out_ptr + r.to(tl.int64) * (2 * third) + t
        tl.store(dst, mx, mask=mask)
        tl.store(dst + third, mn, mask=mask)

    return triton, efm3_kernel


def block_shape(third: int) -> tuple[int, int]:
    """(BLOCK_R, BLOCK_T) of a launch for channel thirds of ``third``."""
    block_t = max(16, 1 << (third - 1).bit_length())
    return max(1, _BLOCK_ELEMS // block_t), block_t


def _launch(x: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("efm3 kernel takes a contiguous [rows, C] tensor")
    rows, c = x.shape
    third = c // 3
    out = torch.empty((rows, 2 * third), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    triton, kern = _kernel()
    block_r, block_t = block_shape(third)
    with torch.cuda.device(x.device):
        kern[(triton.cdiv(rows, block_r),)](
            x, out, rows, third, BLOCK_R=block_r, BLOCK_T=block_t,
            num_warps=4)
    launches.count += 1
    return out


def efm3_rows(x: torch.Tensor) -> torch.Tensor:
    """``[rows, C] -> [rows, 2C/3]``: kernel B2 for a CUDA tensor, the
    plain version for a CPU tensor. Rejects ``C % 3 != 0``."""
    if x.ndim != 2:
        raise ValueError(f"expected [rows, C], got {tuple(x.shape)}")
    if x.shape[1] % 3:
        raise ValueError(f"channels must divide by 3, got {x.shape[1]}")
    if not x.is_floating_point():
        raise ValueError(f"efm3 takes a float tensor, got {x.dtype}")
    if require_cuda_or_cpu(x, "efm3"):
        return _launch(x)
    return efm3_rows_plain(x)
