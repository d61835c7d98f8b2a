"""Kernel B2 wrapper: the 3-way EFM activation (``csrc/efm3.cu``).

``efm3_rows(x)`` maps ``[rows, C]`` to ``[rows, 2C/3]`` as
``concat(max(s0, s1, s2), min(s0, s1, s2))`` over the channel thirds, for
f32, bf16, f16 and f64. A CUDA tensor launches the kernel; a CPU tensor
runs ``efm3_rows_plain``. NaN propagates as ``torch.maximum`` /
``torch.minimum`` propagate it, so the kernel equals the plain version bit
for bit.

Where a gradient is needed (grad mode on and ``x.requires_grad``) the call
goes through ``EFM3Rows``, an autograd Function that saves ``x``: its
backward ``efm3_rows_bwd`` launches the kernel ``efm3_bwd`` for a CUDA
tensor (counted in ``bwd_launches``) and runs ``efm3_rows_bwd_plain``, the
autograd of the plain version, for a CPU one. The two are bit-equal, ties
(split as the nested ``torch.maximum`` / ``torch.minimum`` split them) and
NaN included. Otherwise the forward launches directly and saves nothing.

The kernel takes a few microseconds on the card at the path's shapes, so
the launch is kept lean on the host: the ctypes function and the stream
getter are resolved once, the output is one allocation (``new_empty``),
and the call passes plain integers (data pointers, the current stream's
handle) without entering a device context.
"""

import ctypes
import functools

import torch

from ._build import LaunchCount, check, load, require_cuda_or_cpu

launches = LaunchCount("efm3")
bwd_launches = LaunchCount("efm3_bwd")

# the dtype codes of csrc/efm3.cu's efm3()
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
           torch.float64: 3}


def efm3_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``[rows, C] -> [rows, 2C/3]``."""
    t = x.shape[1] // 3
    s0, s1, s2 = x[:, :t], x[:, t:2 * t], x[:, 2 * t:]
    mx = torch.maximum(torch.maximum(s0, s1), s2)
    mn = torch.minimum(torch.minimum(s0, s1), s2)
    return torch.cat([mx, mn], dim=1)


def efm3_rows_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward: the gradient of
    ``efm3_rows_plain`` at ``x`` [rows, C] for the output gradient ``g``
    [rows, 2C/3], by autograd."""
    with torch.enable_grad():
        xr = x.detach().requires_grad_(True)
        (dx,) = torch.autograd.grad(efm3_rows_plain(xr), xr, g)
    return dx


@functools.cache
def _fns():
    fn = load("efm3").efm3
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # the current stream's raw handle for a device index, without building a
    # torch.cuda.Stream object
    return fn, torch._C._cuda_getCurrentRawStream


@functools.cache
def _bwd_fn():
    fn = load("efm3").efm3_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _code(x: torch.Tensor) -> int:
    code = _DTYPES.get(x.dtype)
    if code is None:
        raise ValueError(f"efm3 kernel takes f32, bf16, f16 or f64, got "
                         f"{x.dtype}")
    return code


def _launch(x: torch.Tensor, rows: int, c: int) -> torch.Tensor:
    code = _code(x)
    if not x.is_contiguous():
        raise ValueError("efm3 kernel takes a contiguous [rows, C] tensor")
    out = x.new_empty((rows, 2 * (c // 3)))
    if rows == 0 or c == 0:
        return out
    fn, stream = _fns()
    check(fn(x.data_ptr(), out.data_ptr(), rows, c // 3, code,
             stream(x.get_device())), "efm3")
    launches.count += 1
    return out


def _launch_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    code = _code(x)
    rows, c = x.shape
    if g.device != x.device or g.dtype != x.dtype:
        raise ValueError(f"efm3_bwd: g is {g.dtype} on {g.device}, x "
                         f"{x.dtype} on {x.device}")
    if tuple(g.shape) != (rows, 2 * (c // 3)):
        raise ValueError(f"efm3_bwd: g {tuple(g.shape)} for x {(rows, c)}")
    x, g = x.contiguous(), g.contiguous()
    dx = torch.empty_like(x)
    if rows == 0 or c == 0:
        return dx
    check(_bwd_fn()(x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows, c // 3,
                    code, torch._C._cuda_getCurrentRawStream(
                        x.get_device())), "efm3_bwd")
    bwd_launches.count += 1
    return dx


def efm3_rows_bwd(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The gradient of ``efm3_rows`` at ``x`` [rows, C] for the output
    gradient ``g`` [rows, 2C/3]: kernel ``efm3_bwd`` for CUDA tensors,
    :func:`efm3_rows_bwd_plain` for CPU tensors."""
    if require_cuda_or_cpu(x, "efm3_bwd"):
        return _launch_bwd(x, g)
    return efm3_rows_bwd_plain(x, g)


class EFM3Rows(torch.autograd.Function):
    """``efm3_rows`` with a gradient: the forward as :func:`efm3_rows`
    computes it, saving ``x``; the backward :func:`efm3_rows_bwd`."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        rows, c = x.shape
        return _launch(x, rows, c) if x.is_cuda else efm3_rows_plain(x)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return efm3_rows_bwd(x, g.to(x.dtype))


def efm3_rows(x: torch.Tensor) -> torch.Tensor:
    """``[rows, C] -> [rows, 2C/3]``: kernel B2 for a CUDA tensor, the
    plain version for a CPU tensor, through ``EFM3Rows`` where a gradient
    is needed. Rejects ``C % 3 != 0``, a tensor that is not 2-D and one
    that is not float (the kernel: not f32, bf16, f16 or f64)."""
    shape = x.shape
    if len(shape) != 2:
        raise ValueError(f"expected [rows, C], got {tuple(shape)}")
    rows, c = shape
    if c % 3:
        raise ValueError(f"channels must divide by 3, got {c}")
    if x.requires_grad and torch.is_grad_enabled():
        require_cuda_or_cpu(x, "efm3")
        return EFM3Rows.apply(x)
    if x.is_cuda:   # the inference case first: no device object is built
        return _launch(x, rows, c)
    if not x.is_floating_point():
        raise ValueError(f"efm3 takes a float tensor, got {x.dtype}")
    require_cuda_or_cpu(x, "efm3")
    return efm3_rows_plain(x)
