"""Kernel B6 wrapper: LightCNN9's fused front half (``csrc/front9.cu``).

``front9_chain(x, params)`` computes conv1 (5x5 SAME) + mfm2 + 2x2/2 pool
-> conv2a (1x1) + mfm2 -> conv2 (3x3 SAME) + mfm2 -> 2x2/2 pool in one
pass: x ``[B, H, W, 1]`` (H == W, a multiple of 4, the precondition of the
JAX package's ``front9_chain_pallas``) -> ``[B, H/4, W/4, C2/2]`` in x's
dtype, f32 sums. ``params`` holds the three convs as the flax tree does:
``{"conv1": {"kernel": [5, 5, 1, C1], "bias": [C1]}, "conv2a": {"kernel":
[1, 1, C1/2, C2a], ...}, "conv2": {"kernel": [3, 3, C2a/2, C2], ...}}``.

A CUDA tensor launches the kernel with the weights in its layout
(:func:`pack_front9_weights`, computed once per model and dtype by the
caller, or here when not given); a CPU tensor runs :func:`front9_plain`,
the port of ``front_kernel.py::front9_reference``: ``reference_stem`` ->
1x1 conv + mfm2 -> 3x3 SAME conv + mfm2 -> pool, computed in f32 from
inputs rounded to x's dtype, each stage's output rounded to x's dtype where
the Pallas kernel rounds it (equal to ``front9_reference`` in f32).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..mfm import mfm2
from ..s2d_stem import reference_stem
from ._build import LaunchCount, check, load, require_cuda_or_cpu

launches = LaunchCount("front9")

# conv2's output channels go through the kernel in chunks of this many
# mfm2 pairs (csrc/front9.cu PAIRS)
PAIRS = 16


def _widths(params) -> tuple[int, int, int]:
    return (params["conv1"]["kernel"].shape[3],
            params["conv2a"]["kernel"].shape[3],
            params["conv2"]["kernel"].shape[3])


def _check_args(x, params):
    if x.ndim != 4 or x.shape[3] != 1:
        raise ValueError(f"expected x [B, H, W, 1], got {tuple(x.shape)}")
    if x.shape[1] != x.shape[2] or x.shape[1] % 4:
        raise ValueError(f"front9 takes H == W, a multiple of 4; got "
                         f"{tuple(x.shape[1:3])}")
    c1, c2a, c2 = _widths(params)
    shapes = {"conv1": (5, 5, 1, c1), "conv2a": (1, 1, c1 // 2, c2a),
              "conv2": (3, 3, c2a // 2, c2)}
    for name, shape in shapes.items():
        k, b = params[name]["kernel"], params[name]["bias"]
        if tuple(k.shape) != shape or tuple(b.shape) != (shape[3],):
            raise ValueError(f"{name}: expected kernel {shape} and bias "
                             f"[{shape[3]}], got {tuple(k.shape)} and "
                             f"{tuple(b.shape)}")
    if c1 % 2 or c2a % 2 or c2 % 2:
        raise ValueError(f"mfm2 needs even widths, got {(c1, c2a, c2)}")


def _conv(x, kernel, padding):
    """An NHWC conv with an HWIO kernel, no bias."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                 padding=padding)
    return y.permute(0, 2, 3, 1)


def front9_plain(x: torch.Tensor, params: dict) -> torch.Tensor:
    """Plain PyTorch version of kernel B6."""
    _check_args(x, params)
    dt = x.dtype

    def p(name, key):
        return params[name][key].to(dt).float() if key == "kernel" \
            else params[name][key].float()

    y = reference_stem(x.float(), p("conv1", "kernel"), p("conv1", "bias"),
                       maxout=2).to(dt).float()
    y = mfm2(_conv(y, p("conv2a", "kernel"), 0)
             + p("conv2a", "bias")).to(dt).float()
    y = mfm2(_conv(y, p("conv2", "kernel"), 1) + p("conv2", "bias"))
    y = F.max_pool2d(y.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    return y.to(dt)


@torch.no_grad()
def pack_front9_weights(params: dict, dtype: torch.dtype) -> dict:
    """The kernel's weight layout (the port's counterpart of the JAX
    package's ``pack_front9_weights``): float32 tensors on the weights'
    device, kernels rounded to ``dtype`` first.

    ``w1`` [25, C1]; ``w2a`` [C1/2, C2a/2, 2] (the mfm2 pair j, j + C2a/2
    side by side); ``w2`` [C2/(2*PAIRS), 9*C2a/2, PAIRS, 2] (one contiguous
    block per chunk of PAIRS pairs, rows (di, dj, cin)); biases as they
    are."""
    c1, c2a, c2 = _widths(params)
    if (c1 // 2) % 4 or (c2a // 2) % 4 or (c2 // 2) % PAIRS:
        raise ValueError(f"front9 kernel: widths {(c1, c2a, c2)} need C1/2 "
                         f"and C2a/2 divisible by 4, C2/2 by {PAIRS}")

    def k(name):
        return params[name]["kernel"].detach().to(dtype).float()

    def b(name):
        return params[name]["bias"].detach().float().contiguous()

    w2a = k("conv2a").reshape(c1 // 2, 2, c2a // 2).transpose(1, 2)
    w2 = k("conv2").reshape(9 * (c2a // 2), 2, c2 // (2 * PAIRS), PAIRS)
    return {"w1": k("conv1").reshape(25, c1).contiguous(), "b1": b("conv1"),
            "w2a": w2a.contiguous(), "b2a": b("conv2a"),
            "w2": w2.permute(2, 0, 3, 1).contiguous(), "b2": b("conv2"),
            "widths": (c1, c2a, c2), "dtype": dtype}


@functools.cache
def _fns():
    lib = load("front9")
    fns = {}
    for dtype, name in ((torch.float32, "front9_f32"),
                        (torch.bfloat16, "front9_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.front9_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.front9_smem_bytes.restype = ctypes.c_int
    return lib, fns


def smem_bytes(c1: int, c2a: int) -> int:
    """The kernel's dynamic shared memory per CTA at these widths."""
    return _fns()[0].front9_smem_bytes(c1, c2a)


def _launch(x, packed):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"front9 kernel takes f32 or bf16, got {x.dtype}")
    if packed["dtype"] != x.dtype:
        raise ValueError(f"weights packed for {packed['dtype']}, x is "
                         f"{x.dtype}")
    lib, fns = _fns()
    b, h, w, _ = x.shape
    c1, c2a, c2 = packed["widths"]
    if lib.front9_smem_bytes(c1, c2a) > 227 * 1024:
        raise ValueError(f"front9 kernel: widths {(c1, c2a)} exceed its "
                         "shared memory")
    ws = [packed[n] for n in ("w1", "b1", "w2a", "b2a", "w2", "b2")]
    for t in ws:
        if t.device != x.device or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("packed weights must be contiguous float32 on "
                             f"{x.device}")
    xc = x.contiguous()
    out = torch.empty((b, h // 4, w // 4, c2 // 2), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    rc = fns[x.dtype](xc.data_ptr(), *[t.data_ptr() for t in ws],
                      out.data_ptr(), b, h, w, c1, c2a, c2,
                      torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "front9_chain")
    launches.count += 1
    return out


def front9_chain(x: torch.Tensor, params: dict,
                 packed: dict | None = None) -> torch.Tensor:
    """LightCNN9 conv1..pool2: kernel B6 for a CUDA tensor (``packed`` from
    :func:`pack_front9_weights` for x's dtype, packed here when None), the
    plain version for a CPU tensor."""
    _check_args(x, params)
    if require_cuda_or_cpu(x, "front9"):
        if packed is None:
            packed = pack_front9_weights(params, x.dtype)
        return _launch(x, packed)
    return front9_plain(x, params)
