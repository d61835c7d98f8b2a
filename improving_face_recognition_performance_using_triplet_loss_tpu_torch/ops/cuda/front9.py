"""Kernel B6 wrapper: LightCNN9's fused front half (``csrc/front9.cu``).

``front9_chain(x, params)`` computes conv1 (5x5 SAME) + mfm2 + 2x2/2 pool
-> conv2a (1x1) + mfm2 -> conv2 (3x3 SAME) + mfm2 -> 2x2/2 pool in one
pass: x ``[B, H, W, 1]`` (H == W, a multiple of 4, the precondition of the
JAX package's ``front9_chain_pallas``) -> ``[B, H/4, W/4, C2/2]`` in x's
dtype, f32 sums. ``params`` holds the three convs as the flax tree does:
``{"conv1": {"kernel": [5, 5, 1, C1], "bias": [C1]}, "conv2a": {"kernel":
[1, 1, C1/2, C2a], ...}, "conv2": {"kernel": [3, 3, C2a/2, C2], ...}}``.

A CUDA tensor launches the kernel for its dtype: f32 the CUDA-core kernel
of ``csrc/front9.cu``, bf16 the tensor-core kernel of ``csrc/front9_tc.cu``
(LightCNN9's widths 96/96/192 only), each with the weights in its layout
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

launches = LaunchCount("front9")          # f32, csrc/front9.cu
tc_launches = LaunchCount("front9_bf16")  # bf16, csrc/front9_tc.cu

# conv2's output channels go through the kernel in chunks of this many
# mfm2 pairs (csrc/front9.cu PAIRS)
PAIRS = 16
# the only widths the bf16 kernel takes (csrc/front9_tc.cu C1, C2A, C2)
TC_WIDTHS = (96, 96, 192)


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
    """The weight layout of the kernel that ``dtype`` launches (the port's
    counterpart of the JAX package's ``pack_front9_weights``), on the
    weights' device: :func:`pack_front9_weights_tc` for bf16, else float32
    tensors for the CUDA-core kernel:

    ``w1`` [25, C1]; ``w2a`` [C1/2, C2a/2, 2] (the mfm2 pair j, j + C2a/2
    side by side); ``w2`` [C2/(2*PAIRS), 9*C2a/2, PAIRS, 2] (one contiguous
    block per chunk of PAIRS pairs, rows (di, dj, cin)); biases as they
    are."""
    if dtype == torch.bfloat16:
        return pack_front9_weights_tc(params)
    c1, c2a, c2 = _widths(params)
    if (c1 // 2) % 4 or (c2a // 2) % 4 or (c2 // 2) % PAIRS:
        raise ValueError(f"front9 kernel: widths {(c1, c2a, c2)} need C1/2 "
                         f"and C2a/2 divisible by 4, C2/2 by {PAIRS}")

    def k(name):
        return params[name]["kernel"].detach().float()

    w2a = k("conv2a").reshape(c1 // 2, 2, c2a // 2).transpose(1, 2)
    w2 = k("conv2").reshape(9 * (c2a // 2), 2, c2 // (2 * PAIRS), PAIRS)
    return {"w1": k("conv1").reshape(25, c1).contiguous(),
            "w2a": w2a.contiguous(), "w2": w2.permute(2, 0, 3, 1).contiguous(),
            **_biases(params), "widths": (c1, c2a, c2), "dtype": dtype}


def _biases(params) -> dict:
    def b(name):
        return params[name]["bias"].detach().float().contiguous()

    return {"b1": b("conv1"), "b2a": b("conv2a"), "b2": b("conv2")}


def _pad16(w: torch.Tensor, dim: int) -> torch.Tensor:
    """``w`` with zeros appended along ``dim`` up to a multiple of 16."""
    pad = -w.shape[dim] % 16
    if not pad:
        return w
    shape = list(w.shape)
    shape[dim] = pad
    return torch.cat([w, w.new_zeros(shape)], dim)


def _pairs(w: torch.Tensor) -> torch.Tensor:
    """[K, 2h] -> [K, 2h] with columns 2j, 2j+1 = columns j, j+h (an mfm2
    pair in one thread's accumulators)."""
    k, n = w.shape
    return w.reshape(k, 2, n // 2).transpose(1, 2).reshape(k, n)


def _frag_pack(bm: torch.Tensor) -> torch.Tensor:
    """A GEMM's B matrix [K, N] (K and N multiples of 16) in mma.sync
    m16n8k16's B-fragment order, [K/16, N/16, 32, 8]: for k16 step ks and
    n8 tiles 2np, 2np+1, lane l = 4g + t holds B[16ks + 2t + 8h + e, 16np
    + 8q + g] at 4q + 2h + e, so one 16-byte load gives both tiles'
    fragments."""
    k, n = bm.shape
    p = bm.reshape(k // 16, 2, 4, 2, n // 16, 2, 8)  # ks h t e np q g
    return p.permute(0, 4, 6, 2, 5, 1, 3).reshape(
        k // 16, n // 16, 32, 8).contiguous()


@torch.no_grad()
def pack_front9_weights_tc(params: dict) -> dict:
    """The bf16 tensor-core kernel's layout: each conv as a GEMM B matrix
    [K, N] in bf16, mfm2 pairs (j, j + N/2) in columns 2j, 2j+1, zero-padded
    to multiples of 16 and fragment-packed (:func:`_frag_pack`):

    ``w1`` K = the 25 taps (di, dj) padded to 32, N = C1; ``w2a`` K = C1/2,
    N = C2a; ``w2`` K = 9 taps x C2a/2 channels (tap-major, channels padded
    per tap), N = C2; biases f32 as they are."""
    c1, c2a, c2 = _widths(params)

    def k(name):
        return params[name]["kernel"].detach().to(torch.bfloat16)

    w1 = _pad16(_pad16(_pairs(k("conv1").reshape(25, c1)), 0), 1)
    w2a = _pad16(_pad16(_pairs(k("conv2a").reshape(c1 // 2, c2a)), 0), 1)
    w2 = _pad16(k("conv2").reshape(9, c2a // 2, c2), 1)
    w2 = _pad16(_pairs(w2.reshape(-1, c2)), 1)
    return {"w1": _frag_pack(w1), "w2a": _frag_pack(w2a),
            "w2": _frag_pack(w2),
            **_biases(params), "widths": (c1, c2a, c2),
            "dtype": torch.bfloat16}


@functools.cache
def _fns():
    lib = load("front9")
    lib.front9_f32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.front9_f32.restype = ctypes.c_int
    lib.front9_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.front9_smem_bytes.restype = ctypes.c_int
    return lib


@functools.cache
def _tc_lib():
    lib = load("front9_tc")
    lib.front9_tc.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.front9_tc.restype = ctypes.c_int
    lib.front9_tc_smem_bytes.argtypes = []
    lib.front9_tc_smem_bytes.restype = ctypes.c_int
    return lib


def smem_bytes(c1: int, c2a: int) -> int:
    """The f32 kernel's dynamic shared memory per CTA at these widths."""
    return _fns().front9_smem_bytes(c1, c2a)


def tc_smem_bytes() -> int:
    """The bf16 kernel's dynamic shared memory per CTA."""
    return _tc_lib().front9_tc_smem_bytes()


def _weights(x, packed, names, dtypes):
    if packed["dtype"] != x.dtype:
        raise ValueError(f"weights packed for {packed['dtype']}, x is "
                         f"{x.dtype}")
    ws = [packed[n] for n in names]
    for t, dt in zip(ws, dtypes):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"packed weights must be contiguous {dt} on "
                             f"{x.device}")
    return ws


def _launch(x, packed):
    if x.dtype == torch.bfloat16:
        return _launch_tc(x, packed)
    if x.dtype != torch.float32:
        raise ValueError(f"front9 kernel takes f32 or bf16, got {x.dtype}")
    lib = _fns()
    b, h, w, _ = x.shape
    c1, c2a, c2 = packed["widths"]
    if lib.front9_smem_bytes(c1, c2a) > 227 * 1024:
        raise ValueError(f"front9 kernel: widths {(c1, c2a)} exceed its "
                         "shared memory")
    ws = _weights(x, packed, ("w1", "b1", "w2a", "b2a", "w2", "b2"),
                  [torch.float32] * 6)
    xc = x.contiguous()
    out = torch.empty((b, h // 4, w // 4, c2 // 2), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    rc = lib.front9_f32(xc.data_ptr(), *[t.data_ptr() for t in ws],
                        out.data_ptr(), b, h, w, c1, c2a, c2,
                        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "front9_chain")
    launches.count += 1
    return out


def _launch_tc(x, packed):
    if packed["widths"] != TC_WIDTHS:
        raise ValueError(f"front9 bf16 kernel takes widths {TC_WIDTHS}, got "
                         f"{packed['widths']}")
    ws = _weights(x, packed, ("w1", "w2a", "w2", "b1", "b2a", "b2"),
                  [torch.bfloat16] * 3 + [torch.float32] * 3)
    b, h, w, _ = x.shape
    xc = x.contiguous()
    out = torch.empty((b, h // 4, w // 4, TC_WIDTHS[2] // 2),
                      dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    rc = _tc_lib().front9_tc(xc.data_ptr(), *[t.data_ptr() for t in ws],
                             out.data_ptr(), b, h, w,
                             torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "front9_chain (bf16)")
    tc_launches.count += 1
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
