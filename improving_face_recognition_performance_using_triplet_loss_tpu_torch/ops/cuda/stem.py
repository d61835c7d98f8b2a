"""Kernel B3 wrapper: the fused stem (``csrc/stem.cu``).

``stem_conv_maxout_pool(x, w, bias, maxout=...)`` computes
conv(5x5 SAME, Cin=1) + bias -> mfm2 (maxout 2) or efm3 (maxout 3) ->
2x2/2 max-pool in one pass: x ``[B, H, W, 1]`` (H, W even), w
``[5, 5, 1, C]``, bias ``[C]`` -> ``[B, H/2, W/2, C_out]`` in x's dtype,
f32 accumulation. A CUDA tensor launches the kernel; a CPU tensor runs
``stem_conv_maxout_pool_plain``, the space-to-depth formulation of the JAX
package's Pallas kernel (``ops/pallas/stem_kernel.py``): the packed 3x3x4
conv in f32, f32 bias, maxout, then the max over the four phases.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..s2d_stem import pack_stem_weights, space_to_depth2
from ._build import LaunchCount, check, load, require_cuda_or_cpu

launches = LaunchCount("stem")


def _check_args(x, w, bias, maxout):
    if maxout not in (2, 3):
        raise ValueError(f"maxout must be 2 or 3, got {maxout}")
    if x.ndim != 4 or x.shape[3] != 1:
        raise ValueError(f"expected x [B, H, W, 1], got {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"H and W must be even, got {tuple(x.shape[1:3])}")
    if tuple(w.shape[:3]) != (5, 5, 1) or bias.shape != (w.shape[3],):
        raise ValueError(f"expected w [5, 5, 1, C] and bias [C], got "
                         f"{tuple(w.shape)} and {tuple(bias.shape)}")
    if w.shape[3] % maxout:
        raise ValueError(f"C={w.shape[3]} must divide by maxout={maxout}")


def stem_conv_maxout_pool_plain(x: torch.Tensor, w: torch.Tensor,
                                bias: torch.Tensor, *,
                                maxout: int = 2) -> torch.Tensor:
    """Plain PyTorch version of the kernel (space-to-depth form)."""
    _check_args(x, w, bias, maxout)
    c = w.shape[3]
    xp = space_to_depth2(x.float()).permute(0, 3, 1, 2)          # [B, 4, h, w]
    wp = pack_stem_weights(w.to(x.dtype).float())                  # [3,3,4,4C]
    y = F.conv2d(xp, wp.permute(3, 2, 0, 1), padding=1)           # [B, 4C, h, w]
    y = y + bias.float().repeat(4)[None, :, None, None]
    y = y.reshape(y.shape[0], 4, maxout, c // maxout, *y.shape[2:])
    mx = y.amax(dim=(1, 2))
    if maxout == 2:
        out = mx
    else:
        # per-phase min over the thirds first, THEN the max over phases
        mn = y.amin(dim=2).amax(dim=1)
        out = torch.cat([mx, mn], dim=1)
    return out.permute(0, 2, 3, 1).to(x.dtype)


@functools.cache
def _fns():
    lib = load("stem")
    fns = {}
    for dtype, name in ((torch.float32, "stem_conv_maxout_pool_f32"),
                        (torch.bfloat16, "stem_conv_maxout_pool_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[dtype] = fn
    lib.stem_smem_bytes.argtypes = [ctypes.c_int]
    lib.stem_smem_bytes.restype = ctypes.c_int
    return lib, fns


def _launch(x, w, bias, maxout):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem kernel takes f32 or bf16, got {x.dtype}")
    lib, fns = _fns()
    b, h, wd, _ = x.shape
    c = w.shape[3]
    if lib.stem_smem_bytes(c) > 227 * 1024:
        raise ValueError(f"stem kernel: C={c} exceeds its shared memory")
    c_out = c // 2 if maxout == 2 else 2 * (c // 3)
    xc = x.contiguous()
    # taps rounded to x's dtype (as the Pallas kernel feeds them), held f32
    wk = w.to(x.dtype).float().reshape(25, c).contiguous()
    bk = bias.float().contiguous()
    out = torch.empty((b, h // 2, wd // 2, c_out), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    rc = fns[x.dtype](xc.data_ptr(), wk.data_ptr(), bk.data_ptr(),
                      out.data_ptr(), b, h, wd, c, maxout,
                      torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "stem_conv_maxout_pool")
    launches.count += 1
    return out


def stem_conv_maxout_pool(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, *,
                          maxout: int = 2) -> torch.Tensor:
    """Fused stem: kernel B3 for a CUDA tensor, the plain version for a
    CPU tensor."""
    _check_args(x, w, bias, maxout)
    if require_cuda_or_cpu(x, "stem"):
        return _launch(x, w, bias, maxout)
    return stem_conv_maxout_pool_plain(x, w, bias, maxout=maxout)
