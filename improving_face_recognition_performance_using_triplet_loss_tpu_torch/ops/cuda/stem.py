"""Kernel B3 and B4 wrappers: the fused stem and the stem + conv2a prefix
(``csrc/stem.cu``).

``stem_conv_maxout_pool(x, w, bias, maxout=...)`` computes
conv(5x5 SAME, Cin=1) + bias -> mfm2 (maxout 2) or efm3 (maxout 3) ->
2x2/2 max-pool in one pass: x ``[B, H, W, 1]`` (H, W even), w
``[5, 5, 1, C]``, bias ``[C]`` -> ``[B, H/2, W/2, C_out]`` in x's dtype,
f32 accumulation. A CUDA tensor launches the kernel (f32 on the CUDA
cores, counted in ``launches``; bf16 on the tensor cores, counted in
``bf16_launches``); a CPU tensor runs
``stem_conv_maxout_pool_plain``, the space-to-depth formulation of the JAX
package's Pallas kernel (``ops/pallas/stem_kernel.py``): the packed 3x3x4
conv in f32, f32 bias, maxout, then the max over the four phases.

``stem2_conv(x, w, bias, w2, bias2)`` (kernel B4, LightCNN9's conv1..conv2a)
chains that stem (mfm2) with a 1x1 conv + bias + mfm2: w2 ``[1, 1, C/2,
C2]`` or ``[C/2, C2]``, bias2 ``[C2]`` -> ``[B, H/2, W/2, C2/2]``. Its plain
version ``stem2_conv_plain`` is ``reference_stem`` followed by the 1x1 conv
and mfm2, computed in f32 from inputs rounded to x's dtype, with the stem
rounded to x's dtype where the Pallas kernel rounds it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..mfm import mfm2
from ..s2d_stem import pack_stem_weights, reference_stem, space_to_depth2
from ._build import LaunchCount, check, load, require_cuda_or_cpu

launches = LaunchCount("stem")
bf16_launches = LaunchCount("stem_bf16")
stem2_launches = LaunchCount("stem2")


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
    for dtype, name in ((torch.float32, "stem2_conv_f32"),
                        (torch.bfloat16, "stem2_conv_bf16")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns["stem2", dtype] = fn
    lib.stem_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.stem_smem_bytes.restype = ctypes.c_int
    return lib, fns


def _launch(x, w, bias, maxout):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem kernel takes f32 or bf16, got {x.dtype}")
    lib, fns = _fns()
    b, h, wd, _ = x.shape
    c = w.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if lib.stem_smem_bytes(c, maxout, bf16) > 227 * 1024:
        raise ValueError(f"stem kernel: C={c} exceeds its shared memory")
    c_out = c // 2 if maxout == 2 else 2 * (c // 3)
    xc = x.contiguous()
    if xc.data_ptr() % (2 * xc.element_size()):
        xc = xc.clone()   # the kernels stage the image in aligned pairs
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
    (bf16_launches if bf16 else launches).count += 1
    return out


def stem_conv_maxout_pool(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, *,
                          maxout: int = 2) -> torch.Tensor:
    """Fused stem: kernel B3 for a CUDA tensor (f32 on the CUDA cores,
    bf16 on the tensor cores), the plain version for a CPU tensor."""
    _check_args(x, w, bias, maxout)
    if require_cuda_or_cpu(x, "stem"):
        return _launch(x, w, bias, maxout)
    return stem_conv_maxout_pool_plain(x, w, bias, maxout=maxout)


def _check_stem2_args(x, w, bias, w2, bias2):
    _check_args(x, w, bias, 2)
    c = w.shape[3]
    if (w2.shape[-2] != c // 2 or bias2.shape != (w2.shape[-1],)
            or w2.numel() != w2.shape[-2] * w2.shape[-1]):
        raise ValueError(f"expected w2 [1, 1, {c // 2}, C2] and bias2 [C2], "
                         f"got {tuple(w2.shape)} and {tuple(bias2.shape)}")
    if w2.shape[-1] % 2:
        raise ValueError(f"C2={w2.shape[-1]} must be even (mfm2)")


def stem2_conv_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     w2: torch.Tensor, bias2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B4: the stem (mfm2), then the 1x1
    conv + bias + mfm2."""
    _check_stem2_args(x, w, bias, w2, bias2)
    dt = x.dtype
    stem = reference_stem(x.float(), w.to(dt).float(), bias.float(),
                          maxout=2).to(dt).float()
    w2m = w2.reshape(w2.shape[-2], w2.shape[-1]).to(dt).float()
    return mfm2(stem @ w2m + bias2.float()).to(dt)


def _launch_stem2(x, w, bias, w2, bias2):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem2 kernel takes f32 or bf16, got {x.dtype}")
    _, fns = _fns()
    b, h, wd, _ = x.shape
    c, c2 = w.shape[3], w2.shape[-1]
    if (c, c2) != (96, 96):
        raise ValueError(f"stem2 kernel: compiled for LightCNN9's C = C2 = "
                         f"96, got C={c}, C2={c2}")
    xc = x.contiguous()
    if xc.data_ptr() % (2 * xc.element_size()):
        xc = xc.clone()   # the kernel stages the image in aligned pairs
    wk = w.to(x.dtype).float().reshape(25, c).contiguous()
    bk = bias.float().contiguous()
    # [C/2, C2] -> [C/2, C2/2, 2]: the mfm2 pair (j, j + C2/2) side by side
    w2k = w2.to(x.dtype).float().reshape(c // 2, 2, c2 // 2).transpose(
        1, 2).contiguous()
    b2k = bias2.float().contiguous()
    out = torch.empty((b, h // 2, wd // 2, c2 // 2), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    rc = fns["stem2", x.dtype](
        xc.data_ptr(), wk.data_ptr(), bk.data_ptr(), w2k.data_ptr(),
        b2k.data_ptr(), out.data_ptr(), b, h, wd, c, c2,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(rc, "stem2_conv")
    stem2_launches.count += 1
    return out


def stem2_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               w2: torch.Tensor, bias2: torch.Tensor) -> torch.Tensor:
    """Fused stem + 1x1 conv + mfm2: kernel B4 for a CUDA tensor, the plain
    version for a CPU tensor."""
    _check_stem2_args(x, w, bias, w2, bias2)
    if require_cuda_or_cpu(x, "stem2"):
        return _launch_stem2(x, w, bias, w2, bias2)
    return stem2_conv_plain(x, w, bias, w2, bias2)
