"""Kernel B5 wrapper: exact greedy NMS keep masks (``csrc/nms.cu``).

``nms_mask_batched`` takes ``[S, N, 5]`` box sets (``[x1, y1, x2, y2,
score]`` rows; invalid rows carry a score of -inf) and returns the
``[S, N]`` keep mask in the original row order. A CUDA tensor launches the
kernel, all S sets in one launch, which sorts, builds the suppression
bitmask and sweeps it itself; a CPU tensor runs ``nms_mask_plain``, the
port of the JAX package's ``ops/boxes.py::nms_mask_jax``, which sorts the
way the JAX package does: descending score, ties broken by the highest
original row (a stable ascending sort of the negated reversed scores,
mapped back).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ._build import LaunchCount, check, load, require_cuda_or_cpu

launches = LaunchCount("nms")

# rows per block of nms_mask_plain's fixed point; the mask does not depend
# on it
_BLOCK = 32


def _score_order(scores: torch.Tensor) -> torch.Tensor:
    """[S, N] -> [S, N] original rows by descending score, ties to the
    highest row."""
    n = scores.shape[-1]
    return n - 1 - torch.sort(-scores.flip(-1), dim=-1, stable=True).indices


def nms_mask_plain(boxes: torch.Tensor, threshold: float,
                   method: str = "Union") -> torch.Tensor:
    """Plain PyTorch greedy NMS, ``[..., N, 5] -> [..., N]`` bool.

    The block Gauss-Seidel fixed point of ``nms_mask_jax``, batched over
    the leading axes: in score order, box j survives iff no surviving
    higher-scored box overlaps it above ``threshold``. Each block applies
    the final decisions of earlier blocks in one reduction, then resolves
    its own [B, B] sub-problem with a fixed point that is final after at
    most B passes."""
    lead, n = boxes.shape[:-2], boxes.shape[-2]
    if boxes.numel() == 0:
        return torch.zeros((*lead, n), dtype=torch.bool, device=boxes.device)
    b = boxes.reshape(-1, n, 5).float()
    sets = b.shape[0]
    order = _score_order(b[..., 4])
    b = torch.gather(b, 1, order[..., None].expand(sets, n, 5))
    bsz = max(1, min(_BLOCK, n))
    nb = -(-n // bsz)
    pad = nb * bsz - n
    x1, y1, x2, y2 = (F.pad(b[..., i], (0, pad)) for i in range(4))
    sc = F.pad(b[..., 4], (0, pad), value=float("-inf"))
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    zero = torch.zeros((), dtype=torch.float32, device=b.device)
    xx1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    yy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    xx2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    yy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = (torch.maximum(zero, xx2 - xx1 + 1)
             * torch.maximum(zero, yy2 - yy1 + 1))
    if method == "Min":
        o = inter / torch.minimum(area[:, :, None], area[:, None, :])
    else:
        o = inter / (area[:, :, None] + area[:, None, :] - inter)
    idx = torch.arange(nb * bsz, device=b.device)
    th = torch.tensor(threshold, dtype=torch.float32, device=b.device)
    # suppr[s, i, j]: sorted row i, ranked before j, suppresses j
    suppr = (o > th) & (idx[:, None] < idx[None, :]) & torch.isfinite(o)
    valid = torch.isfinite(sc)
    keep = torch.zeros_like(valid)
    for t in range(nb):
        blk = slice(t * bsz, (t + 1) * bsz)
        cols = suppr[:, :, blk]
        # earlier blocks' decisions in `keep` are final; this and later
        # blocks are still False there
        pre = (cols & keep[:, :, None]).any(1)
        sub = cols[:, blk, :]
        vblk = valid[:, blk] & ~pre
        prev, kb = vblk, vblk & ~(sub & vblk[:, :, None]).any(1)
        passes = 1
        while passes < bsz and bool((kb != prev).any()):
            prev, kb = kb, vblk & ~(sub & kb[:, :, None]).any(1)
            passes += 1
        keep[:, blk] = kb
    mask = torch.zeros((sets, n), dtype=torch.bool, device=b.device)
    mask.scatter_(1, order, keep[:, :n])
    return mask.reshape(*lead, n)


@functools.cache
def _lib():
    lib = load("nms")
    for fn in (lib.nms_smem_bytes, lib.nms_global_mode):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    lib.nms_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nms_scratch_bytes.restype = ctypes.c_longlong
    lib.nms_keep_mask.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.nms_keep_mask.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def cluster_size(sets: int, n: int, sms: int) -> int:
    """CTAs per set: doubled up to 4 while the call still fits the SMs and
    each CTA keeps at least 128 rows of the mask to build (the
    cross-scale call, 16 sets of 1,024 rows, takes 4; the others 1).
    Clusters of 8 measured slower: not all of them fit the GPCs at once."""
    c = 1
    while c < 4 and sets * c * 2 <= sms and n >= 256 * c:
        c *= 2
    return c


@functools.cache
def _plan(sets: int, n: int, index: int) -> tuple[int, int]:
    """(global scratch bytes, CTAs per set) of a call shape; raises where
    the kernel's shared memory cannot hold n rows."""
    lib = _lib()
    smem = lib.nms_smem_bytes(n)
    if smem > 227 * 1024:
        raise ValueError(f"nms: {n} boxes per set exceed the kernel's "
                         f"shared memory ({smem} bytes)")
    return (lib.nms_scratch_bytes(sets, n),
            cluster_size(sets, n, _sm_count(index)))


def _launch(boxes: torch.Tensor, threshold: float,
            method: str) -> torch.Tensor:
    sets, n, _ = boxes.shape
    keep = torch.empty((sets, n), dtype=torch.bool, device=boxes.device)
    if sets == 0 or n == 0:
        return keep
    lib = _lib()
    scratch_bytes, cluster = _plan(sets, n, boxes.device.index or 0)
    boxes = boxes.float().contiguous()
    scratch = (torch.empty(scratch_bytes, dtype=torch.uint8,
                           device=boxes.device) if scratch_bytes else None)
    rc = lib.nms_keep_mask(
        boxes.data_ptr(), keep.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, sets, n,
        threshold, int(method == "Min"), cluster,
        torch.cuda.current_stream(boxes.device).cuda_stream)
    check(rc, "nms_keep_mask")
    launches.count += 1
    return keep


def nms_mask_batched(boxes: torch.Tensor, threshold: float,
                     method: str = "Union") -> torch.Tensor:
    """``[S, N, 5] -> [S, N]`` keep masks: kernel B5 for a CUDA tensor (one
    launch for all S sets), :func:`nms_mask_plain` for a CPU tensor."""
    if method not in ("Union", "Min"):
        raise ValueError(f"method must be 'Union' or 'Min', got {method!r}")
    if boxes.ndim != 3 or boxes.shape[-1] != 5:
        raise ValueError(f"expected [S, N, 5] boxes, got {tuple(boxes.shape)}")
    if require_cuda_or_cpu(boxes, "nms"):
        return _launch(boxes, threshold, method)
    return nms_mask_plain(boxes, threshold, method)
