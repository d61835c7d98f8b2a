"""Kernel B1 wrapper: fused squared-L2 + semi-hard negative mining
(``csrc/mining.cu``).

``semi_hard_mining(anc, pos_sq, anc_labels, pool, pool_labels)`` returns,
per anchor, the pool index of the closest negative farther than its
positive (``pos_sq`` is the squared anchor-positive distance), or the
farthest negative when there is none, or 0 when the pool holds no
negative. A CUDA tensor launches the kernel (a pre-pass that splits the
rows into TF32 hi / lo halves, the 3xTF32 ``wgmma`` + TMA main kernel and a
merge of the pool ranges), which never writes the ``[B, N]`` distance
matrix; a CPU tensor runs ``semi_hard_mining_plain``,
``pairwise_sq_l2`` followed by ``mine_semi_hard_negative``. The result is
an integer index, so there is no gradient and no backward kernel.

``semi_hard_mining`` is also the ``torch.library`` op
``facejax::semi_hard_mining``, which only a trace takes: an eager call
launches directly.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..distances import pairwise_sq_l2
from ..mining import mine_semi_hard_negative
from ._build import LaunchCount, check, load, require_cuda_or_cpu

launches = LaunchCount("mining")


def semi_hard_mining_plain(anc: torch.Tensor, pos_sq: torch.Tensor,
                           anc_labels: torch.Tensor, pool: torch.Tensor,
                           pool_labels: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the ``[B, N]`` distances, then the
    masked arg-reductions. [B] int32."""
    sq = pairwise_sq_l2(anc.float(), pool.float())
    return mine_semi_hard_negative(sq, pos_sq.float(), anc_labels,
                                   pool_labels)


@functools.cache
def _lib():
    lib = load("mining")
    lib.mining_splits.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.mining_splits.restype = ctypes.c_int
    lib.mining_scratch_words.argtypes = [ctypes.c_int] * 4
    lib.mining_scratch_words.restype = ctypes.c_longlong
    lib.semi_hard_mining.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.semi_hard_mining.restype = ctypes.c_int
    return lib


def _launch(anc, pos_sq, anc_labels, pool, pool_labels) -> torch.Tensor:
    dev = anc.device
    for name, t in (("pos_sq", pos_sq), ("anc_labels", anc_labels),
                    ("pool", pool), ("pool_labels", pool_labels)):
        if t.device != dev:
            raise ValueError(f"semi_hard_mining: {name} is on {t.device}, "
                             f"anc on {dev}")
    b, d = anc.shape
    n = pool.shape[0]
    out = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0:
        return out
    anc = anc.float().contiguous()
    pool = pool.float().contiguous()
    pos_sq = pos_sq.float().contiguous()
    anc_labels = anc_labels.to(torch.int32).contiguous()
    pool_labels = pool_labels.to(torch.int32).contiguous()
    with torch.cuda.device(dev):
        lib = _lib()
        splits = lib.mining_splits(b, n)
        scratch = torch.empty(lib.mining_scratch_words(b, n, d, splits),
                              dtype=torch.float32, device=dev)
        rc = lib.semi_hard_mining(
            anc.data_ptr(), pool.data_ptr(), pos_sq.data_ptr(),
            anc_labels.data_ptr(), pool_labels.data_ptr(), b, n, d, splits,
            scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check(rc, "semi_hard_mining")
    launches.count += 1
    return out


def semi_hard_mining(anc: torch.Tensor, pos_sq: torch.Tensor,
                     anc_labels: torch.Tensor, pool: torch.Tensor,
                     pool_labels: torch.Tensor) -> torch.Tensor:
    """[B] int32 semi-hard negative indices into ``pool``: kernel B1 for
    CUDA tensors, :func:`semi_hard_mining_plain` for CPU tensors.

    ``anc`` [B, D] and ``pool`` [N, D] float32 rows (L2-normalized for
    cosine semantics), ``pos_sq`` [B], integer labels [B] and [N]."""
    if anc.ndim != 2 or pool.ndim != 2 or anc.shape[1] != pool.shape[1]:
        raise ValueError(f"expected anc [B, D] and pool [N, D], got "
                         f"{tuple(anc.shape)} and {tuple(pool.shape)}")
    b, n = anc.shape[0], pool.shape[0]
    if (tuple(pos_sq.shape) != (b,) or tuple(anc_labels.shape) != (b,)
            or tuple(pool_labels.shape) != (n,)):
        raise ValueError("expected pos_sq and anc_labels of shape [B] and "
                         "pool_labels of shape [N]")
    if n == 0 or anc.shape[1] == 0:
        raise ValueError("semi_hard_mining needs a non-empty pool and D > 0")
    if torch.compiler.is_compiling():
        return semi_hard_mining_op(anc, pos_sq, anc_labels, pool, pool_labels)
    if require_cuda_or_cpu(anc, "semi_hard_mining"):
        return _launch(anc, pos_sq, anc_labels, pool, pool_labels)
    return semi_hard_mining_plain(anc, pos_sq, anc_labels, pool, pool_labels)


@torch.library.custom_op("facejax::semi_hard_mining", mutates_args=())
def semi_hard_mining_op(anc: torch.Tensor, pos_sq: torch.Tensor,
                        anc_labels: torch.Tensor, pool: torch.Tensor,
                        pool_labels: torch.Tensor) -> torch.Tensor:
    """``semi_hard_mining`` as an op for a trace (any strides)."""
    if require_cuda_or_cpu(anc, "semi_hard_mining"):
        return _launch(anc, pos_sq, anc_labels, pool, pool_labels)
    return semi_hard_mining_plain(anc, pos_sq, anc_labels, pool,
                                  pool_labels)


@semi_hard_mining_op.register_fake
def _(anc, pos_sq, anc_labels, pool, pool_labels):
    return anc.new_empty((anc.shape[0],), dtype=torch.int32)
