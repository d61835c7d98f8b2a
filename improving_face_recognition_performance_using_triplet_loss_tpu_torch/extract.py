"""Batch feature extraction (reference extract_feacture_v2.py:43-109).

Port of the JAX package's ``extract.py`` (``make_extract_fn`` and
``extract_features``): every batch goes through the embedding net in eval
mode without autograd, its features are L2-normalized and its top-1 ID
predictions taken on the device, and the host only concatenates the
results. uint8 batches (the streaming stores) are normalized on the device,
as ``x * float32(1/255)``, the form the JAX package's jitted ``x / 255.0``
takes under XLA. ``int8=True`` runs every eligible conv on the exact int8
route of ``ops/quantized.py`` (one activation scale over the whole batch,
as the JAX package's jitted batch computes it). Sharded extraction
(``make_sharded_extract_fn``, ``data_parallel=True``) gives each rank its
block of every batch, which it embeds on the kernels its route takes, and
gathers the rows in rank order; the int8 route's activation scale is then
the whole batch's (a MAX over the ranks).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .models.mtcnn import conv_route
from .ops.distances import l2_normalize
from .ops.quantized import Int8ConvRoute
from .parallel.collectives import gather_rows
from .parallel.mesh import (DATA_AXIS, axis_group, axis_size, local_block,
                            make_mesh)
from .utils.profiling import span

# XLA turns the jitted division by 255 into a product with this float32
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _scaled(images: torch.Tensor) -> torch.Tensor:
    """uint8 images as float32 in [0, 1] (``x * float32(1/255)``); others
    as they are."""
    if images.dtype == torch.uint8:
        return images.float() * _INV_255
    return images


def make_extract_fn(model: torch.nn.Module, *, normalize: bool = True,
                    int8: bool = False, process_group=None):
    """``fn(images) -> (logits, features)`` for a batch on the model's
    device: uint8 images scaled to [0, 1], features L2-normalized unless
    ``normalize=False``; ``int8`` runs the forward on the int8 conv route
    (``ops.quantized.Int8ConvRoute``, kept across batches, its activation
    scales over ``process_group``'s ranks when given)."""
    model.eval()
    route = Int8ConvRoute(process_group=process_group) if int8 else None

    @torch.no_grad()
    def fn(images: torch.Tensor):
        images = _scaled(images)
        with (conv_route(route) if int8 else contextlib.nullcontext()):
            logits, feat = model(images)
        if normalize:
            feat = l2_normalize(feat)
        return logits, feat

    return fn


def make_sharded_extract_fn(model: torch.nn.Module, *,
                            normalize: bool = True, mesh=None,
                            int8: bool = False):
    """Batch-axis extraction over every rank of ``mesh`` (a 1-D data mesh
    over the world by default): ``fn(images [N, ...]) -> (logits,
    features)`` whole on every rank, each rank embedding its block of the
    N rows (N must divide over the ranks)."""
    mesh = mesh if mesh is not None else make_mesh(
        device=next(model.parameters()).device)
    group = axis_group(mesh, DATA_AXIS)
    fn = make_extract_fn(model, normalize=normalize, int8=int8,
                         process_group=group if int8 else None)

    def sharded(images: torch.Tensor):
        logits, feat = fn(local_block(images, mesh, DATA_AXIS))
        return gather_rows(logits, group), gather_rows(feat, group)

    return sharded


def extract_features(
    model: torch.nn.Module,
    images: np.ndarray,
    labels: np.ndarray | None = None,
    *,
    batch_size: int = 256,
    normalize: bool = True,
    data_parallel: bool = False,
    int8: bool = False,
):
    """Extract embeddings for all rows; returns ``(features, labels,
    accuracy, predictions)``: the JAX function's triple, then the top-1
    predictions.

    Pads the final partial batch with zero images (the reference drops it)
    so every input row gets an embedding, and drops the pad rows' results.
    ``accuracy`` is top-1 ID accuracy when labels are given (NaN without).
    ``images`` may be a uint8 memmap (the mmap store): rows are sliced per
    batch and normalized on the device, so the float dataset is never
    materialized in host memory. ``data_parallel`` shards every batch
    over the ranks (:func:`make_sharded_extract_fn`; ``batch_size`` must
    divide over them); every rank returns the whole result."""
    device = next(model.parameters()).device
    if data_parallel:
        mesh = make_mesh(device=device)
        ranks = axis_size(mesh, DATA_AXIS)
        if batch_size % ranks:
            raise ValueError(
                f"--data-parallel needs batch_size ({batch_size}) "
                f"divisible by the device count ({ranks})")
        fn = make_sharded_extract_fn(model, normalize=normalize, mesh=mesh,
                                     int8=int8)
    else:
        fn = make_extract_fn(model, normalize=normalize, int8=int8)
    n = images.shape[0]
    feats_out, preds_out = [], []
    correct = counted = 0
    for start in range(0, n, batch_size):
        with span("extract.slice"):
            # a copy: memmap rows are read here anyway, and torch wants
            # them writable
            chunk = np.array(images[start:start + batch_size])
            rows = chunk.shape[0]
            if rows < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - rows,) + chunk.shape[1:],
                                     chunk.dtype)], 0)
        with span("extract.upload"):
            batch = _scaled(torch.from_numpy(chunk).to(device))
        with span("extract.forward"):
            logits, feat = fn(batch)
        with span("extract.readback"):
            feats_out.append(feat[:rows].cpu().numpy())
            pred = torch.argmax(logits[:rows], dim=-1).cpu().numpy()
            preds_out.append(pred)
            if labels is not None:
                lab = np.asarray(labels[start:start + batch_size])
                correct += int((pred == lab).sum())
                counted += lab.shape[0]
    features = np.concatenate(feats_out, 0)
    acc = correct / counted if counted else float("nan")
    return (features, None if labels is None else np.asarray(labels), acc,
            np.concatenate(preds_out, 0))
