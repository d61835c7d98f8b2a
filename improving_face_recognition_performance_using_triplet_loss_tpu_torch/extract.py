"""Batch feature extraction (reference extract_feacture_v2.py:43-109).

Port of the JAX package's ``extract.py`` (``make_extract_fn`` and
``extract_features``): every batch goes through the embedding net in eval
mode without autograd, its features are L2-normalized and its top-1 ID
predictions taken on the device, and the host only concatenates the
results. uint8 batches (the streaming stores) are normalized on the device,
as ``x * float32(1/255)``, the form the JAX package's jitted ``x / 255.0``
takes under XLA. Sharded extraction (``data_parallel``) and int8 convs are
not ported yet (ROADMAP.md queue A, items 10 and 13).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.distances import l2_normalize

# XLA turns the jitted division by 255 into a product with this float32
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _check_modes(data_parallel: bool, int8: bool) -> None:
    if data_parallel:
        raise NotImplementedError("data-parallel extraction is not ported; "
                                  "queued in ROADMAP.md queue A, item 10")
    if int8:
        raise NotImplementedError("int8 extraction is not ported; queued in "
                                  "ROADMAP.md queue A, item 13")


def make_extract_fn(model: torch.nn.Module, *, normalize: bool = True,
                    int8: bool = False):
    """``fn(images) -> (logits, features)`` for a batch on the model's
    device: uint8 images scaled to [0, 1], features L2-normalized unless
    ``normalize=False``."""
    _check_modes(False, int8)
    model.eval()

    @torch.no_grad()
    def fn(images: torch.Tensor):
        if images.dtype == torch.uint8:
            images = images.float() * _INV_255
        logits, feat = model(images)
        if normalize:
            feat = l2_normalize(feat)
        return logits, feat

    return fn


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
    materialized in host memory."""
    _check_modes(data_parallel, int8)
    fn = make_extract_fn(model, normalize=normalize)
    device = next(model.parameters()).device
    n = images.shape[0]
    feats_out, preds_out = [], []
    correct = counted = 0
    for start in range(0, n, batch_size):
        # a copy: memmap rows are read here anyway, and torch wants them
        # writable
        chunk = np.array(images[start:start + batch_size])
        rows = chunk.shape[0]
        if rows < batch_size:
            chunk = np.concatenate(
                [chunk, np.zeros((batch_size - rows,) + chunk.shape[1:],
                                 chunk.dtype)], 0)
        logits, feat = fn(torch.from_numpy(chunk).to(device))
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
