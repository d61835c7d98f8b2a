"""Weight export: flat ``weights.npz`` + ``manifest.json``.

Port of the JAX package's ``serve/export.py`` format, read and written with
numpy alone: keys are the flax tree paths joined by ``/`` under
``params/`` (and ``batch_stats/``), kernels in HWIO / ``[in, out]``, float32
C-order, and the manifest names the model, feature dim and input contract.
An export of either package loads in the other (``serve.convert``).
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    else:
        flat[prefix.rstrip("/")] = np.ascontiguousarray(np.asarray(tree))
    return flat


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def export_params(out_dir: str, params: Any, *, model_name: str,
                  feature_dim: int, input_hw: tuple[int, int],
                  input_channels: int = 1, batch_stats: Any = None,
                  extra: dict | None = None) -> str:
    """Write ``weights.npz`` + ``manifest.json`` of a flax-layout params
    tree (nested dicts of arrays) under ``out_dir``, with ``batch_stats``
    (BatchNorm running statistics, flax layout) under ``batch_stats/``;
    ``extra`` adds manifest keys (``{"precision": "bf16"}``)."""
    os.makedirs(out_dir, exist_ok=True)
    flat = _flatten(params, "params/")
    if batch_stats:
        flat.update(_flatten(batch_stats, "batch_stats/"))
    np.savez(os.path.join(out_dir, "weights.npz"), **flat)
    manifest = {
        "format_version": 1,
        "model": model_name,
        "feature_dim": int(feature_dim),
        "input": {"height": input_hw[0], "width": input_hw[1],
                  "channels": input_channels, "scale": "1/255",
                  "layout": "NHWC"},
        "embedding_normalization": "l2",
        "tensors": sorted(flat.keys()),
    }
    if extra:
        manifest.update(extra)
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return out_dir


def load_exported_params(out_dir: str):
    """Returns ``(params_tree, batch_stats_tree_or_empty, manifest)``."""
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(out_dir, "weights.npz")) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    return tree.get("params", {}), tree.get("batch_stats", {}), manifest
