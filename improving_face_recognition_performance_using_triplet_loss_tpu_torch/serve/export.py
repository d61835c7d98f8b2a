"""Weight export: flat ``weights.npz`` + ``manifest.json``.

Port of the JAX package's ``serve/export.py`` format, read and written with
numpy alone: keys are the flax tree paths joined by ``/`` under
``params/`` (and ``batch_stats/``), kernels in HWIO / ``[in, out]``, float32
C-order, and the manifest names the model, feature dim and input contract.
An export of either package loads in the other (``serve.convert``).
``export_mtcnn`` writes the detector's three nets as the flat npz that
the native cascade under ``cpp/`` reads, ``export_ert`` an ERT shape
predictor as the flat npz of the native regressor (``serve.native
.NativeErt``).
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


def export_mtcnn(path: str, pnet_params: Any, rnet_params: Any,
                 onet_params: Any) -> str:
    """Write the three MTCNN nets to one flat .npz the native cascade reads.

    The reference's C++ runtime loads PNet/RNet/ONet as MXNet symbol+params
    (MTCNN.hpp:60-79); this npz is consumed by
    cpp/include/facejax/mtcnn.hpp. Keys: ``{pnet|rnet|onet}/{layer}/{param}``
    with the det*.npy layer names (``models/mtcnn.py`` specs); float32
    C-order. The params are det*.npy-layout dicts (``MTCNNNet.params()``).
    """
    flat: dict[str, np.ndarray] = {}
    for net, params in (("pnet", pnet_params), ("rnet", rnet_params),
                        ("onet", onet_params)):
        for layer, entries in params.items():
            for name, arr in entries.items():
                flat[f"{net}/{layer}/{name}"] = np.ascontiguousarray(
                    np.asarray(arr, np.float32))
    if not path.endswith(".npz"):
        path += ".npz"  # np.savez appends it anyway; return the real path
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat)
    return path


def export_ert(path: str, predictor: Any) -> str:
    """Write an ERT shape predictor (detect/ert.py::ShapePredictor) to the
    flat .npz the native regressor reads (cpp/include/facejax/ert.hpp).

    Same arrays as ShapePredictor.save but uncompressed (the native reader
    is ZIP_STORED-only) and all-float32 (indices are small integers, exactly
    representable). Reference parity: the dlib shape_predictor .dat the C++
    runtime deserializes (MTCNN.hpp:1326-1421).
    """
    flat: dict[str, np.ndarray] = {
        "mean_shape": np.asarray(predictor.mean_shape, np.float32),
        "num_levels": np.asarray([len(predictor.levels)], np.float32),
    }
    for t, lv in enumerate(predictor.levels):
        for name in ("anchors", "deltas", "split_idx1", "split_idx2",
                     "split_thresh", "leaf_values"):
            flat[f"level{t}/{name}"] = np.ascontiguousarray(
                np.asarray(getattr(lv, name), np.float32))
    if not path.endswith(".npz"):
        path += ".npz"  # np.savez appends it anyway; return the real path
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat)
    return path
