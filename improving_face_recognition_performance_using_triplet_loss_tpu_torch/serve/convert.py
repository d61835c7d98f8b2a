"""Carry weights between the JAX package and the port.

``from_jax_params`` turns what the JAX package holds or writes into the
port's modules: a flax ``EFMNet342``, ``LightCNN9``, ``LightCNN29`` or
``DeepFace`` params tree (or its ``{"params": ..., "batch_stats": ...}`` variables), a JAX
export directory (``weights.npz`` + ``manifest.json``), or an MTCNN
``{layer: {weights, biases, alpha}}`` dict. ``export_model`` writes a port
model back in the export format, with LightCNN29's ``batch_stats``.
``head_from_jax_params`` / ``head_to_jax_params`` carry a ``LinearHead``'s
``{"proj": {"kernel"}}`` tree both ways.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..models import model_by_name
from ..models import mtcnn as nets
from ..models.deepface import deepface_ladder, deepface_side
from ..models.heads import LinearHead
from ..models.lightcnn import square_side
from .export import export_params, load_exported_params

_MTCNN_HEADS = {"conv4-1": nets.PNet, "conv5-1": nets.RNet,
                "conv6-1": nets.ONet}
# a top-level key of each embedding net's tree -> (model, fc1 input
# channels, the side's divisor at fc1)
_NETS = {"stage2_res": ("efmnet342", 174, 32), "conv2a": ("lightcnn9", 128, 16),
         "group1": ("lightcnn29", 174, 32)}
_STEMS = {"efmnet342": "conv1", "lightcnn9": "conv1", "lightcnn29": "group1"}
_DEEPFACE = ("c1", "c3", "l4", "l5", "l6", "f7", "f8")


def from_jax_params(src, *, dtype: torch.dtype = torch.float32, device=None,
                    batch_stats: dict | None = None, input_hw=None):
    """The port module for JAX weights ``src``, in eval mode on ``device``
    (``cuda`` unless given).

    ``src`` is an export directory, a flax ``EFMNet342`` / ``LightCNN9`` /
    ``LightCNN29`` / ``DeepFace`` params tree (or ``{"params": tree, "batch_stats":
    stats}``), or an MTCNN det*.npy-layout dict, as numpy or JAX arrays.
    The net is told apart by its tree's keys. ``dtype`` is the compute
    dtype of an embedding net (MTCNN nets stay float32, as in the JAX
    package). The input size comes from an export's manifest, else from
    ``input_hw``, else from fc1's (DeepFace: f7's) fan-in (a square
    input). DeepFace is told by its ``c1 / c3 / l4 / l5 / l6 / f7 / f8``
    tree, its ladder (the JAX twin's or the paper's, ``deepface_cvpr14``)
    by L4's and L5's output positions, its side by L6's or L4's."""
    if isinstance(src, (str, os.PathLike)):
        params, stats, manifest = load_exported_params(os.fspath(src))
        inp = manifest["input"]
        input_hw = input_hw or (inp["height"], inp["width"])
        src, batch_stats = params, stats or batch_stats
    src = _to_numpy(src)
    if "params" in src:
        batch_stats = src.get("batch_stats", batch_stats)
        src = src["params"]
    for head, cls in _MTCNN_HEADS.items():
        if head in src:
            return nets.build(cls, src, device=device)
    if set(_DEEPFACE) <= set(src):
        side = deepface_side(src)
        return model_by_name(
            deepface_ladder(src), np.asarray(src["f8"]["kernel"]).shape[1],
            input_hw=tuple(input_hw or (side, side)),
            in_channels=np.asarray(src["c1"]["kernel"]).shape[2],
            dtype=dtype, params=src, device=device)
    key = next((k for k in _NETS if k in src), None)
    if key is None:
        raise NotImplementedError(
            f"params tree with top-level keys {sorted(src)}: not a model "
            "the port has (efmnet342, lightcnn9, lightcnn29, deepface, "
            "deepface_cvpr14)")
    name, channels, stride = _NETS[key]
    if input_hw is None:
        side = square_side(src["fc1"]["kernel"], channels, stride)
        input_hw = (side, side)
    stem = src[_STEMS[name]]
    stem_kernel = stem["conv"]["kernel"] if name == "lightcnn29" \
        else stem["kernel"]
    return model_by_name(
        name, np.asarray(src["fc2"]["kernel"]).shape[1],
        input_hw=tuple(input_hw), in_channels=stem_kernel.shape[2],
        dtype=dtype, params=src, batch_stats=batch_stats,
        share_weights="conv_a" in src.get("group2_res", {}), device=device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def export_model(out_dir: str, model: torch.nn.Module,
                 extra: dict | None = None) -> str:
    """Write an embedding net of the port (``EFMNet342``, ``LightCNN9``,
    ``LightCNN29``) as a JAX-loadable export (flax names, HWIO), with
    LightCNN29's BatchNorm statistics under ``batch_stats/`` and
    ``extra`` manifest keys."""
    stats = getattr(model, "flax_batch_stats", None)
    return export_params(out_dir, model.flax_params(),
                         model_name=model.model_name,
                         feature_dim=model.feature_dim,
                         input_hw=model.input_hw,
                         input_channels=model.in_channels,
                         batch_stats=stats() if stats else None,
                         extra=extra)


def head_from_jax_params(params, *, device=None) -> LinearHead:
    """The port's ``LinearHead`` holding a JAX ``LinearHead`` params tree
    ``{"proj": {"kernel": [in, out]}}``, on ``device`` (``cuda`` unless
    given)."""
    params = _to_numpy(params)
    d_in, d_out = np.asarray(params["proj"]["kernel"]).shape
    head = LinearHead(d_in, d_out).load_flax_params(params)
    return head.to(resolve_device(device))


def head_to_jax_params(head: LinearHead) -> dict:
    """The JAX ``LinearHead`` params tree (numpy) of a port head."""
    return head.flax_params()
