"""Carry weights between the JAX package and the port.

``from_jax_params`` turns what the JAX package holds or writes into the
port's modules: a flax ``EFMNet342`` params tree (or its ``{"params": ...}``
variables), a JAX export directory (``weights.npz`` + ``manifest.json``),
or an MTCNN ``{layer: {weights, biases, alpha}}`` dict. ``export_model``
writes a port model back in the export format. ``head_from_jax_params`` /
``head_to_jax_params`` carry a ``LinearHead``'s ``{"proj": {"kernel"}}``
tree both ways.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..models import mtcnn as nets
from ..models.efm_symbol import EFMNet342, build_efmnet342, fc1_side
from ..models.heads import LinearHead
from .export import export_params, load_exported_params

_ROADMAP_MODELS = ("only efmnet342 is ported; lightcnn29 and lightcnn9 are "
                   "queued in ROADMAP.md (queue A, 'LightCNN29 / LightCNN9')")

_MTCNN_HEADS = {"conv4-1": nets.PNet, "conv5-1": nets.RNet,
                "conv6-1": nets.ONet}


def from_jax_params(src, *, dtype: torch.dtype = torch.float32,
                    device=None) -> torch.nn.Module:
    """The port module for JAX weights ``src``, in eval mode on ``device``
    (``cuda`` unless given).

    ``src`` is an export directory, a flax ``EFMNet342`` params tree (or
    ``{"params": tree}``), or an MTCNN det*.npy-layout dict, as numpy or
    JAX arrays. ``dtype`` is the compute dtype of an EFMNet342 (MTCNN nets
    stay float32, as in the JAX package)."""
    if isinstance(src, (str, os.PathLike)):
        params, _, manifest = load_exported_params(os.fspath(src))
        if manifest.get("model", "efmnet342") != "efmnet342":
            raise NotImplementedError(
                f"export of {manifest['model']!r}: {_ROADMAP_MODELS}")
        src = params
    src = _to_numpy(src)
    if "params" in src and "conv1" not in src:
        src = src["params"]
    for head, cls in _MTCNN_HEADS.items():
        if head in src:
            return nets.build(cls, src, device=device)
    if "stage2_res" not in src:
        raise NotImplementedError(
            f"params tree with top-level keys {sorted(src)}: "
            f"{_ROADMAP_MODELS}")
    num_classes = np.asarray(src["fc2"]["kernel"]).shape[1]
    return build_efmnet342(num_classes, image_size=fc1_side(src), params=src,
                           dtype=dtype, device=device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree, np.float32)


def export_model(out_dir: str, model: EFMNet342) -> str:
    """Write ``model`` as a JAX-loadable export (flax names, HWIO)."""
    size = model.image_size
    return export_params(out_dir, model.flax_params(), model_name="efmnet342",
                         feature_dim=model.feature_dim,
                         input_hw=(size, size))


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
