"""MTCNN PNet/RNet/ONet as ``nn.Module``s over channel-last tensors.

Port of the JAX package's ``models/mtcnn.py`` (the facenet TF graph:
VALID convs + per-channel PReLU + SAME/VALID max-pools, with softmax face
probability, box regression and, on ONet, 5-point landmark heads). Layers
are keyed by their det1/det2/det3.npy names, so the converted-Caffe dicts
``{layer: {weights, biases | alpha}}`` load with :meth:`MTCNNNet.load_params`
and come back out with :meth:`MTCNNNet.params`.

Inputs and outputs keep the JAX layout, ``[B, H, W, C]``; each conv runs on
the NCHW view of it, which is channels-last in memory. The fc layers
flatten the channel-last map, as the JAX nets do, so their weights need no
permutation.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

PNET_SPEC = [
    ("conv1", "conv", (3, 3, 3, 10)), ("PReLU1", "prelu", 10),
    ("conv2", "conv", (3, 3, 10, 16)), ("PReLU2", "prelu", 16),
    ("conv3", "conv", (3, 3, 16, 32)), ("PReLU3", "prelu", 32),
    ("conv4-1", "conv", (1, 1, 32, 2)), ("conv4-2", "conv", (1, 1, 32, 4)),
]
RNET_SPEC = [
    ("conv1", "conv", (3, 3, 3, 28)), ("prelu1", "prelu", 28),
    ("conv2", "conv", (3, 3, 28, 48)), ("prelu2", "prelu", 48),
    ("conv3", "conv", (2, 2, 48, 64)), ("prelu3", "prelu", 64),
    ("conv4", "fc", (3 * 3 * 64, 128)), ("prelu4", "prelu", 128),
    ("conv5-1", "fc", (128, 2)), ("conv5-2", "fc", (128, 4)),
]
ONET_SPEC = [
    ("conv1", "conv", (3, 3, 3, 32)), ("prelu1", "prelu", 32),
    ("conv2", "conv", (3, 3, 32, 64)), ("prelu2", "prelu", 64),
    ("conv3", "conv", (3, 3, 64, 64)), ("prelu3", "prelu", 64),
    ("conv4", "conv", (2, 2, 64, 128)), ("prelu4", "prelu", 128),
    ("conv5", "fc", (3 * 3 * 128, 256)), ("prelu5", "prelu", 256),
    ("conv6-1", "fc", (256, 2)), ("conv6-2", "fc", (256, 4)),
    ("conv6-3", "fc", (256, 10)),
]


class PReLU(nn.Module):
    """Per-channel PReLU over the last (channel) axis."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.clamp(min=0) + self.alpha * x.clamp(max=0)


def conv_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` on a ``[B, H, W, C]`` tensor, returning ``[B, H', W', C']``.
    The NCHW view of a channel-last tensor is channels-last in memory, so
    the convolution runs there without a copy."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def maxpool_nhwc(x: torch.Tensor, k: int, s: int, padding: str) -> torch.Tensor:
    """``lax.reduce_window`` max-pool with the TF padding rules: SAME pads
    with -inf, the extra row or column going after (a zero-padded
    ``F.max_pool2d`` would let the pad win over negative activations)."""
    xn = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        pads = []
        for n in (x.shape[2], x.shape[1]):          # F.pad order: W, then H
            need = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [need // 2, need - need // 2]
        xn = F.pad(xn, pads, value=float("-inf"))
    return F.max_pool2d(xn, k, s).permute(0, 2, 3, 1)


class MTCNNNet(nn.Module):
    """Layers of one cascade net, built from its spec and keyed by the
    det*.npy layer names."""

    spec: list = []

    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleDict()
        for name, kind, shape in self.spec:
            if kind == "prelu":
                self.layers[name] = PReLU(shape)
            elif kind == "conv":
                kh, kw, cin, cout = shape
                self.layers[name] = nn.Conv2d(cin, cout, (kh, kw))
            else:
                self.layers[name] = nn.Linear(*shape)

    def _conv(self, x, name):
        return conv_nhwc(x, self.layers[name])

    def _fc(self, x, name):
        return self.layers[name](x.reshape(x.shape[0], -1))

    def _act(self, x, name):
        return self.layers[name](x)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MTCNNNet":
        """The JAX package's init: weights ~ N(0, 1/fan_in) drawn in the
        JAX layout, zero biases, PReLU alpha 0.25."""
        params = {}
        for name, kind, shape in self.spec:
            if kind == "prelu":
                params[name] = {"alpha": np.full((shape,), 0.25, np.float32)}
                continue
            fan_in = int(np.prod(shape[:-1]))
            w = torch.randn(shape, generator=generator) / math.sqrt(fan_in)
            params[name] = {"weights": w.numpy(),
                            "biases": np.zeros((shape[-1],), np.float32)}
        return self.load_params(params)

    @torch.no_grad()
    def load_params(self, params: dict) -> "MTCNNNet":
        """Copy a ``{layer: {weights, biases | alpha}}`` dict in (HWIO conv
        kernels, ``[in, out]`` fc weights, as numpy or tensors)."""
        for name, kind, _ in self.spec:
            entry = {k: torch.as_tensor(np.asarray(v, np.float32))
                     for k, v in params[name].items()}
            layer = self.layers[name]
            if kind == "prelu":
                layer.alpha.copy_(entry["alpha"].reshape(-1))
                continue
            w = entry["weights"]
            w = w.permute(3, 2, 0, 1) if kind == "conv" else w.T
            layer.weight.copy_(w)
            layer.bias.copy_(entry["biases"].reshape(-1))
        return self

    def params(self) -> dict[str, dict[str, np.ndarray]]:
        """The det*.npy-layout dict of this net (float32 numpy)."""
        out = {}
        for name, kind, _ in self.spec:
            layer = self.layers[name]
            if kind == "prelu":
                out[name] = {"alpha": _np(layer.alpha)}
                continue
            w = layer.weight.permute(2, 3, 1, 0) if kind == "conv" \
                else layer.weight.T
            out[name] = {"weights": _np(w), "biases": _np(layer.bias)}
        return out


def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


class PNet(MTCNNNet):
    """``[B, H, W, 3] -> (prob [B, H', W', 2], reg [B, H', W', 4])``."""

    spec = PNET_SPEC

    def forward(self, x):
        x = self._act(self._conv(x, "conv1"), "PReLU1")
        x = maxpool_nhwc(x, 2, 2, "SAME")
        x = self._act(self._conv(x, "conv2"), "PReLU2")
        x = self._act(self._conv(x, "conv3"), "PReLU3")
        prob = torch.softmax(self._conv(x, "conv4-1"), dim=-1)
        reg = self._conv(x, "conv4-2")
        return prob, reg


class RNet(MTCNNNet):
    """``[B, 24, 24, 3] -> (prob [B, 2], reg [B, 4])``."""

    spec = RNET_SPEC

    def forward(self, x):
        x = self._act(self._conv(x, "conv1"), "prelu1")
        x = maxpool_nhwc(x, 3, 2, "SAME")
        x = self._act(self._conv(x, "conv2"), "prelu2")
        x = maxpool_nhwc(x, 3, 2, "VALID")
        x = self._act(self._conv(x, "conv3"), "prelu3")
        x = self._act(self._fc(x, "conv4"), "prelu4")
        prob = torch.softmax(self._fc(x, "conv5-1"), dim=-1)
        reg = self._fc(x, "conv5-2")
        return prob, reg


class ONet(MTCNNNet):
    """``[B, 48, 48, 3] -> (prob [B, 2], reg [B, 4], landmarks [B, 10])``."""

    spec = ONET_SPEC

    def forward(self, x):
        x = self._act(self._conv(x, "conv1"), "prelu1")
        x = maxpool_nhwc(x, 3, 2, "SAME")
        x = self._act(self._conv(x, "conv2"), "prelu2")
        x = maxpool_nhwc(x, 3, 2, "VALID")
        x = self._act(self._conv(x, "conv3"), "prelu3")
        x = maxpool_nhwc(x, 2, 2, "SAME")
        x = self._act(self._conv(x, "conv4"), "prelu4")
        x = self._act(self._fc(x, "conv5"), "prelu5")
        prob = torch.softmax(self._fc(x, "conv6-1"), dim=-1)
        reg = self._fc(x, "conv6-2")
        landmarks = self._fc(x, "conv6-3")
        return prob, reg, landmarks


def build(cls, params: dict | None = None, *,
          generator: torch.Generator | None = None, device=None) -> MTCNNNet:
    """A ready ``cls`` net in eval mode on ``device`` (``cuda`` unless
    given): ``params`` loaded when passed, else random init drawn from
    ``generator`` on the CPU (so a seed gives the same weights on every
    device)."""
    dev = resolve_device(device)
    net = cls()
    if params is not None:
        net.load_params(params)
    else:
        net.init_weights(generator or torch.Generator().manual_seed(0))
    return net.to(dev).eval()


def load_npy_params(path_or_dict: Any) -> dict[str, dict[str, np.ndarray]]:
    """Load a det{1,2,3}.npy weights dict (facenet layout:
    ``{layer: {param_name: array}}``) as float32 numpy arrays."""
    if isinstance(path_or_dict, (str, bytes)):
        data = np.load(path_or_dict, encoding="latin1",
                       allow_pickle=True).item()
    else:
        data = path_or_dict
    return {layer: {k: np.asarray(v, np.float32) for k, v in entries.items()}
            for layer, entries in data.items()}
