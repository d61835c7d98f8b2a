"""DeepFace embedding network (Taigman et al., CVPR 2014).

Port of the JAX package's ``models/deepface.py``: C1 11x11x32 conv ->
3x3/2 max-pool -> C3 9x9x16 conv -> three locally connected layers (L4
9x9x16, L5 7x7x16, L6 5x5x16) -> F7, the 4096-d embedding, fully
connected -> F8 softmax, over channel-last ``[B, H, W, C]`` input
(canonical 152x152x3; 65x65 at least).

A locally connected layer has a weight per output position: here
``F.unfold`` gathers each position's patch (channel outermost, then the
kernel's rows and columns: the feature order of JAX's
``conv_general_dilated_patches``, so the flax ``[OH, OW, C*KH*KW, F]``
kernel loads as it is) and one batched product over the positions
contracts it. No Pallas kernel computes it in the JAX package, and none
does here. F7 takes the channel-last flatten, as the flax net does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .lightcnn import (Dropout, FlaxLayers, finish_build, flax_entry,
                       init_conv_, lecun_normal_, load_kernel_)
from .mtcnn import conv_nhwc

# (name, kernel) of the locally connected layers
LC_LAYERS = (("l4", 9), ("l5", 7), ("l6", 5))


class LocallyConnected2D(nn.Module):
    """A conv with untied (per-position) weights; VALID, stride 1.
    ``kernel`` [OH, OW, C*K*K, F] and ``bias`` [OH, OW, F] in the flax
    layout."""

    def __init__(self, in_hw, channels: int, features: int, kernel: int):
        super().__init__()
        self.k = kernel
        oh, ow = in_hw[0] - kernel + 1, in_hw[1] - kernel + 1
        self.kernel = nn.Parameter(
            torch.zeros(oh, ow, channels * kernel * kernel, features))
        self.bias = nn.Parameter(torch.zeros(oh, ow, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        oh, ow, p, f = self.kernel.shape
        patches = F.unfold(x.permute(0, 3, 1, 2), self.k)    # [B, P, L]
        out = torch.bmm(patches.permute(2, 0, 1),            # [L, B, P]
                        self.kernel.reshape(oh * ow, p, f))  # [L, B, F]
        return out.permute(1, 0, 2).reshape(b, oh, ow, f) + self.bias

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's lecun_normal over the whole kernel (fan-in OH*OW*P, as
        flax counts it for this shape), zero bias."""
        oh, ow, p, _ = self.kernel.shape
        self.kernel.copy_(lecun_normal_(torch.empty(self.kernel.shape),
                                        oh * ow * p, generator))
        self.bias.zero_()

    @torch.no_grad()
    def load_flax(self, entry: dict) -> None:
        self.kernel.copy_(torch.as_tensor(np.asarray(entry["kernel"],
                                                     np.float32)))
        self.bias.copy_(torch.as_tensor(np.asarray(entry["bias"],
                                                   np.float32)))

    def flax_entry(self) -> dict:
        return {k: np.ascontiguousarray(t.detach().float().cpu().numpy())
                for k, t in (("kernel", self.kernel), ("bias", self.bias))}


def deepface_sizes(input_hw) -> list[tuple[int, int]]:
    """The (H, W) entering C3, L4, L5, L6 and leaving L6."""
    h, w = (s - 10 for s in input_hw)                 # C1, VALID 11x11
    h, w = (h - 3) // 2 + 1, (w - 3) // 2 + 1         # M2, 3x3/2 VALID
    sizes = [(h, w)]
    for k in (9, 9, 7, 5):                            # C3, L4, L5, L6
        h, w = h - k + 1, w - k + 1
        sizes.append((h, w))
    return sizes


def deepface_side(params: dict) -> int:
    """The even square input side a flax DeepFace tree was built for, from
    L6's output positions (sides 2k + 11 and 2k + 12 give the same
    ladder; 152, the canonical side, is the even one)."""
    o6 = np.asarray(params["l6"]["kernel"]).shape[0]
    return 2 * (o6 + 26) + 12


class DeepFace(FlaxLayers):
    """DeepFace: ``[B, H, W, C] -> (logits, 4096-d F7 embedding)``."""

    model_name = "deepface"

    def __init__(self, num_classes: int, input_hw=(152, 152),
                 in_channels: int = 3, feature_dim: int = 4096,
                 lc_features: int = 16):
        super().__init__()
        if min(input_hw) < 65:
            raise ValueError(
                "DeepFace's VALID conv/LC ladder needs inputs >= 65x65 "
                f"(canonical 152x152); got {input_hw[0]}x{input_hw[1]}")
        self.num_classes = num_classes
        self.input_hw = tuple(input_hw)
        self.in_channels = in_channels
        self.feature_dim = feature_dim
        sizes = deepface_sizes(input_hw)
        self.c1 = nn.Conv2d(in_channels, 32, 11)
        self.c3 = nn.Conv2d(32, 16, 9)
        cin = 16
        for (name, k), hw in zip(LC_LAYERS, sizes[1:4]):
            setattr(self, name, LocallyConnected2D(hw, cin, lc_features, k))
            cin = lc_features
        oh, ow = sizes[4]
        self.f7 = nn.Linear(oh * ow * lc_features, feature_dim)
        self.f7_drop = Dropout(0.5)
        self.f8 = nn.Linear(feature_dim, num_classes)

    def _named_layers(self):
        return [((name,), getattr(self, name))
                for name in ("c1", "c3", "f7", "f8")]

    def _lc_layers(self):
        return [(name, getattr(self, name)) for name, _ in LC_LAYERS]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's init, in the flax net's layer order."""
        for name in ("c1", "c3", "l4", "l5", "l6", "f7", "f8"):
            layer = getattr(self, name)
            if isinstance(layer, LocallyConnected2D):
                layer.init_weights(generator)
            else:
                init_conv_(layer, generator)
        return self

    @torch.no_grad()
    def load_flax_params(self, params: dict):
        for (name,), layer in self._named_layers():
            load_kernel_(layer, params[name])
        for name, layer in self._lc_layers():
            layer.load_flax(params[name])
        return self

    def flax_params(self) -> dict:
        tree = {name: flax_entry(layer) for (name,), layer
                in self._named_layers()}
        tree.update({name: layer.flax_entry()
                     for name, layer in self._lc_layers()})
        return tree

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        if min(x.shape[1], x.shape[2]) < 65:
            raise ValueError(
                "DeepFace's VALID conv/LC ladder needs inputs >= 65x65 "
                f"(canonical 152x152); got {x.shape[1]}x{x.shape[2]}")
        x = x.to(self.f7.weight.dtype)
        x = torch.relu(conv_nhwc(x, self.c1))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2).permute(0, 2, 3, 1)
        x = torch.relu(conv_nhwc(x, self.c3))
        for name, layer in self._lc_layers():
            x = torch.relu(layer(x))
        return torch.relu(self.f7(x.reshape(x.shape[0], -1)))

    def classify(self, feat: torch.Tensor):
        logits = self.f8(self.f7_drop(feat))
        return logits.float(), feat.float()


def build_deepface(num_classes: int, *, input_hw=(152, 152),
                   in_channels: int = 3, params: dict | None = None,
                   generator: torch.Generator | None = None,
                   dtype: torch.dtype = torch.float32,
                   feature_dim: int = 4096, lc_features: int = 16,
                   device=None) -> DeepFace:
    """A ready DeepFace (see ``lightcnn.finish_build``); with ``params``
    the widths are the tree's."""
    if params is not None:
        feature_dim = np.asarray(params["f7"]["kernel"]).shape[1]
        lc_features = np.asarray(params["l4"]["kernel"]).shape[3]
    return finish_build(DeepFace(num_classes, input_hw, in_channels,
                                 feature_dim, lc_features),
                        params=params, generator=generator, dtype=dtype,
                        device=device)
