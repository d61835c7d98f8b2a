"""DeepFace embedding network (Taigman et al., CVPR 2014), in two ladders.

``deepface`` is the port of the JAX package's ``models/deepface.py``: C1
11x11x32 conv -> 3x3/2 max-pool (rounding down) -> C3 9x9x16 conv ->
three locally connected layers at stride 1 (L4 9x9x16, L5 7x7x16, L6
5x5x16) -> F7, the 4096-d embedding, fully connected -> F8 softmax, over
channel-last ``[B, H, W, C]`` input (canonical 152x152x3; 65x65 at
least). At 152 its ladder is C3 62, L4 54, L5 48, L6 44 (229 M
parameters): not the paper's, but the JAX twin's, which the parity tests
hold.

``deepface_cvpr14`` is the ladder of the paper's Fig. 2: M2 rounds its
output size up, as Caffe's pooling does (142 -> 71), and L5 takes stride
2, so 152x152x3 gives C1 142x142x32, M2 71x71x32, C3 63x63x16, L4
55x55x16, L5 25x25x16, L6 21x21x16, F7 4,096 over the 7,056-wide
channel-last flatten and F8 4,030 (SFC's identities): 118,923,774
parameters, the paper's "more than 120 million". 72x72 at least.
Departures from the paper: its figure prints C3 as 9x9x16 without the
input depth, and C1 gives 32 channels, so C3's filters take 32;
frontalisation and F7's normalisation at test time are outside the net;
it is trained with the thesis's joint softmax + 0.1 x triplet loss, not
the paper's softmax alone. The JAX package cannot build this ladder.

A locally connected layer has a weight per output position: here
``F.unfold`` gathers each position's patch (channel outermost, then the
kernel's rows and columns: the feature order of JAX's
``conv_general_dilated_patches``, so the flax ``[OH, OW, C*KH*KW, F]``
kernel loads as it is), the patches are laid out position-major and one
batched product over the positions contracts them. No Pallas kernel
computes it in the JAX package, and none does here. F7 takes the
channel-last flatten, as the flax net does. Under a profiler session
each LC layer's forward and backward are the device span ``lc`` (timing
events alone, inside the step's ``train.forward`` / ``train.backward``)
and the patch matrices it builds, and their gradients, the counter
``lc.patch_bytes``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.profiling import count, device_span, device_span_backward
from .lightcnn import (Dropout, FlaxLayers, finish_build, flax_entry,
                       init_conv_, lecun_normal_, load_kernel_)
from .mtcnn import conv_nhwc

# (name, kernel) of the locally connected layers
LC_LAYERS = (("l4", 9), ("l5", 7), ("l6", 5))
# ladder -> (M2 rounds its size up, L5's stride, the smallest input side)
LADDERS = {"deepface": (False, 1, 65), "deepface_cvpr14": (True, 2, 72)}


def _count_patches(t: torch.Tensor) -> None:
    """Count ``t``'s bytes, and its gradient's when the backward makes
    it, as ``lc.patch_bytes``, while a profiler session records."""
    if not torch.autograd.profiler._is_profiler_enabled \
            or torch.compiler.is_compiling():
        return
    nbytes = t.numel() * t.element_size()
    count("lc.patch_bytes", nbytes)
    if t.requires_grad:
        t.register_hook(lambda g: count("lc.patch_bytes", nbytes))


class LocallyConnected2D(nn.Module):
    """A conv with untied (per-position) weights; VALID, at ``stride``.
    ``kernel`` [OH, OW, C*K*K, F] and ``bias`` [OH, OW, F] in the flax
    layout."""

    def __init__(self, in_hw, channels: int, features: int, kernel: int,
                 stride: int = 1):
        super().__init__()
        self.k, self.stride = kernel, stride
        oh, ow = ((s - kernel) // stride + 1 for s in in_hw)
        self.kernel = nn.Parameter(
            torch.zeros(oh, ow, channels * kernel * kernel, features))
        self.bias = nn.Parameter(torch.zeros(oh, ow, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        oh, ow, p, f = self.kernel.shape
        with device_span("lc"):
            patches = F.unfold(x.permute(0, 3, 1, 2), self.k,
                               stride=self.stride)           # [B, P, L]
            # position-major, as the product takes it (bmm would copy the
            # strided view anyway, and again in the backward)
            cols = patches.permute(2, 0, 1).contiguous()     # [L, B, P]
            # both layouts, and both gradients: the product's, and its
            # strided view, which fold lays out again
            _count_patches(patches)
            _count_patches(cols)
            out = torch.bmm(cols, self.kernel.reshape(oh * ow, p, f))
            out = out.permute(1, 0, 2).reshape(b, oh, ow, f) + self.bias
        device_span_backward("lc", out, x)
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator,
                     fan_in: int | None = None) -> None:
        """lecun_normal kernel over ``fan_in`` (default flax's count for
        this shape, OH*OW*P over the whole kernel), zero bias."""
        oh, ow, p, _ = self.kernel.shape
        self.kernel.copy_(lecun_normal_(torch.empty(self.kernel.shape),
                                        fan_in or oh * ow * p, generator))
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


def _pool(n: int, ceil: bool) -> int:
    """M2's 3x3/2 VALID output size, rounded up (Caffe) or down."""
    return -(-(n - 3) // 2) + 1 if ceil else (n - 3) // 2 + 1


def deepface_sizes(input_hw,
                   ladder: str = "deepface") -> list[tuple[int, int]]:
    """The (H, W) entering C3, L4, L5, L6 and leaving L6."""
    ceil, s5, _ = LADDERS[ladder]
    h, w = (_pool(s - 10, ceil) for s in input_hw)     # C1 11x11, M2
    sizes = [(h, w)]
    for k, s in ((9, 1), (9, 1), (7, s5), (5, 1)):     # C3, L4, L5, L6
        h, w = (h - k) // s + 1, (w - k) // s + 1
        sizes.append((h, w))
    return sizes


def deepface_ladder(params: dict) -> str:
    """Which ladder a flax-layout DeepFace tree has, from L4's and L5's
    output positions (L5 at stride 2 roughly halves them)."""
    o4 = np.asarray(params["l4"]["kernel"]).shape[0]
    o5 = np.asarray(params["l5"]["kernel"]).shape[0]
    return "deepface" if o5 == o4 - 6 else "deepface_cvpr14"


def deepface_side(params: dict) -> int:
    """The even square input side a flax-layout DeepFace tree was built
    for. The twin's, from L6's output positions (sides 2k + 11 and 2k + 12
    give the same ladder; 152, the canonical side, is the even one); the
    published ladder's, from L4's (M2 = L4 + 16 comes from sides 2 M2 + 9
    and 2 M2 + 10)."""
    if deepface_ladder(params) == "deepface_cvpr14":
        o4 = np.asarray(params["l4"]["kernel"]).shape[0]
        return 2 * (o4 + 16) + 10
    o6 = np.asarray(params["l6"]["kernel"]).shape[0]
    return 2 * (o6 + 26) + 12


class DeepFace(FlaxLayers):
    """DeepFace: ``[B, H, W, C] -> (logits, 4096-d F7 embedding)``, on the
    twin's ladder (``deepface``) or the paper's (``deepface_cvpr14``)."""

    def __init__(self, num_classes: int, input_hw=(152, 152),
                 in_channels: int = 3, feature_dim: int = 4096,
                 lc_features: int = 16, ladder: str = "deepface"):
        super().__init__()
        self.model_name = ladder
        ceil, s5, self.floor = LADDERS[ladder]
        self._check_side(input_hw)
        self.num_classes = num_classes
        self.input_hw = tuple(input_hw)
        self.in_channels = in_channels
        self.feature_dim = feature_dim
        self.ceil = ceil
        sizes = deepface_sizes(input_hw, ladder)
        self.c1 = nn.Conv2d(in_channels, 32, 11)
        self.c3 = nn.Conv2d(32, 16, 9)
        cin = 16
        for (name, k), hw, s in zip(LC_LAYERS, sizes[1:4], (1, s5, 1)):
            setattr(self, name,
                    LocallyConnected2D(hw, cin, lc_features, k, stride=s))
            cin = lc_features
        oh, ow = sizes[4]
        self.f7 = nn.Linear(oh * ow * lc_features, feature_dim)
        self.f7_drop = Dropout(0.5)
        self.f8 = nn.Linear(feature_dim, num_classes)

    def _check_side(self, hw) -> None:
        if min(hw[0], hw[1]) < self.floor:
            raise ValueError(
                "DeepFace's VALID conv/LC ladder needs inputs >= "
                f"{self.floor}x{self.floor} (canonical 152x152); got "
                f"{hw[0]}x{hw[1]}")

    def _named_layers(self):
        return [((name,), getattr(self, name))
                for name in ("c1", "c3", "f7", "f8")]

    def _lc_layers(self):
        return [(name, getattr(self, name)) for name, _ in LC_LAYERS]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's init, in the flax net's layer order; the published
        ladder counts an LC kernel's fan-in per output position (each has
        its own filter bank), where flax counts the whole kernel."""
        for name in ("c1", "c3", "l4", "l5", "l6", "f7", "f8"):
            layer = getattr(self, name)
            if isinstance(layer, LocallyConnected2D):
                per_position = self.model_name == "deepface_cvpr14"
                layer.init_weights(generator, layer.kernel.shape[2]
                                   if per_position else None)
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
        self._check_side(x.shape[1:3])
        x = x.to(self.f7.weight.dtype)
        x = torch.relu(conv_nhwc(x, self.c1))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2,
                         ceil_mode=self.ceil).permute(0, 2, 3, 1)
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
                   ladder: str = "deepface", device=None) -> DeepFace:
    """A ready DeepFace on ``ladder`` (see ``lightcnn.finish_build``);
    with ``params`` the widths are the tree's."""
    if params is not None:
        feature_dim = np.asarray(params["f7"]["kernel"]).shape[1]
        lc_features = np.asarray(params["l4"]["kernel"]).shape[3]
    return finish_build(DeepFace(num_classes, input_hw, in_channels,
                                 feature_dim, lc_features, ladder),
                        params=params, generator=generator, dtype=dtype,
                        device=device)
