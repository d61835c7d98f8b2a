"""The 342-d EFM "symbol ladder" network, the serving/extraction model.

Port of the JAX package's ``models/efm_symbol.py``: a fused 5x5 stem (99
filters, EFM3, pool), then four stages with the 99/198/387/261/261 ladder
and residual counts [1, 2, 3, 4] (res blocks -> 1x1 conv -> EFM3 -> 3x3
conv -> EFM3 -> 2x2 pool), then fc1 = Linear(513) -> EFM3 = the 342-d
feature, Dropout(0.7) and the fc2 ID logits (``classify(embed(x))``, see
``models/lightcnn.py``). Input ``[B, H, W, 1]``
grayscale in [0, 1], H = W a multiple of 32 (64 at serving).

Activations stay channel-last; fc1 flattens the channel-last ``[B, h, w, C]``
map as the flax net does, so flax weights load without a row permutation.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.mfm import efm3
from .lightcnn import (Dropout, EFMResBlock, FlaxLayers, FusedStem,
                       _maxpool2, finish_build, same_conv)
from .mtcnn import conv_nhwc

# (num_r, num, tar_num) of stages 2-5 (efm_symbol.py:85-92 of the reference)
LADDER = [(99, 198, 1), (198, 387, 2), (387, 261, 3), (261, 261, 4)]


class EFMNet342(FlaxLayers):
    """Symbol-ladder EFM net: ``[B, H, W, 1] -> (logits, feat342)``, both
    float32 whatever the compute dtype."""

    feature_dim = 342
    model_name = "efmnet342"
    in_channels = 1

    def __init__(self, num_classes: int, image_size: int = 64):
        super().__init__()
        if image_size % 32:
            raise ValueError(f"image_size must be a multiple of 32, got "
                             f"{image_size}")
        self.num_classes = num_classes
        self.image_size = image_size
        self.input_hw = (image_size, image_size)
        self.conv1 = FusedStem(99, maxout=3)
        self.res = nn.ModuleList()
        self.conv1x1 = nn.ModuleList()
        self.conv = nn.ModuleList()
        cin = 66
        for num_r, num, tar in LADDER:
            self.res.append(EFMResBlock(tar, num_r))
            self.conv1x1.append(same_conv(cin, num_r, 1))
            self.conv.append(same_conv(num_r * 2 // 3, num, 3))
            cin = num * 2 // 3
        side = image_size // 32
        self.fc1 = nn.Linear(side * side * cin, 513)
        self.drop1 = Dropout(0.7)
        self.fc2 = nn.Linear(342, num_classes)

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.fc1.weight.dtype))
        for res, c1, c3 in zip(self.res, self.conv1x1, self.conv):
            x = res(x)
            x = efm3(conv_nhwc(x, c1))
            x = efm3(conv_nhwc(x, c3))
            x = _maxpool2(x)
        return efm3(self.fc1(x.reshape(x.shape[0], -1)))

    def classify(self, feat: torch.Tensor):
        logits = self.fc2(self.drop1(feat))
        return logits.float(), feat.float()

    def _named_layers(self) -> list[tuple[tuple[str, ...], nn.Module]]:
        """(flax path, layer) for every conv and dense layer."""
        layers = [(("conv1",), self.conv1.conv)]
        for si, (res, c1, c3) in enumerate(
                zip(self.res, self.conv1x1, self.conv), start=2):
            layers += [((f"stage{si}_res", name), conv)
                       for name, conv in res.flax_names()]
            layers += [((f"stage{si}_conv1x1",), c1),
                       ((f"stage{si}_conv",), c3)]
        return layers + [(("fc1",), self.fc1), (("fc2",), self.fc2)]


def build_efmnet342(num_classes: int, *, image_size: int = 64,
                    params: dict | None = None,
                    generator: torch.Generator | None = None,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> EFMNet342:
    """A ready EFMNet342 (see ``lightcnn.finish_build``)."""
    return finish_build(EFMNet342(num_classes, image_size=image_size),
                        params=params, generator=generator, dtype=dtype,
                        device=device)

