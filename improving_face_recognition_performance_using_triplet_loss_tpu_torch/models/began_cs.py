"""BEGAN-CS generator and autoencoder-discriminator (Chang et al., 2018).

Port of the JAX package's ``models/began_cs.py``, over channel-last
``[B, H, W, C]`` tensors with the flax trees' layer names:

- ``Decoder`` / ``Generator``: z ``[B, h]`` -> Dense(8*8*n) -> per scale
  two 3x3 convs (ELU) and a 2x nearest upsample -> a 3x3 conv to the
  image's channels -> tanh, ``[B, size, size, channels]`` in [-1, 1].
- ``Encoder``: a 3x3 conv (n) -> blocks of widening 3x3 convs (n, 2n,
  3n ...) each ending in a stride-2 SAME conv, down to 8x8 -> Dense(h).
  Its latent space doubles as the face-embedding space.
- ``AutoencoderDiscriminator``: Encoder -> Decoder, ``(recon, z)``;
  ``encode`` runs the encoder alone.

Stride-2 SAME convs pad as TensorFlow does (the extra row and column
after), the nearest upsample repeats each pixel, as
``jax.image.resize(..., "nearest")`` does at 2x.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .lightcnn import FlaxLayers
from .mtcnn import conv_nhwc

_UPS = {8: 0, 16: 1, 32: 2, 64: 3, 128: 4}


def _tf_pad_stride2(n: int) -> tuple[int, int]:
    """TF SAME padding (before, after) of a 3x3 stride-2 conv over n."""
    need = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
    return need // 2, need - need // 2


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 3x3 SAME conv of a ``[B, H, W, C]`` tensor, stride 1 (padded by
    the module) or 2 (TF's padding here)."""
    if conv.stride[0] == 2:
        (t, b), (lf, r) = _tf_pad_stride2(x.shape[1]), _tf_pad_stride2(
            x.shape[2])
        x = F.pad(x, (0, 0, lf, r, t, b))
    return conv_nhwc(x, conv)


class Decoder(FlaxLayers):
    """z [B, h] -> image [B, size, size, channels] in [-1, 1]."""

    def __init__(self, size: int = 64, channels: int = 3, n: int = 64,
                 h_dim: int = 64):
        super().__init__()
        self.n = n
        self.num_ups = _UPS[size]
        self.fc = nn.Linear(h_dim, 8 * 8 * n)
        for i in range(self.num_ups + 1):
            setattr(self, f"conv{i}a", nn.Conv2d(n, n, 3, padding=1))
            setattr(self, f"conv{i}b", nn.Conv2d(n, n, 3, padding=1))
        self.to_img = nn.Conv2d(n, channels, 3, padding=1)

    def _named_layers(self):
        names = ["fc"] + [f"conv{i}{ab}" for i in range(self.num_ups + 1)
                          for ab in "ab"] + ["to_img"]
        return [((name,), getattr(self, name)) for name in names]

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.fc(z.to(self.fc.weight.dtype)).reshape(-1, 8, 8, self.n)
        for i in range(self.num_ups + 1):
            x = F.elu(_conv(x, getattr(self, f"conv{i}a")))
            x = F.elu(_conv(x, getattr(self, f"conv{i}b")))
            if i < self.num_ups:
                x = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
        return torch.tanh(_conv(x, self.to_img)).float()


class Encoder(FlaxLayers):
    """image [B, size, size, channels] -> z [B, h] (the embedding space)."""

    def __init__(self, size: int = 64, channels: int = 3, n: int = 64,
                 h_dim: int = 64):
        super().__init__()
        self.conv_in = nn.Conv2d(channels, n, 3, padding=1)
        cin, i = n, 0
        while size > 8:
            width = n * (i + 1)
            setattr(self, f"block{i}a", nn.Conv2d(cin, width, 3, padding=1))
            setattr(self, f"block{i}down", nn.Conv2d(width, width, 3,
                                                      stride=2))
            cin, size, i = width, size // 2, i + 1
        self.blocks = i
        self.fc = nn.Linear(size * size * cin, h_dim)

    def _named_layers(self):
        names = (["conv_in"] + [f"block{i}{p}" for i in range(self.blocks)
                                for p in ("a", "down")] + ["fc"])
        return [((name,), getattr(self, name)) for name in names]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.elu(_conv(x.to(self.fc.weight.dtype), self.conv_in))
        for i in range(self.blocks):
            x = F.elu(_conv(x, getattr(self, f"block{i}a")))
            x = F.elu(_conv(x, getattr(self, f"block{i}down")))
        return self.fc(x.reshape(x.shape[0], -1)).float()


class Generator(FlaxLayers):
    """The BEGAN generator: the decoder's topology, its own weights
    (flax path ``dec``)."""

    def __init__(self, size: int = 64, channels: int = 3, n: int = 64,
                 h_dim: int = 64):
        super().__init__()
        self.dec = Decoder(size, channels, n, h_dim)

    def _named_layers(self):
        return [(("dec",) + p, layer)
                for p, layer in self.dec._named_layers()]

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.dec(z)


class AutoencoderDiscriminator(FlaxLayers):
    """Encoder -> Decoder; returns ``(reconstruction, latent)``."""

    def __init__(self, size: int = 64, channels: int = 3, n: int = 64,
                 h_dim: int = 64):
        super().__init__()
        self.enc = Encoder(size, channels, n, h_dim)
        self.dec = Decoder(size, channels, n, h_dim)

    def _named_layers(self):
        return ([(("enc",) + p, layer)
                 for p, layer in self.enc._named_layers()]
                + [(("dec",) + p, layer)
                   for p, layer in self.dec._named_layers()])

    def forward(self, x: torch.Tensor):
        z = self.enc(x)
        return self.dec(z), z

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """The embedding alone (for triplet training and extraction)."""
        return self.enc(x)
