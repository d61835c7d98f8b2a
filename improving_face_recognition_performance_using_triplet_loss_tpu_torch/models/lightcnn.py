"""LightCNN building blocks with MFM/EFM activations, over channel-last
tensors.

Port of the part of the JAX package's ``models/lightcnn.py`` that the
342-d EFM net uses: ``FusedStem`` (the 5x5 Cin=1 stem with its maxout and
2x2 pool), ``EFMResBlock`` (including the gluon original's shared-weight
variant) and ``_maxpool2``. LightCNN29 and LightCNN9 are not ported yet
(ROADMAP.md, queue A).

Activations keep the JAX layout, ``[B, H, W, C]``: an EFM is then a
``[rows, C]`` pass over contiguous memory (kernel B2), and each conv runs on
the NCHW view, which is channels-last in memory. Weights are ``nn.Conv2d``
modules (OIHW); ``flax_params`` / ``load_flax_params`` carry them to and from
the flax trees (HWIO kernels) with the same layer names.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.stem import stem_conv_maxout_pool
from ..ops.mfm import efm3
from ..ops.s2d_stem import reference_stem
from .mtcnn import conv_nhwc

# flax's lecun_normal: a truncated normal on [-2, 2] rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """Fill ``w`` like ``flax.linen.initializers.lecun_normal()``."""
    nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w.mul_(math.sqrt(1.0 / fan_in) / _TRUNC_STD)


def same_conv(cin: int, cout: int, k: int) -> nn.Conv2d:
    """A stride-1 conv with flax's SAME padding (odd ``k``)."""
    return nn.Conv2d(cin, cout, k, padding=k // 2)


@torch.no_grad()
def init_conv_(conv: nn.Module, generator: torch.Generator) -> None:
    """flax's Conv/Dense init: lecun_normal kernel, zero bias. The kernel
    is drawn in the flax layout (HWIO / ``[in, out]``) and transposed in."""
    w = conv.weight
    if w.ndim == 4:
        o, i, kh, kw = w.shape
        hwio = lecun_normal_(torch.empty(kh, kw, i, o), kh * kw * i, generator)
        w.copy_(hwio.permute(3, 2, 0, 1))
    else:
        o, i = w.shape
        w.copy_(lecun_normal_(torch.empty(i, o), i, generator).T)
    conv.bias.zero_()


def hwio(conv: nn.Module) -> np.ndarray:
    """A conv's (or dense layer's) kernel in the flax layout, as numpy."""
    w = conv.weight.detach().float().cpu()
    w = w.permute(2, 3, 1, 0) if w.ndim == 4 else w.T
    return np.ascontiguousarray(w.numpy())


@torch.no_grad()
def load_kernel_(conv: nn.Module, entry: dict) -> None:
    """Copy a flax ``{kernel, bias}`` entry into ``conv``."""
    k = torch.as_tensor(np.asarray(entry["kernel"], np.float32))
    k = k.permute(3, 2, 0, 1) if k.ndim == 4 else k.T
    conv.weight.copy_(k)
    conv.bias.copy_(torch.as_tensor(np.asarray(entry["bias"], np.float32)))


def flax_entry(conv: nn.Module) -> dict[str, np.ndarray]:
    return {"kernel": hwio(conv),
            "bias": np.ascontiguousarray(
                conv.bias.detach().float().cpu().numpy())}


class FusedStem(nn.Module):
    """The 5x5 stem conv + maxout (2 = mfm2, 3 = efm3) + 2x2/2 max-pool.

    On the card at inference (eval mode, no autograd) with a one-channel
    input of even height and width it launches kernel B3
    (``ops/cuda/stem.py``), the conv, maxout and pool in one pass. Training,
    the CPU and other shapes run the unfused ``reference_stem`` with the
    same weights. The weights are those of ``nn.Conv2d(1, features, 5)``,
    the flax tree's ``{kernel, bias}`` (grayscale input; the RGB variant of
    the JAX stem comes with LightCNN29, ROADMAP.md queue A)."""

    def __init__(self, features: int, maxout: int = 2):
        super().__init__()
        if maxout not in (2, 3):
            raise ValueError(f"maxout must be 2 or 3, got {maxout}")
        self.maxout = maxout
        self.conv = same_conv(1, features, 5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.permute(2, 3, 1, 0)            # HWIO view
        b = self.conv.bias
        x = x.to(w.dtype)
        h, wd, c = x.shape[1], x.shape[2], x.shape[3]
        eligible = c == 1 and h % 2 == 0 and wd % 2 == 0
        if (x.is_cuda and eligible and not self.training
                and not torch.is_grad_enabled()):
            return stem_conv_maxout_pool(x, w, b, maxout=self.maxout)
        return reference_stem(x, w, b, maxout=self.maxout)


class EFMResBlock(nn.Module):
    """Residual EFM block chain: each of ``num_blocks`` iterations is
    EFM3 -> 3x3 conv(filters) -> EFM3 -> 3x3 conv(filters*2/3) -> + input.
    Channel-preserving at ``filters * 2 // 3``. ``share_weights=True``
    reuses one conv pair for every iteration, as the gluon original does;
    the default gives each iteration its own (the symbol variant)."""

    def __init__(self, num_blocks: int, filters: int,
                 share_weights: bool = False):
        super().__init__()
        self.num_blocks = num_blocks
        self.share_weights = share_weights
        out_ch = filters * 2 // 3
        pairs = 1 if share_weights else num_blocks
        self.conv_a = nn.ModuleList(
            [same_conv(out_ch * 2 // 3, filters, 3) for _ in range(pairs)])
        self.conv_b = nn.ModuleList(
            [same_conv(filters * 2 // 3, out_ch, 3) for _ in range(pairs)])

    def flax_names(self) -> list[tuple[str, nn.Module]]:
        if self.share_weights:
            return [("conv_a", self.conv_a[0]), ("conv_b", self.conv_b[0])]
        return [(f"conv_{ab}_{i}", conv) for i in range(self.num_blocks)
                for ab, conv in (("a", self.conv_a[i]), ("b", self.conv_b[i]))]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_blocks):
            j = 0 if self.share_weights else i
            h = conv_nhwc(efm3(x), self.conv_a[j])
            h = conv_nhwc(efm3(h), self.conv_b[j])
            x = x + h
        return x


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of a ``[B, H, W, C]`` tensor."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
