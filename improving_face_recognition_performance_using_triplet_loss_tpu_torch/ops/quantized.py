"""Int8 inference forward: the quantized embedding nets.

Port of the JAX package's ``ops/quantized.py``. Post-training
quantization for inference:

- conv weights: per-output-channel symmetric int8, ``scale_j = max|w[:, j]|
  / 127`` (zero scales mapped to 1);
- activations: dynamic per-tensor symmetric int8, ``max|x| / 127`` over the
  whole tensor (the JAX package vmaps its pipelines over frames, so there
  the "tensor" is one frame's: ``groups`` splits the batch the same way);
- the product: an exact int8 x int8 -> int32 matmul over the im2col
  patches (``torch._int_mm`` through ``ops.distances.int8_product``, zero
  padded; never a float product), dequantized as ``acc * (s_a * s_w) +
  bias`` before any MFM/EFM, since per-channel scales put the maxout halves
  on different scales;
- the 5x5 stem and the dense tail stay in the compute dtype.

``quantize_lightcnn9_params`` + ``make_int8_lightcnn9_extract`` are the
hard-coded LightCNN9 ladder (its stem through kernel B3 on the card);
``int8_conv_interceptor`` reroutes every eligible conv of any port net
(every conv runs through ``models.mtcnn.conv_nhwc``, and the route is the
twin of flax's ``intercept_methods``); ``make_int8_extract`` is the
generic forward. Accuracy contract: embedding cosine to the float forward
>= 0.999. In jitted JAX a division by the constant 127 becomes a product
with its float32 reciprocal, so the scales computed per call take that
form; the host-side weight quantization divides.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..models.mtcnn import conv_route, plain_conv_nhwc
from ..parallel.collectives import all_reduce
from .cuda.stem import stem_conv_maxout_pool
from .distances import int8_product, l2_normalize
from .mfm import mfm2
from .s2d_stem import reference_stem

# LightCNN9's conv ladder after the stem, with its pools
_LADDER = [("conv2a", False), ("conv2", True), ("conv3a", False),
           ("conv3", True), ("conv4a", False), ("conv4", False),
           ("conv5a", False), ("conv5", True)]

# XLA's form of a jitted division by 127.0: the float32 reciprocal
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_lightcnn9_params(params, device=None) -> dict:
    """Host-side, once: per-output-channel int8 conv weights and scales of
    a LightCNN9 flax params tree (numpy, HWIO); the stem and the dense
    tail pass through in float32. The int8 kernels come out in the torch
    layout ``[Cout, Cin, kh, kw]``, every tensor on ``device`` (``cuda``
    unless given)."""
    dev = resolve_device(device)
    q: dict = {}
    for name, _ in _LADDER:
        w = np.asarray(params[name]["kernel"], np.float32)
        s = np.abs(w).reshape(-1, w.shape[-1]).max(axis=0) / 127.0
        s = np.where(s > 0.0, s, 1.0).astype(np.float32)
        w8 = np.clip(np.rint(w / s), -127, 127).astype(np.int8)
        q[name] = {
            "w8": torch.from_numpy(np.ascontiguousarray(
                w8.transpose(3, 2, 0, 1))).to(dev),
            "scale": torch.from_numpy(s).to(dev),
            "bias": torch.from_numpy(np.asarray(params[name]["bias"],
                                                np.float32)).to(dev),
        }
    for name in ("conv1", "fc1"):
        q[name] = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                   for k, v in params[name].items()}
    return q


def quantize_activations(x: torch.Tensor, groups: int = 1,
                         process_group=None):
    """Dynamic symmetric int8 of ``x`` with one scale for each of
    ``groups`` equal slices of its leading axis (1: the whole tensor);
    scale math in float32. With ``process_group`` the magnitudes are the
    maxima over its ranks (each holding its block of one batch), so the
    scale is the whole batch's. Returns ``(int8 x, scales [groups])``."""
    xf = x.float()
    amax = xf.abs().reshape(groups, -1).amax(dim=1)
    if process_group is not None:
        amax = all_reduce(amax, "max", process_group)
    s = amax * _INV_127
    s = torch.where(s > 0.0, s, 1.0)
    rows = s.repeat_interleave(x.shape[0] // groups)
    xq = torch.clamp(torch.round(xf / rows.reshape(-1, *[1] * (x.dim() - 1))),
                     -127, 127).to(torch.int8)
    return xq, s


def int8_conv_nhwc(xq: torch.Tensor, w8: torch.Tensor, stride=(1, 1),
                   padding=(0, 0)) -> torch.Tensor:
    """Exact int8 conv: ``xq [B, H, W, C]`` int8 and ``w8 [O, C, kh, kw]``
    int8 with zero padding -> ``[B, H', W', O]`` int32 sums (JAX's
    ``conv_general_dilated(..., preferred_element_type=int32)``), as the
    im2col patches ``[B*H'*W', kh*kw*C]`` times the kernel rows in one
    int8 product."""
    o, c, kh, kw = w8.shape
    sh, sw = stride
    ph, pw = padding
    if ph or pw:
        xq = F.pad(xq, (0, 0, pw, pw, ph, ph))
    b, hp, wp, _ = xq.shape
    ho, wo = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    if kh == kw == 1 and sh == sw == 1:
        patches = xq.reshape(b * ho * wo, c)
    else:
        patches = torch.stack(
            [xq[:, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw]
             for i in range(kh) for j in range(kw)], dim=3)
        patches = patches.reshape(b * ho * wo, kh * kw * c)
    rows = w8.permute(0, 2, 3, 1).reshape(o, kh * kw * c)
    return int8_product(patches, rows).reshape(b, ho, wo, o)


def _dequantize(acc, s_a, s_w, bias, groups: int):
    """``acc * (s_a * s_w) + bias`` in float32, one activation scale for
    each group of rows. The multiply-add rounds once (``addcmul``), as
    XLA fuses it into a fused multiply-add."""
    scale = (s_a[:, None] * s_w[None, :])[:, None, :]       # [G, 1, O]
    y = acc.float().reshape(groups, -1, acc.shape[-1])
    y = y * scale if bias is None else torch.addcmul(bias.float(), y, scale)
    return y.reshape(acc.shape)


def _maxpool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def make_int8_lightcnn9_extract(qparams: dict,
                                compute_dtype: torch.dtype = torch.bfloat16):
    """``fn(images [B, H, W, 1] f32) -> embeddings [B, 256] f32``
    (L2-normalized), the conv ladder in int8 from
    :func:`quantize_lightcnn9_params`. The stem (5x5, mfm2, 2x2 pool) is
    kernel B3 for CUDA tensors of even height and width, as
    ``models.lightcnn.FusedStem`` routes it, else the unfused stem."""
    d = compute_dtype

    def qconv(x, name):
        layer = qparams[name]
        k = layer["w8"].shape[-1]
        xq, s_a = quantize_activations(x)
        acc = int8_conv_nhwc(xq, layer["w8"], padding=(k // 2, k // 2))
        return _dequantize(acc, s_a, layer["scale"], layer["bias"], 1).to(d)

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        x = images.to(d)
        w1 = qparams["conv1"]["kernel"].to(d)
        b1 = qparams["conv1"]["bias"]
        if x.is_cuda and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0:
            x = stem_conv_maxout_pool(x, w1, b1, maxout=2)
        else:
            x = reference_stem(x, w1, b1, maxout=2)
        for name, do_pool in _LADDER:
            x = mfm2(qconv(x, name))
            if do_pool:
                x = _maxpool2(x)
        x = x.reshape(x.shape[0], -1)
        fc1 = (x @ qparams["fc1"]["kernel"].to(d)
               + qparams["fc1"]["bias"].to(d))
        return l2_normalize(mfm2(fc1).float())

    return extract


def _same_or_valid(conv: nn.Conv2d) -> bool:
    """flax's string padding: VALID (none), or SAME at stride 1 with an
    odd kernel (``k // 2`` each side)."""
    kh, kw = conv.kernel_size
    if tuple(conv.padding) == (0, 0):
        return True
    return (tuple(conv.stride) == (1, 1) and kh % 2 == 1 and kw % 2 == 1
            and tuple(conv.padding) == (kh // 2, kw // 2))


class Int8ConvRoute:
    """The conv route of :func:`int8_conv_interceptor`: ``route(x, conv)``
    for a ``[B, H, W, C]`` input. An eligible conv (``kh*kw*cin >=
    min_k``, unit dilation, one group, zero padding that is SAME or VALID)
    runs as an exact int8 conv, dequantized and cast to ``compute_dtype``
    (the conv's own dtype when None); any other runs in its own dtype, its
    input cast to it as a flax layer casts. ``rerouted`` / ``passed`` hold
    the convs seen each way. Weights are quantized once per weight version
    and kept, so a caller that runs many batches keeps one route and
    enters it with ``models.mtcnn.conv_route`` for each. With
    ``process_group`` the activation scales are over every rank's block of
    the batch (sharded extraction)."""

    def __init__(self, min_k: int = 64, compute_dtype=None, groups: int = 1,
                 process_group=None):
        self.min_k = min_k
        self.compute_dtype = compute_dtype
        self.groups = groups
        self.process_group = process_group
        self.rerouted: set[nn.Conv2d] = set()
        self.passed: set[nn.Conv2d] = set()
        self._weights: dict = {}

    def reroutes(self, conv: nn.Conv2d) -> bool:
        kh, kw = conv.kernel_size
        return (kh * kw * conv.in_channels >= self.min_k
                and tuple(conv.dilation) == (1, 1) and conv.groups == 1
                and conv.padding_mode == "zeros" and _same_or_valid(conv))

    def _quantized_weight(self, conv: nn.Conv2d):
        w = conv.weight
        key = (w.data_ptr(), w._version, w.device)
        hit = self._weights.get(id(conv))
        if hit is None or hit[0] != key:
            wf = w.detach().float()
            s = wf.abs().reshape(wf.shape[0], -1).amax(dim=1) * _INV_127
            s = torch.where(s > 0.0, s, 1.0)
            w8 = torch.clamp(torch.round(wf / s[:, None, None, None]),
                             -127, 127).to(torch.int8)
            hit = (key, w8, s)
            self._weights[id(conv)] = hit
        return hit[1], hit[2]

    def __call__(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != conv.in_channels \
                or not self.reroutes(conv):
            self.passed.add(conv)
            return plain_conv_nhwc(x.to(conv.weight.dtype), conv)
        self.rerouted.add(conv)
        w8, s_w = self._quantized_weight(conv)
        xq, s_a = quantize_activations(x, self.groups, self.process_group)
        acc = int8_conv_nhwc(xq, w8, tuple(conv.stride), tuple(conv.padding))
        y = _dequantize(acc, s_a, s_w, conv.bias, self.groups)
        return y.to(self.compute_dtype or conv.weight.dtype)


@contextlib.contextmanager
def int8_conv_interceptor(min_k: int = 64, compute_dtype=None,
                          groups: int = 1):
    """Reroute every eligible conv of the port's nets run inside the block
    through the exact int8 product (:class:`Int8ConvRoute`). Ineligible
    convs (the 5x5 Cin=1 stems, K = 25; LightCNN9's conv2a, K = 48) and the
    dense layers keep their dtype. ``groups`` gives each of that many equal
    slices of the batch its own activation scale (a frame's crops in the
    serving pipelines, as the JAX package's per-frame ``vmap`` computes
    them). On the card LightCNN9 then takes kernel B4, never B6, for its
    front: B6 fuses conv2, which this route quantizes. Yields the route."""
    with conv_route(Int8ConvRoute(min_k, compute_dtype, groups)) as route:
        yield route


def make_int8_extract(model: nn.Module, *, min_k: int = 64,
                      compute_dtype=torch.bfloat16, groups: int = 1):
    """Int8 inference forward of any ``(logits, feat)`` port net
    (EFMNet342, LightCNN29, LightCNN9): ``images [B, H, W, C] f32 ->
    L2-normalized embeddings f32``, every eligible conv on the int8 route
    of :func:`int8_conv_interceptor`."""
    model.eval()
    route = Int8ConvRoute(min_k, compute_dtype, groups)

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        with conv_route(route):
            _, feat = model(images)
        return l2_normalize(feat.float())

    return extract
