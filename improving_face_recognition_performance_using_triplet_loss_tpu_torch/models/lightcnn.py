"""LightCNN networks with MFM/EFM activations, over channel-last tensors.

Port of the JAX package's ``models/lightcnn.py``: ``FusedStem`` (the 5x5
stem with its maxout and 2x2 pool), ``EFMConv``, ``EFMResBlock``
(including the gluon original's shared-weight variant),
``LightCNN29`` (the 684-d EFM3 net) and ``LightCNN9`` (the 256-d MFM2
benchmark net), each returning ``(logits, feature)`` in float32.

Activations keep the JAX layout, ``[B, H, W, C]``: an EFM is then a
``[rows, C]`` pass over contiguous memory (kernel B2), and each conv runs on
the NCHW view, which is channels-last in memory. Weights are ``nn.Conv2d``
/ ``nn.Linear`` modules; ``flax_params`` / ``load_flax_params`` carry them
to and from the flax trees (HWIO kernels) with the same layer names, and
fc1 takes the channel-last flatten as the flax nets do.

On the card at inference, LightCNN9's conv1..pool2 runs kernel B6
(``ops/cuda/front9.py``) or its conv1..conv2a kernel B4
(``ops/cuda/stem.py``), as :func:`lightcnn9_front_route` decides, and the
stems of the EFM nets run kernel B3; training and the CPU run the plain
layers with the same weights (as the JAX training forward does), and every
EFM3 runs kernel B2 with its backward kernel.

In training mode (``train()``) the nets follow flax's training semantics:
:class:`Dropout` keeps a unit with probability ``1 - p`` and draws from
the generator the train step hands it, and LightCNN29's ``fc1_bn`` is a
:class:`FlaxBatchNorm`. Each forward is ``classify(embed(x))``: ``embed``
runs the layers up to the raw feature, ``classify`` the dropout, the ID
logits and the feature's normalization, so a train step can recompute
``embed`` in its backward (remat) without redrawing dropout or updating
the BatchNorm statistics twice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.cuda.front9 import front9_chain, pack_front9_weights
from ..ops.cuda.stem import stem2_conv, stem_conv_maxout_pool
from ..ops.mfm import efm3, mfm2
from ..ops.s2d_stem import reference_stem
from .mtcnn import active_conv_route, conv_nhwc

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


class Dropout(nn.Module):
    """flax's ``Dropout``: in training mode keep each unit with
    probability ``1 - p`` and scale it by ``1 / (1 - p)``, drawing the
    mask from ``generator`` (set by the train step to its step
    generator; torch's default generator when None). The identity in eval
    mode and at ``p = 0``."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: torch.Generator | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        u = torch.rand(x.shape, generator=self.generator, device=x.device)
        return torch.where(u >= self.p, x / (1.0 - self.p),
                           torch.zeros_like(x))


class FlaxBatchNorm(nn.Module):
    """flax's ``BatchNorm`` over the last axis of ``[B, C]``, in float32
    whatever the input dtype, the result cast back to it.

    Training mode normalizes with the batch's mean and its *biased*
    variance ``max(0, mean(x^2) - mean^2)`` (flax's fast variance) and
    moves the running statistics by ``momentum * running + (1 - momentum)
    * batch`` with that same biased variance (flax's momentum 0.9 is
    torch's 0.1, and ``nn.BatchNorm1d`` would move the variance with the
    unbiased one). Eval mode normalizes with the running statistics.
    ``weight`` / ``bias`` are flax's ``scale`` / ``bias``."""

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(0)
            var = torch.clamp_min(torch.square(xf).mean(0)
                                  - torch.square(mean), 0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        return ((xf - mean) * mul + self.bias.float()).to(x.dtype)


class FusedStem(nn.Module):
    """The 5x5 stem conv + maxout (2 = mfm2, 3 = efm3) + 2x2/2 max-pool.

    On the card at inference (eval mode, no autograd) with a one-channel
    input of even height and width it launches kernel B3
    (``ops/cuda/stem.py``), the conv, maxout and pool in one pass. Training,
    the CPU and other shapes run the unfused ``reference_stem`` with the
    same weights. The weights are those of ``nn.Conv2d(in_channels,
    features, 5)``, the flax tree's ``{kernel, bias}``; a 3-channel (RGB)
    stem always takes the unfused path, as in the JAX package."""

    def __init__(self, features: int, maxout: int = 2, in_channels: int = 1):
        super().__init__()
        if maxout not in (2, 3):
            raise ValueError(f"maxout must be 2 or 3, got {maxout}")
        self.maxout = maxout
        self.conv = same_conv(in_channels, features, 5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = hwio_view(self.conv)
        b = self.conv.bias
        x = x.to(w.dtype)
        h, wd, c = x.shape[1], x.shape[2], x.shape[3]
        eligible = c == 1 and h % 2 == 0 and wd % 2 == 0
        if (x.is_cuda and eligible and not self.training
                and not torch.is_grad_enabled()):
            return stem_conv_maxout_pool(x, w, b, maxout=self.maxout)
        return reference_stem(x, w, b, maxout=self.maxout)


def hwio_view(conv: nn.Conv2d) -> torch.Tensor:
    """A conv's weight as an HWIO view (no copy)."""
    return conv.weight.permute(2, 3, 1, 0)


class EFMConv(nn.Module):
    """Conv + EFM3, with an optional 1x1 conv + EFM3 before it (the
    reference's ``efm`` block): ``pre_filters > 0`` is 1x1 conv -> EFM3 ->
    KxK conv -> EFM3, else KxK conv -> EFM3. Stride 1, SAME padding."""

    def __init__(self, cin: int, filters: int, pre_filters: int = 0,
                 kernel: int = 3):
        super().__init__()
        self.pre_conv = same_conv(cin, pre_filters, 1) if pre_filters else None
        self.conv = same_conv(pre_filters * 2 // 3 if pre_filters else cin,
                              filters, kernel)

    def flax_names(self) -> list[tuple[str, nn.Module]]:
        pre = [("pre_conv", self.pre_conv)] if self.pre_conv is not None \
            else []
        return pre + [("conv", self.conv)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pre_conv is not None:
            x = efm3(conv_nhwc(x, self.pre_conv))
        return efm3(conv_nhwc(x, self.conv))


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


class FlaxLayers(nn.Module):
    """A net whose conv and dense layers carry their flax tree paths
    (``_named_layers``), so its weights move to and from a flax params
    tree and draw flax's init. ``forward(x)`` is ``classify(embed(x))``:
    ``(logits, feature)``, both float32."""

    def _named_layers(self) -> list[tuple[tuple[str, ...], nn.Module]]:
        raise NotImplementedError

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        """The layers up to the raw feature (before dropout and, in
        LightCNN29, its BatchNorm)."""
        raise NotImplementedError

    def classify(self, feat: torch.Tensor):
        """``(logits, feature)`` from the raw feature."""
        raise NotImplementedError

    def forward(self, x: torch.Tensor):
        return self.classify(self.embed(x))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's init (lecun_normal kernels, zero biases), in layer order."""
        for _, layer in self._named_layers():
            init_conv_(layer, generator)
        return self

    @torch.no_grad()
    def load_flax_params(self, params: dict):
        """Copy a flax params tree (numpy) in."""
        for path, layer in self._named_layers():
            node = params
            for key in path:
                node = node[key]
            load_kernel_(layer, node)
        return self

    def flax_params(self) -> dict:
        """This net's weights as a flax params tree of float32 numpy."""
        tree: dict = {}
        for path, layer in self._named_layers():
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = flax_entry(layer)
        return tree


def finish_build(net: FlaxLayers, *, params=None, generator=None,
                 dtype: torch.dtype = torch.float32, device=None, **load_kw):
    """``net`` in eval mode on ``device`` (``cuda`` unless given) computing
    in ``dtype``: flax ``params`` loaded when passed, else random init from
    ``generator`` on the CPU."""
    dev = resolve_device(device)
    if params is not None:
        net.load_flax_params(params, **load_kw)
    else:
        net.init_weights(generator or torch.Generator().manual_seed(0))
    return net.to(device=dev, dtype=dtype).eval()


def square_side(fc1_kernel, channels: int, stride: int) -> int:
    """The input side (H = W) a flax net was built for, from fc1's fan-in:
    ``channels`` maps at 1/``stride`` of the side."""
    fan_in = np.asarray(fc1_kernel).shape[0]
    return stride * int(round((fan_in // channels) ** 0.5))


# ------------------------------------------------------------- LightCNN29

# (res_blocks, res_filters, pre_filters, conv_filters) of groups 2-5
LADDER29 = [(1, 99, 99, 198), (2, 198, 198, 387), (3, 387, 387, 261),
            (4, 261, 261, 261)]


class LightCNN29(FlaxLayers):
    """LightCNN-29 with 3-way EFM: ``[B, H, W, C] -> (logits, feat684)``.

    group1 = 5x5 conv 99 -> EFM3 -> pool (a ``FusedStem``, kernel B3 on the
    card; its ``conv`` child gives the flax path ``group1/conv``, the tree
    the JAX package's ``FusedEFMStem`` wrapper exists to produce), groups
    2-5 = residual EFM blocks -> ``EFMConv`` -> pool, then
    fc1 (1026) -> EFM3 = the 684-d feature, whose eval BatchNorm
    (``fc1_bn``) is the returned feature, and Dropout(0.7) + fc2 on the
    un-normalized feature = the ID logits. ``share_weights`` is the gluon
    original's conv reuse across residual iterations (the JAX package's
    ``gluon_shared_res``)."""

    feature_dim = 684
    model_name = "lightcnn29"

    def __init__(self, num_classes: int, input_hw=(128, 128),
                 in_channels: int = 1, share_weights: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.input_hw = tuple(input_hw)
        self.in_channels = in_channels
        self.share_weights = share_weights
        self.group1 = FusedStem(99, maxout=3, in_channels=in_channels)
        self.res = nn.ModuleList()
        self.convs = nn.ModuleList()
        for nres, rf, pf, cf in LADDER29:
            self.res.append(EFMResBlock(nres, rf, share_weights))
            self.convs.append(EFMConv(rf * 2 // 3, cf, pre_filters=pf))
        h, w = (s // 32 for s in self.input_hw)
        self.fc1 = nn.Linear(h * w * 174, 1026)
        self.fc1_bn = FlaxBatchNorm(684, eps=1e-5, momentum=0.9)
        self.fc2_drop = Dropout(0.7)
        self.fc2 = nn.Linear(684, num_classes)

    def _named_layers(self):
        layers = [(("group1", "conv"), self.group1.conv)]
        for gi, (res, conv) in enumerate(zip(self.res, self.convs), start=2):
            layers += [((f"group{gi}_res", n), c) for n, c in res.flax_names()]
            layers += [((f"group{gi}_conv", n), c)
                       for n, c in conv.flax_names()]
        return layers + [(("fc1",), self.fc1), (("fc2",), self.fc2)]

    @torch.no_grad()
    def load_flax_params(self, params: dict, batch_stats: dict | None = None):
        """Copy a flax params tree (and ``fc1_bn``'s running mean and
        variance from ``batch_stats``, when given) in."""
        super().load_flax_params(params)
        bn = self.fc1_bn
        bn.weight.copy_(torch.as_tensor(np.asarray(params["fc1_bn"]["scale"],
                                                   np.float32)))
        bn.bias.copy_(torch.as_tensor(np.asarray(params["fc1_bn"]["bias"],
                                                 np.float32)))
        if batch_stats:
            stats = batch_stats["fc1_bn"]
            bn.running_mean.copy_(torch.as_tensor(np.asarray(stats["mean"],
                                                             np.float32)))
            bn.running_var.copy_(torch.as_tensor(np.asarray(stats["var"],
                                                            np.float32)))
        return self

    def flax_params(self) -> dict:
        tree = super().flax_params()
        tree["fc1_bn"] = {"scale": _np32(self.fc1_bn.weight),
                          "bias": _np32(self.fc1_bn.bias)}
        return tree

    def flax_batch_stats(self) -> dict:
        """``fc1_bn``'s running statistics as the flax ``batch_stats``."""
        return {"fc1_bn": {"mean": _np32(self.fc1_bn.running_mean),
                           "var": _np32(self.fc1_bn.running_var)}}

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self.group1(x.to(self.fc1.weight.dtype))
        for res, conv in zip(self.res, self.convs):
            x = _maxpool2(conv(res(x)))
        # a conv route may hand back another dtype: fc1 casts its input
        # to its own, as a flax Dense does
        x = x.reshape(x.shape[0], -1).to(self.fc1.weight.dtype)
        return efm3(self.fc1(x))

    def classify(self, feat: torch.Tensor):
        logits = self.fc2(self.fc2_drop(feat))
        return logits.float(), self.fc1_bn(feat).float()


def _np32(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().float().cpu().numpy())


def build_lightcnn29(num_classes: int, *, input_hw=(128, 128),
                     in_channels: int = 1, share_weights: bool = False,
                     params: dict | None = None,
                     batch_stats: dict | None = None,
                     generator: torch.Generator | None = None,
                     dtype: torch.dtype = torch.float32,
                     device=None) -> LightCNN29:
    """A ready LightCNN29 (see :func:`finish_build`), with ``fc1_bn``'s
    running statistics from ``batch_stats`` when loading ``params``."""
    net = LightCNN29(num_classes, input_hw, in_channels, share_weights)
    kw = {"batch_stats": batch_stats} if params is not None else {}
    return finish_build(net, params=params, generator=generator, dtype=dtype,
                        device=device, **kw)


# -------------------------------------------------------------- LightCNN9

# (name, in, out, kernel) of the convs after conv1; a 2x2 pool follows
# conv2, conv3 and conv5
CONVS9 = [("conv2a", 48, 96, 1), ("conv2", 48, 192, 3),
          ("conv3a", 96, 192, 1), ("conv3", 96, 384, 3),
          ("conv4a", 192, 384, 1), ("conv4", 192, 256, 3),
          ("conv5a", 128, 256, 1), ("conv5", 128, 256, 3)]


def lightcnn9_front_route(h: int, w: int, channels: int = 1, *, cuda: bool,
                          inference: bool, rerouted=()) -> str:
    """Which path LightCNN9's conv1..pool2 takes for a ``[B, h, w,
    channels]`` input: ``"front9"`` (kernel B6) where the JAX package's
    ``front9_chain_pallas`` takes the input (H == W, a multiple of 4), else
    ``"stem2"`` (kernel B4 for conv1..conv2a) where ``stem2_conv_pallas`` /
    ``FusedStem`` take it (H and W even), else ``"plain"``. Only a
    one-channel CUDA input at inference (eval mode, no autograd) goes to a
    kernel; the CPU and training run the plain layers. ``rerouted`` names
    the convs an active conv route takes over (the int8 route takes conv2,
    K = 432): a kernel that fuses one of them is not taken (B6 fuses
    conv2a and conv2, B4 conv2a)."""
    if not (cuda and inference) or channels != 1:
        return "plain"
    if h == w and h % 4 == 0 and not {"conv2a", "conv2"} & set(rerouted):
        return "front9"
    if h % 2 == 0 and w % 2 == 0 and "conv2a" not in rerouted:
        return "stem2"
    return "plain"


class LightCNN9(FlaxLayers):
    """The 9-layer LightCNN (MFM2): ``[B, H, W, C] -> (logits, feat256)``,
    the benchmark model (the LightCNN paper's layers; input 128x128)."""

    feature_dim = 256
    model_name = "lightcnn9"

    def __init__(self, num_classes: int, input_hw=(128, 128),
                 in_channels: int = 1):
        super().__init__()
        self.num_classes = num_classes
        self.input_hw = tuple(input_hw)
        self.in_channels = in_channels
        self.conv1 = FusedStem(96, maxout=2, in_channels=in_channels)
        for name, cin, cout, k in CONVS9:
            setattr(self, name, same_conv(cin, cout, k))
        h, w = (s // 16 for s in self.input_hw)
        self.fc1 = nn.Linear(h * w * 128, 512)
        self.fc2_drop = Dropout(0.7)
        self.fc2 = nn.Linear(256, num_classes)
        self._packed = None   # (key, B6 weights) for the last dtype used

    def _named_layers(self):
        return ([(("conv1",), self.conv1.conv)]
                + [((name,), getattr(self, name)) for name, *_ in CONVS9]
                + [(("fc1",), self.fc1), (("fc2",), self.fc2)])

    def front_params(self) -> dict:
        """conv1, conv2a and conv2 as a flax-layout tree of HWIO views."""
        return {name: {"kernel": hwio_view(conv), "bias": conv.bias}
                for name, conv in (("conv1", self.conv1.conv),
                                   ("conv2a", self.conv2a),
                                   ("conv2", self.conv2))}

    def _front9_weights(self, dtype: torch.dtype) -> dict:
        """B6's packed weights for ``dtype``, packed once and kept until a
        weight changes (new storage or an in-place write)."""
        if torch.compiler.is_compiling():   # packed in the traced program
            return pack_front9_weights(self.front_params(), dtype)
        convs = (self.conv1.conv, self.conv2a, self.conv2)
        key = (dtype,) + tuple((t.data_ptr(), t._version) for c in convs
                               for t in (c.weight, c.bias))
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, pack_front9_weights(self.front_params(),
                                                     dtype))
        return self._packed[1]

    def _front(self, x: torch.Tensor) -> torch.Tensor:
        """conv1..pool2, through B6, B4 or the plain layers."""
        conv_rt = active_conv_route()
        rerouted = () if conv_rt is None else [
            name for name in ("conv2a", "conv2")
            if conv_rt.reroutes(getattr(self, name))]
        route = lightcnn9_front_route(
            x.shape[1], x.shape[2], x.shape[3], cuda=x.is_cuda,
            inference=not self.training and not torch.is_grad_enabled(),
            rerouted=rerouted)
        if route == "front9":
            return front9_chain(x, self.front_params(),
                                self._front9_weights(x.dtype))
        if route == "stem2":
            c1 = self.conv1.conv
            x = stem2_conv(x, hwio_view(c1), c1.bias, hwio_view(self.conv2a),
                           self.conv2a.bias)
        else:
            x = mfm2(conv_nhwc(self.conv1(x), self.conv2a))
        return _maxpool2(mfm2(conv_nhwc(x, self.conv2)))

    def embed(self, x: torch.Tensor) -> torch.Tensor:
        x = self._front(x.to(self.fc1.weight.dtype))
        x = mfm2(conv_nhwc(x, self.conv3a))
        x = _maxpool2(mfm2(conv_nhwc(x, self.conv3)))
        for name in ("conv4a", "conv4", "conv5a", "conv5"):
            x = mfm2(conv_nhwc(x, getattr(self, name)))
        x = _maxpool2(x)
        x = x.reshape(x.shape[0], -1).to(self.fc1.weight.dtype)
        return mfm2(self.fc1(x))

    def classify(self, feat: torch.Tensor):
        logits = self.fc2(self.fc2_drop(feat))
        return logits.float(), feat.float()


def build_lightcnn9(num_classes: int, *, input_hw=(128, 128),
                    in_channels: int = 1, params: dict | None = None,
                    generator: torch.Generator | None = None,
                    dtype: torch.dtype = torch.float32,
                    device=None) -> LightCNN9:
    """A ready LightCNN9 (see :func:`finish_build`)."""
    return finish_build(LightCNN9(num_classes, input_hw, in_channels),
                        params=params, generator=generator, dtype=dtype,
                        device=device)
