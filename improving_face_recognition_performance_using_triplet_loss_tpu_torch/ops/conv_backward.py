"""A conv whose filter gradient is an explicit im2col matmul.

Port of the JAX package's ``ops/conv_backward.py``: ``filter_grad_im2col``
writes a stride-1 conv's dW as

    patches = im2col(x)                   [B*H*W, k^2*Cin]
    dW      = patches^T @ dy              [k^2*Cin, Cout], K = B*H*W

``conv2d_fg_im2col`` is a conv (``torch.autograd.Function``) whose
backward takes dX as the usual conv gradient and dW from that matmul, and
``conv_interceptor_im2col_bwd`` routes every eligible conv of a port net
(stride 1, SAME, an odd square kernel) through it: the backbone train
step's ``bwd_im2col=True``. Layouts are the JAX package's: x and dy NHWC,
kernels HWIO.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.mtcnn import conv_route, plain_conv_nhwc


def _pad(k: int, padding: str) -> int:
    if padding == "VALID":
        return 0
    if padding == "SAME" and k % 2 == 1:
        return k // 2
    raise ValueError(f"padding {padding!r} with k={k}: SAME needs an odd "
                     "kernel (even-k SAME padding is asymmetric)")


def filter_grad_im2col(x: torch.Tensor, dy: torch.Tensor, k: int,
                       padding: str = "SAME",
                       preferred: torch.dtype = torch.float32) -> torch.Tensor:
    """dW ``[k, k, Cin, Cout]`` of a stride-1 ``padding`` conv as an
    explicit im2col matmul. ``x`` ``[B, H, W, Cin]``, ``dy`` ``[B, H', W',
    Cout]``. The patches are channel-major (``[Cin, k, k]``, as
    ``conv_general_dilated_patches`` emits them), so the product reshapes
    to ``(Cin, k, k, Cout)`` and transposes into HWIO. ``preferred`` is
    the accumulation dtype; the result has ``x``'s dtype."""
    cin, cout = x.shape[-1], dy.shape[-1]
    patches = F.unfold(x.permute(0, 3, 1, 2), k, padding=_pad(k, padding))
    m = patches.transpose(1, 2).reshape(-1, cin * k * k)   # [B*L, Cin*k*k]
    g = dy.reshape(-1, cout)
    dw = m.to(preferred).T @ g.to(preferred)
    return dw.reshape(cin, k, k, cout).permute(1, 2, 0, 3).to(x.dtype)


def input_grad(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dX of a stride-1 SAME conv with an odd square HWIO kernel ``w``:
    the usual conv gradient (``torch.nn.grad.conv2d_input``), NHWC, in
    ``dy``'s dtype."""
    k = w.shape[0]
    if k % 2 != 1 or w.shape[1] != k:
        raise ValueError(
            f"input_grad supports odd square kernels only, got "
            f"{tuple(w.shape[:2])} (even-k SAME padding is asymmetric)")
    b, h, wd, _ = dy.shape
    dx = torch.nn.grad.conv2d_input(
        (b, w.shape[2], h, wd), w.permute(3, 2, 0, 1).to(dy.dtype),
        dy.permute(0, 3, 1, 2), padding=k // 2)
    return dx.permute(0, 2, 3, 1)


class _ConvFgIm2col(torch.autograd.Function):
    """Stride-1 SAME conv, x NHWC and w HWIO; the backward's dW is
    :func:`filter_grad_im2col`."""

    @staticmethod
    def forward(ctx, x, w):
        k = w.shape[0]
        y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=k // 2).permute(0, 2, 3, 1)
        ctx.save_for_backward(x, w)
        ctx.compute_dtype = y.dtype     # autocast's, when it is on
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dt = ctx.compute_dtype
        g = g.to(dt)
        dx = input_grad(g, w.to(dt)).to(x.dtype)
        dw = filter_grad_im2col(x.to(dt), g, w.shape[0]).to(w.dtype)
        return dx, dw


def conv2d_fg_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv of ``x`` ``[B, H, W, Cin]`` by the odd square
    HWIO kernel ``w``, whose backward filter gradient runs the im2col
    matmul (forward and input gradient unchanged)."""
    return _ConvFgIm2col.apply(x, w)


class Im2colBwdRoute:
    """The conv route of :func:`conv_interceptor_im2col_bwd`: an eligible
    ``nn.Conv2d`` (an odd square kernel, stride 1, SAME padding, unit
    dilation, one group) runs :func:`conv2d_fg_im2col` plus its bias, in
    the conv's output dtype; any other runs as it is."""

    def reroutes(self, conv: nn.Conv2d) -> bool:
        kh, kw = conv.kernel_size
        return (kh == kw and kh % 2 == 1 and tuple(conv.stride) == (1, 1)
                and tuple(conv.padding) == (kh // 2, kw // 2)
                and tuple(conv.dilation) == (1, 1) and conv.groups == 1
                and conv.padding_mode == "zeros")

    def __call__(self, x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-1] != conv.in_channels \
                or not self.reroutes(conv):
            return plain_conv_nhwc(x, conv)
        y = conv2d_fg_im2col(x, conv.weight.permute(2, 3, 1, 0))
        return y if conv.bias is None else (y + conv.bias).to(y.dtype)


def conv_interceptor_im2col_bwd():
    """A context in which every eligible conv of the port's nets takes the
    im2col filter gradient (:class:`Im2colBwdRoute`): the twin of the JAX
    package's flax interceptor of the same name."""
    return conv_route(Im2colBwdRoute())
