"""Stage 1 of MTCNN on the device, batched over frames.

Port of the JAX package's ``detect/device_pnet.py``: for every pyramid
scale, resize the frames (bilinear, antialiased), normalize, run PNet in
the TF-caffe orientation, decode the heatmap to a fixed top-k of
candidates; then the per-scale NMS 0.5 of all scales and frames in one
launch of kernel B5, the cross-scale NMS 0.7 of all frames in another, and
a fixed-capacity top-k of the survivors. The JAX version maps one frame
and is ``vmap``-ed; here the frame axis is written out.

The resize is ``jax.image.resize(..., "linear")``: separable weight
matrices from the antialiased triangle kernel (``compute_weight_mat``, a
port of the private ``jax._src.image.scale.compute_weight_mat``, which the
cascade's crop-resize uses too). The jitted JAX stage folds its scalars
into the program as constants; here every tensor that depends only on the
frame shape and the pyramid scale (the resize matrices) is built once
with the stage, and the per-call work takes Python scalars, which reach a
kernel as launch arguments, so a call makes no host-to-device copy but
the frames' own.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from ..ops.boxes import decode_pnet_topk, nms_mask_batched, stable_topk
from .pipeline import pyramid_scales

_F32_EPS = 1.1920928955078125e-07  # np.finfo(np.float32).eps


def _f32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def compute_weight_mat(input_size: int, output_size: int, scale, translation,
                       device=None) -> torch.Tensor:
    """``[..., input_size, output_size]`` resampling weights of the
    antialiased triangle kernel, JAX's ``compute_weight_mat`` with
    ``_fill_triangle_kernel`` and ``antialias=True``.

    ``scale`` and ``translation`` are float32 tensors of one shape (a batch
    of warps) or Python floats. As in JAX, a Python scale is inverted in
    double precision and rounded once; a tensor scale is inverted in
    float32 (``reciprocal``, an IEEE division like JAX's ``1 / scale``).
    Output columns whose sample lies outside the input get zero weight, so
    out-of-range samples read zeros. A tensor scale creates no scalar
    tensor: its constants enter as Python scalars."""
    if isinstance(scale, torch.Tensor):
        device = scale.device
        inv_scale = torch.reciprocal(scale)
        shift = translation * inv_scale
    else:
        inv_scale = _f32(1.0 / scale, device)
        shift = _f32(translation * (1.0 / scale), device)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    out_i = torch.arange(output_size, dtype=torch.float32, device=device)
    sample_f = ((out_i + 0.5) * inv_scale[..., None] - shift[..., None]
                - 0.5)                                            # [..., out]
    in_i = torch.arange(input_size, dtype=torch.float32, device=device)
    x = (torch.abs(sample_f[..., None, :] - in_i[:, None])
         / kernel_scale[..., None, None])                         # [..., in, out]
    weights = torch.clamp(1.0 - torch.abs(x), min=0.0)
    total = weights.sum(dim=-2, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * _F32_EPS,
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= input_size - 0.5)
    return torch.where(inside[..., None, :], weights, 0.0)


def resize_weights(h: int, w: int, out_h: int, out_w: int, device=None):
    """The ``(wy [h, out_h], wx [w, out_w])`` matrices of
    :func:`resize_linear`; None for an axis whose size does not change."""
    wy = (compute_weight_mat(h, out_h, out_h / h, 0.0, device)
          if out_h != h else None)
    wx = (compute_weight_mat(w, out_w, out_w / w, 0.0, device)
          if out_w != w else None)
    return wy, wx


def resize_linear(images: torch.Tensor, out_h: int, out_w: int,
                  weights=None) -> torch.Tensor:
    """``jax.image.resize(img, (out_h, out_w, C), "linear")`` for a
    ``[F, H, W, C]`` batch. An axis whose size does not change is left
    alone, as in JAX. ``weights`` is :func:`resize_weights`' pair for these
    shapes, built once by a caller that resizes many batches."""
    h, w = images.shape[1], images.shape[2]
    wy, wx = weights if weights is not None else resize_weights(
        h, w, out_h, out_w, images.device)
    out = images
    if wy is not None:
        out = torch.einsum("fhwc,hy->fywc", out, wy)
    if wx is not None:
        out = torch.einsum("fywc,wx->fyxc", out, wx)
    return out


def _pad_rows(cand: torch.Tensor, k: int) -> torch.Tensor:
    """Pad ``[F, n, 9]`` candidates to ``[F, k, 9]`` with zero rows that
    carry a score of -inf."""
    n = cand.shape[1]
    if n >= k:
        return cand
    pad = cand.new_zeros((cand.shape[0], k - n, cand.shape[2]))
    pad[..., 4] = float("-inf")
    return torch.cat([cand, pad], dim=1)


def make_device_stage1(pnet, h: int, w: int, *, minsize: int = 20,
                       factor: float = 0.709, threshold: float = 0.6,
                       k_per_scale: int = 128, out_cap: int = 256,
                       with_counts: bool = False, device=None):
    """Build stage 1 for frames of shape ``[h, w, 3]``.

    Returns ``fn(frames [F, h, w, 3] float32 0-255) -> [F, out_cap, 9]``
    candidates (q1 q2 score reg; invalid rows carry a score of -inf),
    through the per-scale NMS 0.5 and the cross-scale NMS 0.7.
    ``with_counts``: fn also returns ``[F]`` int32 counts of the
    above-threshold cells the ``k_per_scale`` caps dropped."""
    dev = resolve_device(device)
    scales = pyramid_scales(h, w, minsize, factor)
    neg_inf = float("-inf")
    # per scale: its size and resize matrices, built once with the stage
    levels = []
    for scale in scales:
        hs, ws = math.ceil(h * scale), math.ceil(w * scale)
        levels.append((scale, hs, ws, resize_weights(h, w, hs, ws, dev)))

    @torch.inference_mode()
    def stage1(frames: torch.Tensor):
        frames = _f32(frames, dev)
        nf = frames.shape[0]
        per_scale = []
        dropped = torch.zeros((nf,), dtype=torch.int32, device=dev)
        for scale, hs, ws, weights in levels:
            im = resize_linear(frames, hs, ws, weights)
            im = (im - 127.5) * 0.0078125
            # TF-caffe orientation (detect_face.py:308-312)
            prob, reg = pnet(im.transpose(1, 2))
            prob_o = prob.transpose(1, 2)[..., 1]
            reg_o = reg.transpose(1, 2)
            n_above = (prob_o > threshold).sum(dim=(1, 2)).to(torch.int32)
            dropped += torch.clamp(n_above - k_per_scale, min=0)
            cand = decode_pnet_topk(prob_o, reg_o, scale, threshold,
                                    k_per_scale)
            per_scale.append(_pad_rows(cand, k_per_scale))
        stacked = torch.stack(per_scale, dim=1)             # [F, S, k, 9]
        ns = len(scales)
        masks = nms_mask_batched(
            stacked[..., :5].reshape(nf * ns, k_per_scale, 5), 0.5, "Union")
        stacked[..., 4] = torch.where(masks.reshape(nf, ns, k_per_scale),
                                      stacked[..., 4], neg_inf)
        allc = stacked.reshape(nf, ns * k_per_scale, 9)
        mask = nms_mask_batched(allc[..., :5].contiguous(), 0.7, "Union")
        score = torch.where(mask, allc[..., 4], neg_inf)
        kk = min(out_cap, score.shape[1])
        top_s, top_i = stable_topk(score, kk)
        out = torch.gather(allc, 1, top_i[..., None].expand(nf, kk, 9))
        out[..., 4] = top_s
        out = _pad_rows(out, out_cap)
        return (out, dropped) if with_counts else out

    return stage1
