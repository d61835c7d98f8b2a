"""Weights of a configuration, made from the seed on the device.

A net's parameters are listed as ``(key, shape, kind, fan_in)`` entries
(``specs`` of each reference module); the keys are the state-dict keys of
the program's modules, so the same tensors load into the program
(``load_state_dict``) and feed the reference. Every random entry is cut
from one ``randn`` call on one generator, so a seed gives the same weights
on every run and set-up makes them in a single launch.

Kinds: ``w`` a conv or dense kernel ~ N(0, gain^2 / fan_in); ``b`` a bias
~ N(0, 0.01^2) (not zero, so a dropped bias shows); ``alpha`` a PReLU
slope 0.25 + N(0, 0.05^2); ``bn_w`` / ``bn_b`` a BatchNorm scale and shift
(1 + N(0, 0.1^2), N(0, 0.1^2)); ``zeros`` / ``ones`` constant buffers.
"""

from __future__ import annotations

import math

import torch

_RANDOM = {"w", "b", "alpha", "bn_w", "bn_b"}


def make(specs, seed: int, device,
         gain: float = 1.0) -> dict[str, torch.Tensor]:
    """``{key: tensor}`` for ``specs``, drawn from ``seed`` on ``device``
    in float32; kernels are scaled by ``gain``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) * 1_000_003 % (1 << 63))
    total = sum(math.prod(s) for _, s, k, _ in specs if k in _RANDOM)
    flat = torch.randn(total, generator=gen, device=dev)
    out, at = {}, 0
    for key, shape, kind, fan_in in specs:
        n = math.prod(shape)
        if kind == "zeros":
            out[key] = torch.zeros(shape, device=dev)
            continue
        if kind == "ones":
            out[key] = torch.ones(shape, device=dev)
            continue
        z = flat[at:at + n].view(shape)
        at += n
        if kind == "w":
            out[key] = z * (gain / math.sqrt(fan_in))
        elif kind == "b":
            out[key] = z * 0.01
        elif kind == "alpha":
            out[key] = 0.25 + 0.05 * z
        elif kind == "bn_w":
            out[key] = 1.0 + 0.1 * z
        else:
            out[key] = 0.1 * z
    return out


def conv_spec(key: str, cin: int, cout: int, k: int):
    """A conv's kernel (OIHW) and bias entries."""
    return [(f"{key}.weight", (cout, cin, k, k), "w", cin * k * k),
            (f"{key}.bias", (cout,), "b", 0)]


def dense_spec(key: str, cin: int, cout: int):
    """A dense layer's ``[out, in]`` kernel and bias entries."""
    return [(f"{key}.weight", (cout, cin), "w", cin),
            (f"{key}.bias", (cout,), "b", 0)]


def res_spec(key: str, blocks: int, filters: int):
    """An EFM residual chain of ``blocks`` conv pairs at ``filters``."""
    out_ch = filters * 2 // 3
    specs = []
    for i in range(blocks):
        specs += conv_spec(f"{key}.conv_a.{i}", out_ch * 2 // 3, filters, 3)
    for i in range(blocks):
        specs += conv_spec(f"{key}.conv_b.{i}", filters * 2 // 3, out_ch, 3)
    return specs


def load_into(module: torch.nn.Module, weights: dict[str, torch.Tensor],
              prefix: str = "") -> None:
    """Copy the ``prefix``-keyed entries into ``module``'s state; every
    key of the module has to be there with its shape."""
    own = {k[len(prefix):]: v for k, v in weights.items()
           if k.startswith(prefix)}
    state = module.state_dict()
    missing = sorted(set(state) - set(own))
    extra = sorted(set(own) - set(state))
    if missing or extra:
        raise ValueError(f"weights do not fit the module: missing {missing[:4]}"
                         f", unexpected {extra[:4]}")
    with torch.no_grad():
        for k, t in state.items():
            if tuple(t.shape) != tuple(own[k].shape):
                raise ValueError(f"{prefix}{k}: module {tuple(t.shape)}, "
                                 f"weights {tuple(own[k].shape)}")
            t.copy_(own[k])
