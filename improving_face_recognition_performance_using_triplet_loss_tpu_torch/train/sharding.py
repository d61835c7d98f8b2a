"""The class-parallel layout of a train state.

Under ``--class-parallel M`` each rank of a model group holds its block of
the ``fc2`` classes: rows ``[i * C / M, (i + 1) * C / M)`` of the torch
``Linear``'s weight and bias (the JAX package shards the flax kernel's
last dim, the same classes), with the optimizer's moments and the EMA of
those parameters sharded alike. Every rank builds the whole model from
the seed and keeps its block (:func:`shard_model_`), so the layout starts
from the world-1 init.

:class:`ClassShards` moves a state between the layouts: a checkpoint
holds the whole ``fc2`` and its moments gathered over the model group
(rank 0 writes one file), and resume slices it again, so a resumed run is
bit-equal to an uninterrupted one at the same layout; an export holds the
whole ``fc2`` (:meth:`ClassShards.full_model`), in the flax layout the
JAX package loads.
"""

from __future__ import annotations

import copy

import torch

from ..parallel.collectives import gather_rows
from ..parallel.mesh import axis_group, axis_index, axis_size


def _block(t: torch.Tensor, index: int, parts: int) -> torch.Tensor:
    n = t.shape[0]
    if n % parts:
        raise ValueError(f"{n} classes do not split into {parts} blocks")
    return t[index * (n // parts):(index + 1) * (n // parts)]


class ClassShards:
    """The sharded parameters ``specs`` (``{name: model_axis}``, from
    ``train.steps.infer_class_parallel_specs``) of a model on ``mesh``."""

    def __init__(self, specs: dict[str, str], mesh):
        self.specs = dict(specs)
        self.mesh = mesh

    def _axis(self, name: str):
        axis = self.specs[name]
        return (axis_index(self.mesh, axis), axis_size(self.mesh, axis),
                axis_group(self.mesh, axis))

    @torch.no_grad()
    def shard_model_(self, model: torch.nn.Module) -> torch.nn.Module:
        """Keep this rank's block of each sharded parameter, in place
        (``fc2.out_features`` and ``model.num_classes`` become the local
        class count)."""
        for name, p in list(model.named_parameters()):
            if name in self.specs:
                index, parts, _ = self._axis(name)
                owner, attr = _owner(model, name)
                setattr(owner, attr, torch.nn.Parameter(
                    _block(p.detach(), index, parts).clone()))
                if isinstance(owner, torch.nn.Linear):
                    owner.out_features = owner.weight.shape[0]
                    if hasattr(model, "num_classes"):
                        model.num_classes = owner.out_features
        return model

    def _gather(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return gather_rows(t, self._axis(name)[2])

    def _indices(self, model) -> dict[int, str]:
        return {i: n for i, (n, _) in enumerate(model.named_parameters())
                if n in self.specs}

    @torch.no_grad()
    def full_model(self, model: torch.nn.Module) -> torch.nn.Module:
        """A copy of ``model`` with every sharded parameter gathered whole
        (a collective: every rank of the mesh calls it)."""
        whole = copy.deepcopy(model)
        for name, p in list(whole.named_parameters()):
            if name in self.specs:
                owner, attr = _owner(whole, name)
                setattr(owner, attr,
                        torch.nn.Parameter(self._gather(name, p.detach())))
                if isinstance(owner, torch.nn.Linear):
                    owner.out_features = owner.weight.shape[0]
                    if hasattr(whole, "num_classes"):
                        whole.num_classes = owner.out_features
        return whole

    def _map_opt(self, opt_state: dict, model, fn) -> dict:
        """The optimizer state dict with ``fn(name, tensor)`` applied to
        every per-element moment of a sharded parameter."""
        out = copy.copy(opt_state)
        out["state"] = dict(opt_state["state"])
        for i, name in self._indices(model).items():
            if i not in out["state"]:
                continue
            out["state"][i] = {
                k: (fn(name, v) if isinstance(v, torch.Tensor) and v.ndim
                    else v) for k, v in out["state"][i].items()}
        return out

    @torch.no_grad()
    def gather_blob(self, blob: dict, model) -> dict:
        """A checkpoint blob of this rank's state -> the whole one."""
        out = dict(blob)
        out["model"] = {k: (self._gather(k, v) if k in self.specs else v)
                        for k, v in blob["model"].items()}
        out["optimizer"] = self._map_opt(blob["optimizer"], model,
                                         self._gather)
        if blob.get("ema") is not None:
            out["ema"] = {k: (self._gather(k, v) if k in self.specs else v)
                          for k, v in blob["ema"].items()}
        return out

    @torch.no_grad()
    def local_blob(self, blob: dict, model) -> dict:
        """A whole checkpoint blob -> this rank's blocks of it."""

        def cut(name, t):
            index, parts, _ = self._axis(name)
            return _block(t, index, parts).clone()

        out = dict(blob)
        out["model"] = {k: (cut(k, v) if k in self.specs else v)
                        for k, v in blob["model"].items()}
        out["optimizer"] = self._map_opt(blob["optimizer"], model, cut)
        if blob.get("ema") is not None:
            out["ema"] = {k: (cut(k, v) if k in self.specs else v)
                          for k, v in blob["ema"].items()}
        return out


def _owner(model: torch.nn.Module, name: str):
    *path, attr = name.split(".")
    owner = model
    for part in path:
        owner = getattr(owner, part)
    return owner, attr
