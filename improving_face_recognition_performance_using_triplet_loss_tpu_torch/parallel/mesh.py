"""``DeviceMesh`` layouts and each rank's block of a global batch.

Twin of the JAX package's ``parallel/mesh.py``. A JAX ``Mesh`` maps onto a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``:
``mesh.shape[axis]`` is :func:`axis_size`, ``lax.axis_index`` is
:func:`axis_index` (``mesh.get_local_rank``) and an axis's collectives run
over :func:`axis_group` (``mesh.get_group``). Ranks fill a mesh in row-major
order, so a 2-D ``(data, model)`` mesh puts the model ranks of one data
group next to each other.

The JAX shardings become what a rank holds: :func:`data_sharding` gives
the function that slices this rank's block of a global batch
(:func:`local_block`, rows in rank order), :func:`replicated_sharding`
the identity. With no process group the helpers make a group of one
(``distributed.ensure_process_group``), so the same code runs in one
process. Meshes of gloo groups are ``cpu`` meshes (gloo collectives of
card tensors go through the host, ``collectives``), NCCL meshes ``cuda``.

A step built with an ``axis_name`` finds its groups in the mesh the
``shard_map_*`` wrapper binds around the call (:func:`bind_mesh`,
:func:`bound_axis`), as a JAX step finds them in ``shard_map``'s.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .distributed import ensure_process_group

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _mesh(shape: tuple[int, ...], names: tuple[str, ...],
          device=None) -> DeviceMesh:
    ensure_process_group(device)
    world = dist.get_world_size()
    layout = torch.arange(world).reshape(shape)
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, layout, mesh_dim_names=names)


def make_mesh(axis_name: str = DATA_AXIS, *, device=None) -> DeviceMesh:
    """1-D data-parallel mesh over every rank."""
    ensure_process_group(device)
    return _mesh((dist.get_world_size(),), (axis_name,), device)


def make_multislice_mesh(ici_size: int | None = None, dcn_axis: str = "dcn",
                         ici_axis: str = DATA_AXIS, *,
                         device=None) -> DeviceMesh:
    """2-D mesh: an outer axis across hosts x an inner axis within one
    (``ici_size`` ranks, the launcher's ranks per host by default); one
    host gives ``(1, n)``."""
    ensure_process_group(device)
    n = dist.get_world_size()
    if ici_size is None:
        ici_size = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % ici_size:
        raise ValueError(f"{n} devices do not split into ICI groups of "
                         f"{ici_size}")
    return _mesh((n // ici_size, ici_size), (dcn_axis, ici_axis), device)


def make_2d_mesh(model_size: int, data_axis: str = DATA_AXIS,
                 model_axis: str = MODEL_AXIS, *, device=None) -> DeviceMesh:
    """2-D ``(data, model)`` mesh: the batch over ``data``, the
    class-parallel softmax over ``model``."""
    ensure_process_group(device)
    n = dist.get_world_size()
    if n % model_size:
        raise ValueError(f"{n} devices do not split into model groups of "
                         f"{model_size}")
    return _mesh((n // model_size, model_size), (data_axis, model_axis),
                 device)


def _flat(mesh: DeviceMesh) -> tuple[int, int]:
    """``(index, size)`` of this rank in the flattened mesh."""
    ranks = mesh.mesh.flatten().tolist()
    return ranks.index(dist.get_rank()), len(ranks)


def axis_size(mesh: DeviceMesh, axis: str | None) -> int:
    """Ranks along ``axis`` (``None``: the flattened mesh)."""
    return _flat(mesh)[1] if axis is None else mesh.size(
        mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str | None) -> int:
    """This rank's position along ``axis`` (``None``: in the flattened
    mesh)."""
    return _flat(mesh)[0] if axis is None else mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str | None):
    """The process group of this rank's ``axis`` (``None``: the whole
    mesh, which must span the world)."""
    if axis is None:
        if _flat(mesh)[1] != dist.get_world_size():
            raise ValueError("a flattened mesh axis must span every rank")
        return dist.group.WORLD
    return mesh.get_group(axis)


def local_block(x, mesh: DeviceMesh, axis: str | None = DATA_AXIS):
    """Rows ``[i * n / k, (i + 1) * n / k)`` of ``x`` (numpy or a
    tensor): this rank's block along ``axis`` of size ``k``."""
    k, i = axis_size(mesh, axis), axis_index(mesh, axis)
    n = x.shape[0]
    if n % k:
        raise ValueError(f"{n} rows do not split over the {k} ranks of "
                         f"mesh axis {axis!r}")
    return x[i * (n // k):(i + 1) * (n // k)]


def data_sharding(mesh: DeviceMesh, axis_name: str = DATA_AXIS):
    """Batch-dim sharding: a function from a global batch to this rank's
    block of it."""
    return functools.partial(local_block, mesh=mesh, axis=axis_name)


def replicated_sharding(mesh: DeviceMesh):
    """Fully replicated: every rank holds the whole array."""
    del mesh
    return lambda x: x


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as a bound step sees it."""

    group: object
    size: int
    index: int


_BOUND: contextvars.ContextVar = contextvars.ContextVar("facejax_mesh",
                                                        default=None)


@contextlib.contextmanager
def bind_mesh(mesh: DeviceMesh):
    """Make ``mesh`` the one :func:`bound_axis` reads inside."""
    token = _BOUND.set(mesh)
    try:
        yield mesh
    finally:
        _BOUND.reset(token)


def bound_axis(axis_name: str | None) -> Axis | None:
    """``axis_name`` of the bound mesh (None for no axis); a step built
    with an axis raises when called outside its ``shard_map_*``
    wrapper."""
    if axis_name is None:
        return None
    mesh = _BOUND.get()
    if mesh is None:
        raise RuntimeError(
            f"a step built with axis {axis_name!r} runs inside its "
            "shard_map_* wrapper, which binds the mesh")
    return Axis(axis_group(mesh, axis_name), axis_size(mesh, axis_name),
                axis_index(mesh, axis_name))

