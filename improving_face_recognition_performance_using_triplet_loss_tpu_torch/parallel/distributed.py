"""Process groups: one process per rank.

``initialize_distributed`` is the port's twin of the JAX package's: with a
coordinator address it joins ``tcp://<address>`` as ``process_id`` of
``num_processes``; without one it reads ``torch.distributed.run``'s
environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``LOCAL_RANK``);
with neither it returns False and does nothing. ``process_group`` is what
the CLIs enter: it joins the launcher's group, or makes a group of one
(an in-process store, no port) so that the same code runs in one
process, and leaves a group it made when it exits.

The backend is a stated rule, logged for each rank: NCCL when every rank
of a host has a card of its own, gloo when ranks share a card or run on
the CPU (NCCL refuses two ranks on one device). A rank's device is
``cuda:{LOCAL_RANK % device_count}`` unless the caller passes the CPU or
a device with an index.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch
import torch.distributed as dist

from ..device import resolve_device

log = logging.getLogger("facejax.parallel")


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` when it is the CPU or names an
    index, else ``cuda:{LOCAL_RANK % device_count}`` (raising without
    CUDA, as every entry point does)."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> str:
    """``nccl`` when ``device`` is a card and the host's ``local_world``
    ranks each have a card of their own, else ``gloo``."""
    if (device.type == "cuda" and dist.is_nccl_available()
            and local_world <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def _join(backend: str, device: torch.device, **kwargs) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, **kwargs)
    log.info("rank %d of %d: backend %s, device %s", dist.get_rank(),
             dist.get_world_size(), backend, device)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device=None) -> bool:
    """Join a process group when running multi-process; returns True when
    a group exists afterwards, False for the single-process no-op."""
    if dist.is_initialized():
        return True
    explicit = coordinator_address is not None
    env = all(os.environ.get(k) for k in ("RANK", "WORLD_SIZE",
                                          "MASTER_ADDR"))
    if not explicit and not env:
        return False
    dev = rank_device(device)
    if explicit:
        world, rank = int(num_processes), int(process_id)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
        kwargs = {"init_method": f"tcp://{coordinator_address}",
                  "world_size": world, "rank": rank}
    else:
        world = int(os.environ["WORLD_SIZE"])
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        kwargs = {"init_method": "env://"}
    _join(choose_backend(dev, local_world), dev, **kwargs)
    return True


def init_single_process(device=None) -> None:
    """A process group of one over an in-process store (no port, no
    launcher): the group a plain run of a parallel entry point spans."""
    dev = rank_device(device)
    _join(choose_backend(dev, 1), dev, store=dist.HashStore(),
          world_size=1, rank=0)


def ensure_process_group(device=None) -> bool:
    """Join the launcher's group, or make a group of one; returns True
    when this call made the group."""
    if dist.is_initialized():
        return False
    if not initialize_distributed(device=device):
        init_single_process(device)
    return True


@contextlib.contextmanager
def process_group(device=None):
    """``with process_group(device) as (rank, world):`` a group exists
    inside; one made here is destroyed on the way out."""
    made = ensure_process_group(device)
    try:
        yield process_info()
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def process_info() -> tuple[int, int]:
    """``(rank, world_size)``; ``(0, 1)`` when no group exists."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
