"""Shared CLI plumbing: logging to timestamped file + stdout (the reference's
per-run logging setup, train_efm.py:171-175), typed config echo.

A copy of the JAX package's ``cli/_common.py``; ``gallery_dtype`` names
torch dtypes. Under a process group of several ranks only rank 0 writes
(``is_writer``): the other ranks' logging goes nowhere and they get no
cosine sink; ``local_batches`` hands a rank its block of each global
batch."""

from __future__ import annotations

import datetime
import functools
import logging
import os
import sys


def is_writer() -> bool:
    """Whether this process writes logs and files: rank 0, or no group."""
    from ..parallel.distributed import process_info

    return process_info()[0] == 0


def setup_logging(out_dir: str | None, name: str) -> logging.Logger:
    """Timestamped file + stdout logging; ``out_dir=None`` = stdout only.
    A rank other than 0 logs nothing."""
    if not is_writer():
        logging.basicConfig(handlers=[logging.NullHandler()], force=True)
        logging.getLogger().setLevel(logging.CRITICAL + 1)
        return logging.getLogger(name)
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H%M%S")
        logging.basicConfig(
            filename=os.path.join(out_dir, f"{name}{stamp}.log"),
            level=logging.INFO,
            force=True,
        )
    else:
        logging.basicConfig(level=logging.INFO, force=True,
                            stream=sys.stdout)
    root = logging.getLogger()
    if out_dir is not None:
        handler = logging.StreamHandler(sys.stdout)
        root.addHandler(handler)
    root.setLevel(logging.INFO)
    return logging.getLogger(name)


def writer_sink(out_dir: str):
    """The run's ``cosine_similarity.csv`` sink on the writing rank, None
    on the others."""
    from ..eval.cosine import CosineSimilaritySink

    if not is_writer():
        return None
    return CosineSimilaritySink(os.path.join(out_dir,
                                             "cosine_similarity.csv"))


def local_batches(batches, mesh, axis: str = "data"):
    """``(anchor, positive, labels)`` global batches -> this rank's block
    of each along ``axis`` of ``mesh`` (the batches unchanged without a
    mesh)."""
    if mesh is None:
        yield from batches
        return
    from ..parallel.mesh import local_block

    for batch in batches:
        yield tuple(local_block(x, mesh, axis) for x in batch)


def log_config(log: logging.Logger, args) -> None:
    log.info("config: %s", {k: v for k, v in sorted(vars(args).items())})
    rev = _revision_info()
    if rev:
        log.info("revision: %s", rev)


@functools.lru_cache(maxsize=1)
def _revision_info() -> str:
    """Best-effort git revision of the running tree — experiment
    provenance, the facenet `store_revision_info` capability
    (facenet.py:522-540). Empty string outside a git checkout; computed
    once per process (two subprocess forks otherwise tax every CLI)."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
        if out.returncode != 0:
            return ""
        rev = out.stdout.strip()
        dirty = subprocess.run(
            ["git", "-C", repo, "status", "--porcelain"],
            capture_output=True, text=True, timeout=5)
        if dirty.returncode == 0 and dirty.stdout.strip():
            rev += "+dirty"
        return rev
    except Exception:
        return ""


# gallery storage dtypes accepted by the serving CLIs (identify
# --device-gallery, serve_demo --dynamic-gallery); the single source for
# argparse choices= so a new dtype lands everywhere at once
GALLERY_DTYPE_NAMES = ("f32", "bf16", "int8")


def gallery_dtype(name: str):
    """CLI dtype name -> torch dtype (torch imported lazily so --help stays
    cheap)."""
    import torch

    return {"f32": torch.float32, "bf16": torch.bfloat16,
            "int8": torch.int8}[name]
