"""Shared CLI plumbing: logging to timestamped file + stdout (the reference's
per-run logging setup, train_efm.py:171-175), typed config echo.

A copy of ``setup_logging`` and ``log_config`` from the JAX package's
``cli/_common.py`` (its ``gallery_dtype`` imports JAX and is not copied)."""

from __future__ import annotations

import datetime
import functools
import logging
import os
import sys


def setup_logging(out_dir: str | None, name: str) -> logging.Logger:
    """Timestamped file + stdout logging; ``out_dir=None`` = stdout only."""
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
