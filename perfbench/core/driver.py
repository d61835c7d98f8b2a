"""What every traffic driver shares: the program's package, its launch
counters, the card's description, and the numbers a check compares.

A driver (``traffic/<kind>.py``) builds the program through its own entry
points in ``setup``, runs one unit of work per ``step`` (a dispatch, a
training step, an extraction call) with its results on the host, reports
the window's end-to-end numbers in ``window_stats``, frees the program in
``close`` and holds what the timed path produced to the plain reference in
``check``. ``fault`` breaks the timed path on purpose, for the tests that
show each check can fail.
"""

from __future__ import annotations

import contextlib
import importlib
import subprocess

PORT = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"
# the program's launch counters (ops/cuda/*.py), by kernel
COUNTERS = {"nms": ("nms", "launches"), "stem": ("stem", "launches"),
            "efm3": ("efm3", "launches"), "efm3_bwd": ("efm3", "bwd_launches"),
            "mining": ("mining", "launches")}


def port(module: str):
    """A module of the program's package."""
    return importlib.import_module(f"{PORT}.{module}")


@contextlib.contextmanager
def tf32(torch):
    """Float32 convolutions and products in TF32 (the control's precision,
    the nearest below the configurations' float32)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def check(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


def power_limit_w() -> float | None:
    """The card's power limit, from ``nvidia-smi`` (None where it cannot
    be read)."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=False)
        return float(res.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


class Base:
    attempted = 0
    failed = 0

    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 fault: str | None = None):
        import torch

        self.torch = torch
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.fault = fault
        self.limits = traffic["limits"]

    def batches_per_step(self) -> int:
        """Batches of the configuration's call shapes in one step."""
        return 1

    def check_steps(self) -> int:
        """Steps the window has to take before the check finds all it
        compares."""
        return 1

    def full_f32(self) -> None:
        port("device").full_f32()

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def launch_counts(self) -> dict:
        out = {}
        for k, (mod, attr) in COUNTERS.items():
            out[k] = getattr(port(f"ops.cuda.{mod}"), attr).count
        return out

    def device_info(self, peak: int) -> dict:
        torch = self.torch
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}

    def free(self, *names: str) -> None:
        for n in names:
            if hasattr(self, n):
                delattr(self, n)
        import gc
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()
