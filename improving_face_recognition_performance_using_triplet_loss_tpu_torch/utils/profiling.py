"""Tracing and profiling helpers.

Port of the JAX package's ``utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace of the block (host and, where there is one, the
card) as a Chrome trace in ``log_dir``, where the JAX package records an
XLA trace; ``StepTimer`` and ``MetricsWriter`` are the same host-side
recorders (the same JSONL); ``compiled_flops`` counts a call's FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, where the JAX package reads
XLA's cost analysis of the compiled program.
"""

from __future__ import annotations

import contextlib
import json
import os
import time


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where it is
    available) and write ``trace.json`` (open in Perfetto or
    ``chrome://tracing``) into ``log_dir``. Yields ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """images/sec + step-time accounting (Speedometer equivalent,
    mutli_gpu_v3.py:162)."""

    def __init__(self, batch_size: int, report_every: int = 100, log=None):
        self.batch_size = batch_size
        self.report_every = report_every
        self.log = log
        self._count = 0
        self._tic = time.perf_counter()
        self.last_rate = 0.0

    def step(self) -> float | None:
        self._count += 1
        if self._count % self.report_every == 0:
            dt = time.perf_counter() - self._tic
            self.last_rate = self.report_every * self.batch_size / dt
            self._tic = time.perf_counter()
            if self.log is not None:
                self.log.info("speed: %.1f samples/sec", self.last_rate)
            return self.last_rate
        return None


class MetricsWriter:
    """Append-only JSONL metrics sink."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    def write(self, **fields) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")

    def read_all(self) -> list[dict]:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(l) for l in f if l.strip()]


def compiled_flops(fn, *example_args) -> float | None:
    """Total FLOPs of ``fn(*example_args)``, counted by running it once
    under ``torch.utils.flop_counter.FlopCounterMode``.

    The counter sums the ATen operators it has formulas for (matrix
    products, convolutions, attention; two FLOPs a multiply-add) and
    counts no elementwise op, reduction or hand-written kernel launched
    through ctypes; XLA's cost analysis, which the JAX package reads,
    counts every HLO op. So the two agree on a matmul- or conv-bound
    function and this count is the lower of the two elsewhere. Returns
    None when the call counts no FLOP or fails."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*example_args)
    except Exception:
        return None
    flops = float(counter.get_total_flops())
    return flops if flops > 0 else None
