#!/usr/bin/env python3
"""Where the time of one serving dispatch goes, on one GPU (PyTorch port).

Sets up the port's multi-stream pipeline through ``serve_demo``'s own
``build_streams`` with ``chip_smoke.py``'s slice arguments (16 streams of
240x320 frames, EFMNet342 on 64x64 crops, random seeded weights,
thresholds 0.3), so it measures the workload the smoke test runs. After a
warm-up it times WINDOWS unprofiled steady windows of at least SECONDS
each, then traces TRACED dispatches with ``torch.profiler``. Prints one
JSON line: frames/s and wall ms per dispatch of each steady window, the
device time of a dispatch's kernels, the
device's idle share (1 - device ms / the steady windows' wall ms per
dispatch, both from this process; the traced window's own share, which the
profiler's overhead inflates, beside it), and device time grouped by
kernel family and by the top kernel names.

    python tools/profile_serving_torch.py

Needs CUDA; TF32 is off as in chip_smoke.py.
"""

import json
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAMILIES = (("nms", "nms_"), ("stem", "stem_kernel"),
            ("efm3", "efm3_kernel"), ("conv", "conv"), ("conv", "cudnn"),
            ("conv", "implicit"), ("conv", "winograd"), ("gemm", "gemm"),
            ("gemm", "sm90_xmma"), ("gemm", "cutlass"), ("sort", "sort"),
            ("sort", "radix"), ("pool", "pool"), ("reduce", "reduce"))
# three steady windows of several seconds each show the spread within one
# process; the traced window is short because the trace grows with it
WINDOWS, SECONDS, TRACED = 3, 5.0, 4


def family(name: str) -> str:
    low = name.lower()
    for fam, key in FAMILIES:
        if key in low:
            return fam
    return "elementwise/other"


def steady_window(torch, pipe, frames, seconds: float) -> tuple[int, float]:
    """Dispatches run back to back for at least ``seconds``, and their wall
    seconds (to the last result on the card)."""
    n = 0
    t0 = time.perf_counter()
    while True:
        pipe(frames)
        n += 1
        if n % 8 == 0:
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if dt >= seconds:
                return n, dt


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_serving_torch: needs CUDA", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import slice_argv
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )

    pipe, frames = serve_demo.build_streams(
        serve_demo.parse_args(slice_argv(64, "cuda")))
    streams = frames.shape[0]
    for _ in range(3):
        pipe(frames)
    torch.cuda.synchronize()
    windows = []
    for _ in range(WINDOWS):
        n, dt = steady_window(torch, pipe, frames, SECONDS)
        windows.append({"dispatches": n, "seconds": dt,
                        "wall_ms_per_dispatch": dt / n * 1e3,
                        "frames_per_s": streams * n / dt})
    steady_ms = (sum(w["seconds"] for w in windows)
                 / sum(w["dispatches"] for w in windows) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRACED):
            pipe(frames)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / TRACED * 1e3
    by_name = defaultdict(float)
    launches = defaultdict(int)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name] += ev.time_range.elapsed_us() / 1e3
            launches[ev.name] += 1
    device_ms = sum(by_name.values()) / TRACED
    fams = defaultdict(float)
    fam_launch = defaultdict(int)
    for name, ms in by_name.items():
        fams[family(name)] += ms / TRACED
        fam_launch[family(name)] += launches[name] // TRACED
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "streams": streams, "frame_hw": list(frames.shape[1:3]),
        "steady_windows": windows,
        "steady_wall_ms_per_dispatch": steady_ms,
        "traced_wall_ms_per_dispatch": traced_ms,
        "device_kernel_ms_per_dispatch": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / steady_ms),
        "device_idle_share_traced": max(0.0, 1.0 - device_ms / traced_ms),
        "kernel_launches_per_dispatch": sum(launches.values())
        // TRACED,
        "by_family_ms": dict(sorted(fams.items(), key=lambda kv: -kv[1])),
        "by_family_launches": dict(fam_launch),
        "top_kernels_ms": {n[:90]: ms / TRACED for n, ms in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
