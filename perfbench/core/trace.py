"""What a profiled stretch of the window ran on the device.

``profile_stretch`` runs a few steps under ``torch.profiler`` and keeps
the device's operations (kernels, copies, fills) as intervals and the
host's top-level operations beside them. Busy time is the union of the
device intervals on the stretch's own timeline, so operations that
overlap on two streams count once; the idle share is one minus that union
over the stretch's wall time.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

# kernel name pattern -> family, first match wins (the profiling tools'
# families, with copies and cuDNN's fprop / dgrad / wgrad and FFT
# convolution kernels named)
FAMILIES = (("memcpy", "memcpy"), ("memcpy", "memset"),
            ("nms", "nms_"), ("stem", "stem_kernel"),
            ("efm3", "efm3_kernel"), ("efm3_bwd", "efm3_bwd_kernel"),
            ("mining", "mining_"),
            ("conv", "conv"), ("conv", "cudnn"), ("conv", "implicit"),
            ("conv", "winograd"), ("conv", "fprop"), ("conv", "dgrad"),
            ("conv", "wgrad"), ("conv", "fft"), ("conv", "cf32"),
            ("conv", "_complex"), ("conv", "region_transform"),
            ("gemm", "gemm"), ("gemm", "sm90_xmma"),
            ("gemm", "cutlass"), ("sort", "sort"), ("sort", "radix"),
            ("pool", "pool"), ("reduce", "reduce"))
GLUE = "elementwise/other"


def family(name: str) -> str:
    low = name.lower()
    for fam, key in FAMILIES:
        if key in low:
            return fam
    return GLUE


@dataclasses.dataclass
class Trace:
    """Device intervals ``(name, start_us, end_us)``, host top-level
    operations ``(name, start_us, end_us)``, the stretch's wall seconds
    and its step count."""
    device: list
    host: list
    wall_s: float
    steps: int

    def busy_s(self) -> float:
        """Seconds in which any device operation ran."""
        total, end = 0.0, None
        for _, s, e in sorted(self.device, key=lambda r: r[1]):
            if end is None or s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total * 1e-6

    def family_s(self) -> dict:
        out: dict = defaultdict(float)
        for name, s, e in self.device:
            out[family(name)] += (e - s) * 1e-6
        return dict(out)

    def matching_s(self, pattern: str) -> float:
        return sum(e - s for n, s, e in self.device if pattern in n) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        by: dict = defaultdict(float)
        for name, s, e in self.device:
            by[name[:120]] += (e - s) * 1e-6
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle gaps between its first and last operation,
        summed by the host operation running at each gap's middle (or
        ``host (untraced)``); the ``k`` largest."""
        iv = sorted(self.device, key=lambda r: r[1])
        host = sorted(self.host, key=lambda r: r[1])
        by: dict = defaultdict(float)
        end = None
        for _, s, e in iv:
            if end is not None and s > end:
                mid = (s + end) / 2
                name = "host (untraced)"
                for hn, hs, he in host:
                    if hs > mid:
                        break
                    if he >= mid:
                        name = hn
                by[name[:120]] += (s - end) * 1e-6
            end = e if end is None else max(end, e)
        return sorted(([n, v] for n, v in by.items()),
                      key=lambda r: -r[1])[:k]


def profile_stretch(torch, step, steps: int) -> Trace:
    """Run ``step()`` ``steps`` times under the profiler (the device idle
    and synchronized before) and return what ran."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.events():
        r = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device.append((ev.name, float(r.start), float(r.end)))
        elif ev.cpu_parent is None:
            host.append((ev.name, float(r.start), float(r.end)))
    return Trace(device=device, host=host, wall_s=wall, steps=steps)
