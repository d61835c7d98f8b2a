"""The program's own spans and counters, read for the per-layer metrics
that time a layer where its work happens.

The program (its ``utils/profiling.py``) records each layer of a unit of
work (a dispatch, a training step, an extraction batch) as a top-level
host range on the profiler's clock, so the traced stretch keeps them in
``trace.host``, and on the card a pair of timing events around it, which
its ``span_device_ms`` reads back; its ``counters`` sum what it counted.
Every reader returns None where the program records no such span or
counter (one from before them), and the result line then leaves the
metric out.
"""

from __future__ import annotations

from perfbench.core.driver import port


def _units(run, per_batch: bool) -> int:
    units = run.trace.steps
    if per_batch:
        units *= run.driver.batches_per_step()
    return units


def idle_intervals(trace) -> list:
    """The device's idle intervals ``(start_us, end_us)`` over the traced
    stretch: from the first host or device event's start to the last one's
    end, less the union of the device's operations."""
    events = trace.device + trace.host
    if not events:
        return []
    cur = min(s for _, s, _ in events)
    hi = max(e for _, _, e in events)
    out = []
    for _, s, e in sorted(trace.device, key=lambda r: r[1]):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def idle_under_us(trace, names) -> float | None:
    """Microseconds of the device's idle time that the host spans named
    in ``names`` cover: each idle interval is split by how much of it each
    span overlaps. None where no such span was recorded."""
    spans = [(s, e) for n, s, e in trace.host if n in names]
    if not spans:
        return None
    total = 0.0
    for a, b in idle_intervals(trace):
        for s, e in spans:
            total += max(0.0, min(b, e) - max(a, s))
    return total


def idle_ms(run, names, per_batch: bool = False) -> float | None:
    """Device idle ms a step (or a batch) under the spans ``names``."""
    us = idle_under_us(run.trace, names)
    return None if us is None else us / _units(run, per_batch) * 1e-3


def device_ms(run, name: str, per_batch: bool = False) -> float | None:
    """Device ms a step (or a batch) between the span ``name``'s timing
    events, summed over its occurrences in the traced stretch."""
    read = getattr(port("utils.profiling"), "span_device_ms", None)
    ms = read() if read is not None else None
    if not ms or name not in ms:
        return None
    return sum(ms[name]) / _units(run, per_batch)


def counter(run, name: str, scale: float = 1.0) -> float | None:
    """The program's counter ``name`` a step, times ``scale``."""
    read = getattr(port("utils.profiling"), "counters", None)
    counts = read() if read is not None else None
    if not counts or name not in counts:
        return None
    return counts[name] / run.trace.steps * scale
