"""Tracing, profiling and FLOP counts.

Port of the JAX package's ``utils/profiling.py``: ``trace`` records a
``torch.profiler`` trace of the block (host and, where there is one, the
card) as a Chrome trace in ``log_dir``, where the JAX package records an
XLA trace; ``compiled_flops`` counts a call's FLOPs with
``torch.utils.flop_counter.FlopCounterMode``, where the JAX package reads
XLA's cost analysis of the compiled program.

The program's own tracing: ``span(name)`` brackets one layer of a unit of
work (a serving dispatch, a training step, an extraction batch) and
``count(name, n)`` adds to a host counter. Both act only while a
``torch.profiler`` session records (``trace``, or the benchmark's traced
stretch) and outside compile and export tracing; otherwise ``span`` hands
back one shared no-op context after one flag read. A span is a top-level
host range on the profiler's clock, the kernels' clock, that puts nothing
on the device's timeline (``_RecordFunctionFast``, not ``record_function``,
whose range the CUDA profiler copies onto the device as busy time); on a
CUDA device it also records a pair of timing events on the current stream.
The program opens no span inside another, and a unit's spans together
cover every ATen op it issues. A layer inside a span is timed with
``device_span`` (forward) and ``device_span_backward`` (its backward,
from autograd hooks): the timing events alone, no host range, so the
flat spans stay flat. ``span_device_ms`` and ``counters`` read
back what the most recent profiler session recorded: importing this
module wraps torch's profiler-start hook (``_run_on_profiler_start``) so
that each session starts with the records cleared and timing events
ready.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()
# timing events made ready on the current device as each profiler session
# starts, before it records: making one costs tens of microseconds of host
# time, which a span would otherwise spend inside the traced work
_READY_EVENTS = 256


class _Recorder:
    """What the spans and counters of the current profiler session
    recorded: ``(name, device, start event, end event)`` of each span on
    a CUDA device, in the order they closed, and the counters' sums; and
    timing events free for the next spans, by device (a cleared session's
    and those made ready at a session's start)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: list = []
        self.counts: dict = {}
        self.free: dict = {}

    def start_session(self) -> None:
        with self.lock:
            for _, device, start, end in self.spans:
                self.free.setdefault(device, []).extend((start, end))
            self.spans, self.counts = [], {}
        if torch.cuda.is_initialized():
            free = self.free.setdefault(torch.cuda.current_device(), [])
            while len(free) < _READY_EVENTS:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                free.append(ev)

    def event(self, device: int) -> torch.cuda.Event:
        """A timing event of ``device``, recorded now on its current
        stream."""
        free = self.free.get(device)
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def add(self, name: str, n: int) -> None:
        with self.lock:
            self.counts[name] = self.counts.get(name, 0) + int(n)


_RECORDER = _Recorder()


def _watch_sessions() -> None:
    """Start the recorder's session as each profiler session starts (torch
    calls ``_run_on_profiler_start`` then, before it records)."""
    started = getattr(_autograd_profiler, "_run_on_profiler_start", None)
    if started is None:
        return

    def on_start():
        _RECORDER.start_session()
        started()

    _autograd_profiler._run_on_profiler_start = on_start


_watch_sessions()


class _Span:
    __slots__ = ("name", "_range", "_device", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self._start = None
        if torch.cuda.is_initialized():
            self._device = torch.cuda.current_device()
            self._start = _RECORDER.event(self._device)

    def __exit__(self, *exc):
        if self._start is not None:
            _RECORDER.spans.append((self.name, self._device, self._start,
                                    _RECORDER.event(self._device)))
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the block as the span ``name`` while a
    profiler session records; the shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if torch.compiler.is_compiling():
        return _OFF
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add ``n`` (a host integer) to the counter ``name`` while a profiler
    session records."""
    if _autograd_profiler._is_profiler_enabled \
            and not torch.compiler.is_compiling():
        _RECORDER.add(name, n)


def _timing() -> bool:
    """Whether device-only spans record now: a profiler session, no
    compile or export trace, and a CUDA context to record events in."""
    return (_autograd_profiler._is_profiler_enabled
            and not torch.compiler.is_compiling()
            and torch.cuda.is_initialized())


class _DeviceSpan:
    __slots__ = ("name", "_device", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._device = torch.cuda.current_device()
        self._start = _RECORDER.event(self._device)

    def __exit__(self, *exc):
        _RECORDER.spans.append((self.name, self._device, self._start,
                                _RECORDER.event(self._device)))
        return False


def device_span(name: str):
    """The pair of timing events of span ``name`` around the block, with
    no host range, while a profiler session records on a CUDA device; the
    shared no-op context otherwise. For a layer inside a unit's span: the
    unit's flat host spans, and the idle they split, stay as they are."""
    return _DeviceSpan(name) if _timing() else _OFF


def device_span_backward(name: str, out: torch.Tensor,
                         inp: torch.Tensor) -> None:
    """Record the span ``name`` (timing events alone, as ``device_span``)
    over the backward from ``out``'s gradient to ``inp``'s: one event as
    autograd hands ``out`` its gradient, one as it has summed ``inp``'s
    (``inp`` feeding only the layer that made ``out``). Nothing where
    either takes no gradient or ``device_span`` would not record."""
    if not (_timing() and out.requires_grad and inp.requires_grad):
        return
    device = torch.cuda.current_device()
    start = []

    def opened(grad):
        start.append(_RECORDER.event(device))

    def closed(grad):
        if start:
            _RECORDER.spans.append((name, device, start.pop(),
                                    _RECORDER.event(device)))

    out.register_hook(opened)
    inp.register_hook(closed)


def span_device_ms() -> dict[str, list[float]] | None:
    """Each span name's device milliseconds (from its start event to its
    end event on the stream), one entry an occurrence: the i-th is the
    i-th unit of work of the most recent profiler session. Synchronizes
    once; None where no span recorded events (on the CPU)."""
    spans = list(_RECORDER.spans)
    if not spans:
        return None
    torch.cuda.synchronize()
    out: dict[str, list[float]] = {}
    for name, _, start, end in spans:
        out.setdefault(name, []).append(start.elapsed_time(end))
    return out


def counters() -> dict[str, int]:
    """The counters' sums over the most recent profiler session."""
    with _RECORDER.lock:
        return dict(_RECORDER.counts)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where it is
    available) and write ``trace.json`` (open in Perfetto or
    ``chrome://tracing``; the program's spans sit beside the kernels) into
    ``log_dir``. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
