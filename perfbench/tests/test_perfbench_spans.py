"""The readers of the program's own spans and counters on synthetic
traces: idle time split over the spans by overlap, idle time outside
every span, and None from a program that records none of them."""

from types import SimpleNamespace

import pytest

from perfbench.core import cell, spans
from perfbench.core.driver import port
from perfbench.core.trace import Trace


def _run(trace, batches=1):
    return SimpleNamespace(trace=trace, window={"steps": 1, "seconds": 1.0},
                           launches={}, driver=SimpleNamespace(
                               batches_per_step=lambda: batches))


def test_idle_gap_split_over_two_spans_by_overlap():
    # one gap, 10..40 us: serve.upload covers 10..25, serve.stage1 25..40;
    # the gap's middle (25) would hand all of it to one of them
    t = Trace(device=[("k", 0.0, 10.0), ("k", 40.0, 50.0)],
              host=[("serve.upload", 2.0, 25.0),
                    ("serve.stage1", 25.0, 48.0)],
              wall_s=5e-5, steps=1)
    assert spans.idle_intervals(t) == [(10.0, 40.0)]
    assert spans.idle_under_us(t, {"serve.upload"}) == pytest.approx(15.0)
    assert spans.idle_under_us(t, {"serve.stage1"}) == pytest.approx(15.0)
    run = _run(t)
    assert cell.metric_reader("feed_idle_ms.serve")(run) == \
        pytest.approx(0.015)
    assert cell.metric_reader("launch_idle_ms.serve")(run) == \
        pytest.approx(0.015)


def test_idle_outside_every_span_counts_for_none():
    # the stretch opens with 20 us of host work outside any span, then a
    # span over the device's work; the trailing 10 us is under no span
    t = Trace(device=[("k", 20.0, 60.0), ("k", 70.0, 80.0)],
              host=[("aten::slice", 0.0, 18.0), ("train.upload", 18.0, 75.0),
                    ("cudaDeviceSynchronize", 80.0, 90.0)],
              wall_s=9e-5, steps=2)
    assert spans.idle_intervals(t) == [(0.0, 20.0), (60.0, 70.0),
                                       (80.0, 90.0)]
    # 2 us of the first gap and the whole of the second are under the span
    assert spans.idle_under_us(t, {"train.batch", "train.upload"}) == \
        pytest.approx(12.0)
    assert cell.metric_reader("feed_idle_ms.train")(_run(t)) == \
        pytest.approx(0.006)


def test_extract_idle_is_per_batch():
    t = Trace(device=[("k", 0.0, 10.0), ("k", 30.0, 40.0)],
              host=[("extract.slice", 10.0, 20.0),
                    ("extract.upload", 20.0, 30.0)],
              wall_s=4e-5, steps=1)
    assert cell.metric_reader("feed_idle_ms.extract")(_run(t, 4)) == \
        pytest.approx(0.005)


@pytest.mark.parametrize("name", [
    "feed_idle_ms.serve", "launch_idle_ms.serve", "upload_mb.serve",
    "feed_idle_ms.train", "forward_ms.train", "loss_ms.train",
    "backward_ms.train", "optimizer_ms.train", "feed_idle_ms.extract"])
def test_none_from_a_program_without_spans(name, monkeypatch):
    # host events of the program's ops alone, as a program without spans
    # records them, and a program without the span and counter readers
    t = Trace(device=[("k", 0.0, 10.0), ("k", 40.0, 50.0)],
              host=[("aten::to", 12.0, 39.0)], wall_s=5e-5, steps=1)
    profiling = port("utils.profiling")
    monkeypatch.delattr(profiling, "span_device_ms", raising=False)
    monkeypatch.delattr(profiling, "counters", raising=False)
    assert cell.metric_reader(name)(_run(t)) is None


def test_none_where_the_program_recorded_nothing():
    # the program has the readers, but no profiler session recorded a
    # span with timing events or a counter (as on the CPU)
    t = Trace(device=[("k", 0.0, 10.0)], host=[], wall_s=1e-5, steps=1)
    profiling = port("utils.profiling")
    if profiling.span_device_ms() is None:
        assert cell.metric_reader("forward_ms.train")(_run(t)) is None
    assert spans.counter(_run(t), "no.such_counter") is None
