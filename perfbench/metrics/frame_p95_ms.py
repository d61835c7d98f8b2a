"""The 95th percentile of every frame's latency over the unprofiled
window, in ms: from the dispatch's hand-over of its frames to its results
on the host (the benchmark's clock)."""


def read(run):
    return run.driver.window_p95_ms
