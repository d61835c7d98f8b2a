"""Mean host ms from a dispatch's call to its return, before the
readback, over the unprofiled window (the benchmark's clock)."""


def read(run):
    return run.driver.window_enqueue_ms
