"""Device ms a training step in the locally connected layers L4-L6,
forward and backward together: the sum of the program's device span
``lc`` (timing events around each LC layer's forward and over its
backward, from the output's gradient to the input's)."""

from perfbench.core.spans import device_ms


def read(run):
    return device_ms(run, "lc")
