"""Device ms a training step in cuDNN's convolutions (fprop, dgrad,
wgrad)."""

from perfbench.core.readings import per_unit_ms


def read(run):
    return per_unit_ms(run, "conv")
