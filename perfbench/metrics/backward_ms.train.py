"""Device ms a training step between the timing events of the program's
span ``train.backward``: the backward (cuDNN's dgrad and wgrad,
efm3_bwd)."""

from perfbench.core.spans import device_ms


def read(run):
    return device_ms(run, "train.backward")
