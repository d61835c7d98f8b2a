"""Device ms a training step between the timing events of the program's
span ``train.forward``: the net's forward (cuDNN's convolutions, B2) and
its classifier."""

from perfbench.core.spans import device_ms


def read(run):
    return device_ms(run, "train.forward")
