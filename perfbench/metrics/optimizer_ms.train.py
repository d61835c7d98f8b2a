"""Device ms a training step between the timing events of the program's
span ``train.optimizer``: Adam's update of every parameter."""

from perfbench.core.spans import device_ms


def read(run):
    return device_ms(run, "train.optimizer")
