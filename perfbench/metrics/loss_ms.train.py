"""Device ms a training step between the timing events of the program's
span ``train.loss``: the 55,005-way softmax, B1's semi-hard mining and
the triplet loss."""

from perfbench.core.spans import device_ms


def read(run):
    return device_ms(run, "train.loss")
