"""Device idle ms a training step while the host runs the program's spans
``train.batch`` (the batcher and the mirror) and ``train.upload`` (the
batch to the card), from the idle intervals of the traced stretch split
by overlap."""

from perfbench.core.spans import idle_ms


def read(run):
    return idle_ms(run, {"train.batch", "train.upload"})
