"""Device idle ms a dispatch while the host runs the program's span
``serve.upload`` (the frames' conversion and copy to the card), from the
idle intervals of the traced stretch split by overlap."""

from perfbench.core.spans import idle_ms


def read(run):
    return idle_ms(run, {"serve.upload"})
