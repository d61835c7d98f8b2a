"""Device idle ms a dispatch while the host runs the program's spans
from ``serve.stage1`` to ``serve.match`` (issuing the cascade, the crop,
the embedding and the match), from the idle intervals of the traced
stretch split by overlap."""

from perfbench.core.spans import idle_ms

SPANS = {"serve.stage1", "serve.stage2", "serve.stage3", "serve.crop",
         "serve.embed", "serve.match"}


def read(run):
    return idle_ms(run, SPANS)
