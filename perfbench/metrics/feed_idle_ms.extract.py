"""Device idle ms an extraction batch while the host runs the program's
spans ``extract.slice`` (the rows from the store, padded) and
``extract.upload`` (the batch to the card, scaled), from the idle
intervals of the traced stretch split by overlap."""

from perfbench.core.spans import idle_ms


def read(run):
    return idle_ms(run, {"extract.slice", "extract.upload"}, per_batch=True)
