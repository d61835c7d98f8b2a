"""Device ms an extraction batch in cuDNN's convolutions."""

from perfbench.core.readings import per_unit_ms


def read(run):
    return per_unit_ms(run, "conv", per_batch=True)
