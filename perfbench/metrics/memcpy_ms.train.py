"""Device ms a training step in copies and fills (the batch's upload)."""

from perfbench.core.readings import per_unit_ms


def read(run):
    return per_unit_ms(run, "memcpy")
