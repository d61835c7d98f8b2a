"""Device ms an extraction batch in copies and fills (the batch's upload,
the features' readback)."""

from perfbench.core.readings import per_unit_ms


def read(run):
    return per_unit_ms(run, "memcpy", per_batch=True)
