"""Device ms a dispatch in copies and fills (the frames' upload, the
readback)."""

from perfbench.core.readings import per_unit_ms


def read(run):
    return per_unit_ms(run, "memcpy")
