"""Device ms a dispatch in kernels of no named family: the cascade's,
crop's and match's elementwise glue."""

from perfbench.core.readings import per_unit_ms
from perfbench.core.trace import GLUE


def read(run):
    return per_unit_ms(run, GLUE)
