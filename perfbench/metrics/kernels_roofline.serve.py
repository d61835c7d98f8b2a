"""The hand-written kernels' share of their roofline on this cell's path:
the sum of each call's least time (bytes over 3.35 TB/s or operations over
the peak of its precision) over the sum of their traced times."""

from perfbench.core.readings import roofline


def read(run):
    return roofline(run)
