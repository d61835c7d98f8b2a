"""Model FLOPs (convolutions and dense layers, 2 per multiply-add, from
the configuration's shapes) over the unprofiled window's wall time, as a
percent of 67 TFLOP/s, the H100's float32 peak outside the tensor cores."""

from perfbench.core.readings import mfu


def read(run):
    return mfu(run)
