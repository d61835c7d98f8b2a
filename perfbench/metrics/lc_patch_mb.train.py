"""MB (1e6 bytes) a training step of the patch matrices the locally
connected layers build and of their gradients: the program's counter
``lc.patch_bytes``."""

from perfbench.core.spans import counter


def read(run):
    return counter(run, "lc.patch_bytes", 1e-6)
