"""MB a dispatch that the program counts crossing from the host to the
card with the frames (its counter ``serve.upload_bytes``)."""

from perfbench.core.spans import counter


def read(run):
    return counter(run, "serve.upload_bytes", 1e-6)
