"""Utilities of the port: the reader and writer of MXNet ``.params``
checkpoints and their mapping onto the flax-layout trees of the export
(``mxnet_import``, a numpy copy of the JAX package's module), tracing
(``profiling``: the program's spans and counters, ``span`` and ``count``,
read back by ``span_device_ms`` and ``counters``; ``trace``, a Chrome
trace of a block) and FLOP counts, and ``enable_compilation_cache``
(``cache``, a no-op: the kernel build directory is the port's cache)."""

from .cache import enable_compilation_cache  # noqa: F401
from .profiling import compiled_flops  # noqa: F401
