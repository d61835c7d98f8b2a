"""The compilation cache: what the port has in its place.

The JAX package's ``utils/cache.py`` points XLA's persistent compilation
cache at a directory so that a new process reloads its compiled programs.
The port compiles no program: PyTorch runs eagerly, and what the port
compiles is its hand-written CUDA kernels, which ``ops/cuda/_build.py``
builds once with ``nvcc`` into ``csrc/_build/`` and every later process
loads from there. That build directory is the port's cache, so
``enable_compilation_cache`` sets nothing and adds no cache; the CLIs that
call it in the JAX package call it here too, as a documented no-op.
"""

from __future__ import annotations


def enable_compilation_cache(directory: str | None = None) -> None:
    """A no-op: the port's compiled artifacts are the kernel libraries in
    ``csrc/_build/`` (``ops/cuda/_build.py``), cached there already.
    ``directory`` is accepted for the JAX signature and ignored."""
    del directory
