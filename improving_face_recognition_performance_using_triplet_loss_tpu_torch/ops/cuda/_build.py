"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded through ``ctypes``. The
library lands in ``csrc/_build/`` (listed in ``.gitignore``) under a name
that carries a hash of the source and flags, so an edited source rebuilds
and an unchanged one loads at once. Nothing here runs at import time:
:func:`load` builds on first use, and :func:`build_all` starts one ``nvcc``
per source, all at once, for a caller that wants every kernel up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")

_COMMON = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# --fmad=false on NMS: an FMA-contracted `area_i + area_j - inter` moves
# IoUs that sit on the threshold across it, and the keep mask must be exact
FLAGS = {"nms": ["--fmad=false"], "stem": [], "mining": [], "front9": [],
         "front9_tc": [], "efm3": []}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> str:
    """The library path of ``csrc/<name>.cu``, keyed by source and flags."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join(_COMMON + FLAGS[name]).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def _start(name: str):
    so = _target(name)
    if os.path.exists(so):
        return so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    # nvcc writes a temporary name that is renamed once the build is whole,
    # so a cut build never leaves a library that looks finished
    cmd = [_nvcc(), *_COMMON, *FLAGS[name], "-o", so + ".tmp",
           os.path.join(CSRC, f"{name}.cu")]
    log = open(so + ".log", "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return so, (proc, log)


def _finish(name: str, so: str, job) -> None:
    if job is None:
        return
    proc, log = job
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(so + ".log") as f:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{f.read()}")
    os.replace(so + ".tmp", so)


def build_all() -> None:
    """Compile every kernel source that is not built yet, one ``nvcc`` per
    source, all started together."""
    with _lock:
        jobs = {name: _start(name) for name in FLAGS}
        for name, (so, job) in jobs.items():
            _finish(name, so, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            so, job = _start(name)
            _finish(name, so, job)
            _libs[name] = ctypes.CDLL(so)
        return _libs[name]


def ptxas_report(name: str) -> str:
    """What ``nvcc -Xptxas -v`` said about the built library (registers,
    shared memory, spills), or '' when it was already built."""
    so = _target(name)
    try:
        with open(so + ".log") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` code returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


class LaunchCount:
    """How many times a wrapper launched its kernel since the last reset.
    Only the launch site adds to it, so a run can show that its path went
    through the kernel."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.count = 0

    def reset(self) -> None:
        self.count = 0


def require_cuda_or_cpu(t, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; any other device
    raises (the wrappers take the plain version only for CPU tensors)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: unsupported device {t.device}")
