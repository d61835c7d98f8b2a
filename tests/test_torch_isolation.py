"""The port stands alone: it imports no JAX, and it never runs on the CPU
unless asked to.

In a fresh interpreter where a meta-path finder refuses ``jax``, ``flax``,
``triton`` and the JAX package, every module of the port imports, the
kernel wrappers included (they import Triton and build their CUDA sources
only when they launch). With CUDA absent, an entry point called without
``device="cpu"`` raises instead of falling back to the CPU.
"""

import os
import subprocess
import sys

import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    device as tdevice,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    eval_cos,
    extract_features,
    serve_demo,
    train_head,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    MTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.efm_symbol import (
    build_efmnet342,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"

_SCRIPT = """
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "triton",
           "improving_face_recognition_performance_using_triplet_loss_tpu")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
pkg = importlib.import_module("%s")
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("IMPORTED", len(names), " ".join(sorted(names)))
""" % PORT


def test_port_imports_without_jax_or_triton():
    r = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout.split()
    assert out[0] == "IMPORTED"
    mods = set(out[2:])
    for name in ("ops.cuda.nms", "ops.cuda.stem", "ops.cuda.efm3",
                 "ops.cuda._build", "cli.serve_demo", "serve.pipeline",
                 "serve.convert", "detect.device_cascade", "ops.cuda.mining",
                 "ops.mining", "train.steps", "train.loops",
                 "train.checkpoint", "cli.train_head", "cli.eval_cos",
                 "ops.cuda.front9", "models.lightcnn", "extract",
                 "cli.extract_features", "data.records", "data.synthetic"):
        assert f"{PORT}.{name}" in mods, name
    assert int(out[1]) == len(mods) >= 20


@pytest.mark.parametrize("entry", ["resolve_device", "detector", "model",
                                   "serve_demo", "train_head", "eval_cos",
                                   "extract_features"])
def test_default_device_without_cuda_raises(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "resolve_device": lambda: tdevice.resolve_device(),
        "detector": lambda: MTCNNDetector(),
        "model": lambda: build_efmnet342(4, image_size=32),
        "serve_demo": lambda: serve_demo.main(["--streams", "1"]),
        "train_head": lambda: train_head.main([
            "--synthetic", "--epochs", "1", "--out-dir", str(tmp_path)]),
        "eval_cos": lambda: eval_cos.main([
            "--synthetic", "--out-dir", str(tmp_path)]),
        "extract_features": lambda: extract_features.main([
            "--synthetic", "--model", "lightcnn9", "--out-dir",
            str(tmp_path)]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert tdevice.resolve_device("cpu").type == "cpu"
