"""The port's CLIs compute float32 in float32.

PyTorch runs cuDNN's float32 convolutions in TF32 by default, while the
JAX twins compute them in full float32. Each CLI that computes on the card
turns TF32 off for convolutions and matrix products in its ``main``. Here,
on the CPU, each ``main`` runs at a toy size with the flag set True first,
and must leave it False.
"""

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


def _runs(tmp_path):
    out = str(tmp_path)
    return {
        "serve_demo": lambda: serve_demo.main([
            "--streams", "1", "--frames", "1", "--frame-size", "48", "48",
            "--image-size", "32", "--identities", "2", "--device", "cpu",
            "--det-thresholds", "0.3", "0.3", "0.3"]),
        "extract_features": lambda: extract_features.main([
            "--synthetic", "--model", "lightcnn9", "--batch-size", "64",
            "--device", "cpu", "--out-dir", out]),
        "train_head": lambda: train_head.main([
            "--synthetic", "--epochs", "1", "--batch-size", "1024",
            "--device", "cpu", "--out-dir", out]),
        "eval_cos": lambda: eval_cos.main([
            "--synthetic", "--batch-size", "1024", "--device", "cpu",
            "--out-dir", out]),
    }


@pytest.mark.parametrize("entry", ["serve_demo", "extract_features",
                                   "train_head", "eval_cos"])
def test_cli_turns_tf32_off(entry, tmp_path):
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        _runs(tmp_path)[entry]()
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def test_full_f32_sets_both_flags():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        tdevice.full_f32()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        # resolve_device leaves the flags alone: a library caller gets no
        # global side effect it did not ask for
        torch.backends.cudnn.allow_tf32 = True
        tdevice.resolve_device("cpu")
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
