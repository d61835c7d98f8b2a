"""The port's CLIs compute float32 in float32.

PyTorch runs cuDNN's float32 convolutions in TF32 by default, while the
JAX twins compute them in full float32. Each CLI that computes on the card
turns TF32 off for convolutions and matrix products in its ``main``. Here,
on the CPU, each ``main`` runs at a toy size with the flag set True first,
and must leave it False.
"""

import os

import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    device as tdevice,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    align,
    eval_cos,
    export_aot,
    extract_features,
    identify,
    import_params,
    lfw_eval,
    lfw_run,
    serve_demo,
    train_began,
    train_head,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    build_efmnet342,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.utils.mxnet_import import (
    efm_params_to_mxnet,
    write_mxnet_params,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _lfw_inputs(tmp_path):
    """A four-image LFW tree with two pairs, its pairs.txt, the same
    images as a pair store, and an EFM ``.params`` checkpoint at 32 px
    (cv2 writes the tree: only the LFW entries need it)."""
    import cv2

    imgs = (np.random.default_rng(0).random((4, 32, 32, 1)) * 255).astype(
        np.uint8)
    for i, name in enumerate(("Ann_A", "Ann_A", "Bob_B", "Bob_B")):
        (tmp_path / "lfw" / name).mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(tmp_path / "lfw" / name
                        / f"{name}_{i % 2 + 1:04d}.jpg"), imgs[i])
    (tmp_path / "pairs.txt").write_text(
        "1\t2\nAnn_A\t1\t2\nAnn_A\t1\tBob_B\t2\n")
    np.savez(tmp_path / "pairs.npz", images=imgs,
             issame=np.asarray([True, False]))
    model = build_efmnet342(3, image_size=32, device="cpu")
    write_mxnet_params(str(tmp_path / "m.params"),
                       efm_params_to_mxnet(model.flax_params()))


# the entries that read the LFW inputs
LFW_ENTRIES = ("lfw_eval", "lfw_run", "align", "import_params")


# the entries that read a person store (and a video)
SERVING_ENTRIES = ("identify", "serve_demo_camera", "serve_demo_video_detect")


def _serving_inputs(tmp_path):
    """A one-person store with its probes, and a 6-frame scene video (cv2
    writes it: only the video entry needs it)."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        person_store,
        video,
    )

    feats = np.random.default_rng(1).normal(size=(3, 342)).astype(np.float32)
    np.savez(tmp_path / "f.npz", features=feats, labels=np.zeros(3, np.int64))
    with person_store.PersonStore(str(tmp_path / "p.sqlite"), 342) as store:
        store.register_person(person_store.Person(name="a"), list(feats))
    base = np.random.default_rng(2).uniform(40, 210, (6, 6, 3))
    scene = np.kron(base, np.ones((8, 8, 1))).astype(np.uint8)
    video.write_test_video(str(tmp_path / "v.avi"), np.stack([scene] * 6))


def _runs(tmp_path, entry):
    out = str(tmp_path)
    if entry in LFW_ENTRIES:
        _lfw_inputs(tmp_path)
    if entry in SERVING_ENTRIES:
        _serving_inputs(tmp_path)
    if entry == "export_aot":
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
            export_model,
        )

        export_model(os.path.join(out, "export"),
                     build_efmnet342(4, image_size=32, device="cpu"))
    return {
        "export_aot": lambda: export_aot.main([
            "--export-dir", os.path.join(out, "export"),
            "--dynamic-gallery-rows", "4", "--frame-size", "32", "32",
            "--out", os.path.join(out, "a.pt2"), "--device", "cpu"]),
        "train_began": lambda: train_began.main([
            "--synthetic", "--synthetic-size", "16", "--epochs", "1",
            "--batch-size", "128", "--filters", "4", "--h-dim", "8",
            "--device", "cpu", "--out-dir", out]),
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
        "lfw_eval": lambda: lfw_eval.main([
            "--images", os.path.join(out, "pairs.npz"), "--model",
            "lightcnn9", "--folds", "2", "--device", "cpu"]),
        "lfw_run": lambda: lfw_run.main([
            "--lfw", os.path.join(out, "lfw"), "--pairs",
            os.path.join(out, "pairs.txt"), "--model", "lightcnn9",
            "--folds", "2", "--device", "cpu"]),
        "align": lambda: align.main([
            os.path.join(out, "lfw"), os.path.join(out, "aligned"),
            "--device", "cpu"]),
        "import_params": lambda: import_params.main([
            os.path.join(out, "m.params"), "--out-dir",
            os.path.join(out, "imported"), "--verify", "--device", "cpu"]),
        "identify": lambda: identify.main([
            "match-person", "--store", os.path.join(out, "p.sqlite"),
            "--features", os.path.join(out, "f.npz"), "--tpu", "--device",
            "cpu"]),
        "serve_demo_camera": lambda: serve_demo.main([
            "--image-size", "32", "--identities", "2", "--frames", "2",
            "--device", "cpu", "--store", os.path.join(out, "d.fjdb")]),
        "serve_demo_video_detect": lambda: serve_demo.main([
            "--video", os.path.join(out, "v.avi"), "--detect",
            "--frame-size", "48", "48", "--image-size", "32",
            "--det-thresholds", "0.3", "0.3", "0.3", "--dynamic-gallery",
            "--person-db", os.path.join(out, "p.sqlite"),
            "--register-frames", "0", "--max-faces", "2", "--fps-cap", "0",
            "--device", "cpu", "--store", os.path.join(out, "d.fjdb")]),
    }


@pytest.mark.parametrize("entry", ["serve_demo", "extract_features",
                                   "train_head", "eval_cos", *LFW_ENTRIES,
                                   *SERVING_ENTRIES, "export_aot",
                                   "train_began"])
def test_cli_turns_tf32_off(entry, tmp_path):
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        _runs(tmp_path, entry)[entry]()
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
