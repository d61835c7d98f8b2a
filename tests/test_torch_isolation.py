"""The port stands alone: it imports no JAX, and it never runs on the CPU
unless asked to.

In a fresh interpreter where a meta-path finder refuses ``jax``, ``flax``,
``triton`` and the JAX package, every module of the port imports, the
kernel wrappers included (they import Triton and build their CUDA sources
only when they launch). With CUDA absent, an entry point called without
``device="cpu"`` raises instead of falling back to the CPU.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    device as tdevice,
    parallel,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    align,
    eval_cos,
    export_aot,
    extract_features,
    identify,
    import_params,
    landmarks68,
    lfw_eval,
    lfw_run,
    serve_demo,
    train_began,
    train_head,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    MTCNNDetector,
    ShapePredictor,
    mtcnn_ert_detect,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.align import (
    align_directory,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.bulk import (
    detect_faces_bulk,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_cascade import (
    DeviceCascade,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.efm_symbol import (
    build_efmnet342,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.quantized import (
    quantize_lightcnn9_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    aot,
    device_gallery,
    gallery,
    gallery_service,
    person_store,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.pipeline import (
    make_multistream_pipeline,
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
                 "cli.extract_features", "data.records", "data.synthetic",
                 "cli.lfw_eval", "cli.lfw_run", "cli.align",
                 "cli.import_params", "eval.lfw", "data.lfw",
                 "utils.mxnet_import", "detect.align", "detect.pipeline",
                 "serve.device_gallery", "serve.gallery",
                 "serve.gallery_service", "serve.person_store",
                 "serve.recognition", "serve.video", "serve.native",
                 "detect.bulk", "cli.identify", "cli._common",
                 "cli.__main__", "cli.landmarks68", "detect.ert",
                 "detect.landmarks", "detect.dlib_import", "serve.export",
                 "ops.quantized", "ops.conv_backward", "eval.projector",
                 "utils.profiling", "utils.cache", "serve.aot",
                 "cli.export_aot", "models.deepface", "models.began_cs",
                 "losses.began", "train.gan", "cli.train_began",
                 "parallel", "parallel.distributed", "parallel.mesh",
                 "parallel.collectives", "losses.sharded",
                 "train.sharding"):
        assert f"{PORT}.{name}" in mods, name
    assert int(out[1]) == len(mods) >= 20


@pytest.mark.parametrize("entry", ["resolve_device", "detector", "model",
                                   "serve_demo", "train_head", "eval_cos",
                                   "extract_features", "lfw_eval", "lfw_run",
                                   "align", "import_params",
                                   "device_cascade", "align_directory",
                                   "serve_demo_camera", "serve_demo_video",
                                   "serve_demo_video_detect",
                                   "identify_tpu", "identify_device_gallery",
                                   "device_gallery", "gallery_matcher",
                                   "person_store_match_batch",
                                   "gallery_service", "detect_faces_bulk",
                                   "extract_features_int8", "landmarks68",
                                   "mtcnn_ert_detect",
                                   "quantize_lightcnn9_params",
                                   "int8_embed_pipeline", "export_aot",
                                   "train_began", "load_pipeline",
                                   "load_compiled", "deepface",
                                   "train_head_data_parallel",
                                   "parallel_rank_device"])
def test_default_device_without_cuda_raises(monkeypatch, tmp_path, entry):
    import numpy as np

    if entry.startswith(("identify", "person_store", "gallery_service")):
        # a one-person store and probes: the host needs no card for these
        np.savez(tmp_path / "f.npz", features=np.ones((2, 4), np.float32),
                 labels=np.zeros(2, np.int64))
        with person_store.PersonStore(str(tmp_path / "p.sqlite"),
                                      4) as store:
            store.register_person(person_store.Person(name="a"),
                                  [np.ones(4, np.float32)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    match_person = ["match-person", "--store", str(tmp_path / "p.sqlite"),
                    "--features", str(tmp_path / "f.npz")]
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
        "lfw_eval": lambda: lfw_eval.main([
            "--images", str(tmp_path / "pairs.npz")]),
        "lfw_run": lambda: lfw_run.main([
            "--lfw", str(tmp_path), "--pairs", str(tmp_path / "pairs.txt"),
            "--model", "lightcnn9"]),
        "align": lambda: align.main([str(tmp_path), str(tmp_path / "out")]),
        "import_params": lambda: import_params.main([
            str(tmp_path / "x.params"), "--out-dir", str(tmp_path / "o"),
            "--verify"]),
        "device_cascade": lambda: DeviceCascade(MTCNNDetector()),
        "align_directory": lambda: align_directory(
            str(tmp_path), str(tmp_path / "out")),
        "serve_demo_camera": lambda: serve_demo.main([
            "--store", str(tmp_path / "d.fjdb")]),
        "serve_demo_video": lambda: serve_demo.main([
            "--video", str(tmp_path / "v.avi")]),
        "serve_demo_video_detect": lambda: serve_demo.main([
            "--video", str(tmp_path / "v.avi"), "--detect",
            "--dynamic-gallery", "--person-db", str(tmp_path / "p.sqlite")]),
        "identify_tpu": lambda: identify.main(match_person + ["--tpu"]),
        "identify_device_gallery": lambda: identify.main(
            match_person + ["--device-gallery"]),
        "device_gallery": lambda: device_gallery.DeviceGallery(4),
        "gallery_matcher": lambda: gallery.make_gallery_matcher(
            np.ones((2, 4))),
        "person_store_match_batch": lambda: person_store.PersonStore(
            str(tmp_path / "p.sqlite"), 4).match_batch(np.ones((1, 4))),
        "gallery_service": lambda: gallery_service.PersonGalleryService(
            person_store.PersonStore(str(tmp_path / "p.sqlite"), 4)),
        "detect_faces_bulk": lambda: detect_faces_bulk(
            [np.zeros((32, 32, 3), np.uint8)]),
        "extract_features_int8": lambda: extract_features.main([
            "--synthetic", "--model", "lightcnn9", "--int8", "--out-dir",
            str(tmp_path)]),
        "landmarks68": lambda: landmarks68.main([
            "detect", "--predictor", str(tmp_path / "sp.npz"),
            str(tmp_path / "face.png")]),
        "mtcnn_ert_detect": lambda: mtcnn_ert_detect(
            np.zeros((32, 32, 3), np.uint8), ShapePredictor(
                mean_shape=np.zeros((68, 2), np.float32))),
        "quantize_lightcnn9_params": lambda: quantize_lightcnn9_params(
            {n: {"kernel": np.zeros((1, 1, 2, 2), np.float32),
                 "bias": np.zeros(2, np.float32)}
             for n in ("conv1", "conv2a", "conv2", "conv3a", "conv3",
                       "conv4a", "conv4", "conv5a", "conv5", "fc1")}),
        "int8_embed_pipeline": lambda: make_multistream_pipeline(
            MTCNNDetector(device="cpu"), build_efmnet342(
                4, image_size=32, device="cpu"), np.ones((1, 342)),
            frame_h=32, frame_w=32, int8_embed=True),
        "export_aot": lambda: export_aot.main([
            "--export-dir", str(tmp_path), "--dynamic-gallery-rows", "8",
            "--frame-size", "32", "32", "--out", str(tmp_path / "a.pt2")]),
        "train_began": lambda: train_began.main([
            "--synthetic", "--epochs", "1", "--out-dir", str(tmp_path)]),
        "load_pipeline": lambda: aot.load_pipeline(str(tmp_path / "a.pt2")),
        "load_compiled": lambda: aot.load_compiled(str(tmp_path / "a.pt2")),
        "deepface": lambda: model_by_name("deepface", 4, input_hw=(65, 65),
                                          in_channels=3),
        "train_head_data_parallel": lambda: train_head.main([
            "--synthetic", "--epochs", "1", "--data-parallel",
            "--out-dir", str(tmp_path)]),
        "parallel_rank_device": lambda: parallel.rank_device(),
    }[entry]
    if entry.startswith("load_"):
        # a CUDA artifact's sidecar: the loader refuses it before reading
        # the artifact
        meta = {"platforms": ["cuda"], "platform": "cuda",
                "format": aot.COMPILED_FORMAT,
                "torch_version": torch.__version__}
        with open(tmp_path / "a.pt2.json", "w") as f:
            json.dump(meta, f)
    if entry == "landmarks68":
        ShapePredictor(mean_shape=np.zeros((68, 2), np.float32)).save(
            str(tmp_path / "sp.npz"))
        cv2 = pytest.importorskip("cv2")
        cv2.imwrite(str(tmp_path / "face.png"), np.zeros((32, 32, 3),
                                                         np.uint8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
    assert tdevice.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/thesis_rehearsal_torch.py",
                                    "tools/perf_aot_coldstart_torch.py"])
def test_port_scripts_load_without_jax(script):
    """The port's GPU smoke test and its thesis rehearsal load (their
    module bodies run) with JAX and the JAX package refused."""
    code = _SCRIPT.split("pkg = importlib.import_module")[0] + (
        "import runpy\n"
        f"runpy.run_path({script!r}, run_name='loaded')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in BLOCKED)\n"
        "assert not bad, bad\n"
        "print('LOADED')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["LOADED"]
