"""The AOTInductor route of the port's AOT export on the CPU, in a file of
its own for its C++ compile (~60 s): ``export_aot --compiled-out
--cache-bundle`` at a small size (a bundle beside each artifact),
``load_compiled`` against the live pipeline, the sidecar's refusals (torch
version, device kind, card), and the kernel bundle's install rule
(copies into the build directory; a library already there wins).

Inductor fuses and reorders float32 work, so the compiled package's
similarities and boxes are held to the live pipeline's at 1e-4 and its
``found`` / ``index`` must be equal.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    export_aot,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    save_feature_store,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    MTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    _build,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    aot,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    export_model,
    from_jax_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.pipeline import (
    make_recognition_pipeline,
)

H = W = 48
TH = (0.05, 0.05, 0.05)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_compiled_package_equals_live_pipeline(tmp_path):
    model = model_by_name("efmnet342", 4, input_hw=(32, 32), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    export_model(str(tmp_path / "export"), model)
    gallery = np.random.default_rng(5).normal(size=(5, 342)).astype(
        np.float32)
    save_feature_store(str(tmp_path / "g.npz"), gallery,
                       np.arange(5, dtype=np.int64))
    export_aot.main(["--export-dir", str(tmp_path / "export"), "--gallery",
                     str(tmp_path / "g.npz"), "--frame-size", str(H), str(W),
                     "--thresholds", *map(str, TH), "--sim-threshold", "-1",
                     "--precision", "f32", "--out", str(tmp_path / "p.pt2"),
                     "--compiled-out", str(tmp_path / "c.pt2"),
                     "--cache-bundle", "--platforms", "cpu"])
    meta = aot.read_meta(str(tmp_path / "c.pt2"))
    assert meta["format"] == aot.COMPILED_FORMAT
    assert meta["platform"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    # a CPU artifact loads no kernel library: its bundle is empty; the
    # package gets its own copy beside it
    assert os.listdir(tmp_path / "p.pt2.xcache") == []
    assert os.listdir(tmp_path / "c.pt2.xcache") == []
    fn = aot.load_compiled(str(tmp_path / "c.pt2"))
    live = make_recognition_pipeline(
        MTCNNDetector(device="cpu"),
        from_jax_params(str(tmp_path / "export"), device="cpu"), gallery,
        frame_h=H, frame_w=W, embed_size=32, thresholds=TH,
        sim_threshold=-1.0, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        frame = (rng.random((H, W, 3)) * 255).astype(np.float32)
        got, want = fn(frame), live(frame)
        assert set(got) == set(want)
        for k in ("found", "index", "cap_dropped"):
            assert torch.equal(got[k], want[k]), k
        for k in ("box", "score", "similarity", "embedding"):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=1e-4, err_msg=k)

    # the sidecar pins the package to its device kind, card and torch
    # version
    side = str(tmp_path / "c.pt2.json")
    for key, value, err in (("torch_version", "0.0.0", "compiled by torch"),
                            ("platform", "cuda", "CUDA is not available"),
                            ("device_name", "NVIDIA A100-SXM4-80GB",
                             "compiled for NVIDIA A100-SXM4-80GB, this is "
                             "cpu")):
        if key == "platform" and torch.cuda.is_available():
            continue
        shutil.copy2(side, side + ".bak")
        with open(side) as f:
            bad = json.load(f)
        bad[key] = value
        with open(side, "w") as f:
            json.dump(bad, f)
        with pytest.raises(RuntimeError, match=err):
            aot.load_compiled(str(tmp_path / "c.pt2"))
        shutil.move(side + ".bak", side)
    with pytest.raises(ValueError, match="not an AOTInductor"):
        aot.load_compiled(str(tmp_path / "p.pt2"))


def test_cache_bundle_installs_and_existing_entries_win(tmp_path,
                                                        monkeypatch):
    """``install_cache_bundle`` copies the bundle's kernel libraries into
    the build directory, keeps a library that is already there, and
    reports whether it installed anything."""
    build = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", str(build))
    art = str(tmp_path / "a.pt2")
    assert not aot.install_cache_bundle(art)          # no bundle
    bundle = tmp_path / "a.pt2.xcache"
    bundle.mkdir()
    (bundle / "libnms_0123456789ab.so").write_bytes(b"bundle-nms")
    (bundle / "libstem_0123456789ab.so").write_bytes(b"bundle-stem")
    (bundle / "notes.txt").write_bytes(b"not a library")
    build.mkdir()
    (build / "libstem_0123456789ab.so").write_bytes(b"built-here")
    assert aot.install_cache_bundle(art)
    assert (build / "libnms_0123456789ab.so").read_bytes() == b"bundle-nms"
    assert (build / "libstem_0123456789ab.so").read_bytes() == b"built-here"
    assert sorted(os.listdir(build)) == ["libnms_0123456789ab.so",
                                         "libstem_0123456789ab.so"]
    assert not aot.install_cache_bundle(art)          # nothing new
