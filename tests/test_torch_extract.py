"""Bulk extraction, exports and image stores of the port against the JAX
package, on the CPU.

The JAX ``extract_features`` CLI and the port's run on one JAX export and
one ``synthetic_faces`` store: features within 1e-4 (a deep f32 stack summed
in another order on each side), equal predictions and accuracy, and the
same files with the same rows in the same order. Exports and stores written
by either package load in the other. Predictions are held equal only where
rounding cannot decide them: each row's two highest logits lie further
apart than twice the tolerance the values are held to
(``_torch_ties.argmax_margins``).
"""

import os

import jax
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu import (
    utils as jutils,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    extract_features as jcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.data import (
    records as jrecords,
    synthetic as jsynthetic,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.data.feature_store import (
    read_feature_csv,
    read_labels_csv,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.extract import (
    make_extract_fn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    LightCNN9 as JLightCNN9,
    LightCNN29 as JLightCNN29,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    export as jexport,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    data as tdata,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    extract_features as tcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
    extract_features,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    export_model,
    from_jax_params,
)

from _torch_ties import argmax_margins
from _torch_weights import flax_params

SIDE = 32
MODELS = {"lightcnn9": JLightCNN9, "lightcnn29": JLightCNN29}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _variables(name, seed=0):
    """A flax net and its variables from numpy: params, and for LightCNN29
    random BatchNorm statistics."""
    model = MODELS[name](num_classes=6)
    variables = {"params": flax_params(model, SIDE, seed)}
    if name == "lightcnn29":
        rng = np.random.default_rng(seed + 1)
        variables["batch_stats"] = {"fc1_bn": {
            "mean": (rng.normal(size=684) * 0.1).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 684).astype(np.float32)}}
    return model, variables


def _apply(model, variables, x):
    return jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)


@pytest.fixture(scope="module", params=list(MODELS))
def jax_export(request, tmp_path_factory):
    """(model name, flax net, variables, export dir) of a JAX export."""
    name = request.param
    model, variables = _variables(name)
    out = str(tmp_path_factory.mktemp(name) / "export")
    jexport.export_params(out, variables["params"], model_name=name,
                          feature_dim=model.feature_dim,
                          input_hw=(SIDE, SIDE),
                          batch_stats=variables.get("batch_stats"))
    return name, model, variables, out


def test_extract_cli_matches_jax(jax_export, tmp_path, monkeypatch):
    """(e) both CLIs on one export, over an .npz store (train) and an mmap
    store (valid) whose labels make the accuracy 0.5: same files, same
    rows in the same order, features within 1e-4, equal predictions and
    accuracy."""
    name, model, variables, export = jax_export
    imgs, _ = jsynthetic.synthetic_faces(num_ids=5, per_id=4, size=SIDE)
    u8 = (imgs * 255.0).clip(0, 255).astype(np.uint8)
    logits, _ = make_extract_fn(model)(variables, u8)
    pred = np.asarray(logits).argmax(-1)
    # no prediction within the features' tolerance of a tie
    assert np.all(argmax_margins(logits, 1e-4) > 0)
    labels = np.where(np.arange(len(pred)) % 2 == 0, pred, (pred + 1) % 6)
    jrecords.save_image_store(str(tmp_path / "train.npz"), u8, labels)
    jrecords.save_image_store_mmap(str(tmp_path / "valid"), u8[:12],
                                   labels[:12])
    args = ["--train-images", str(tmp_path / "train.npz"), "--valid-images",
            str(tmp_path / "valid"), "--export-dir", export,
            "--batch-size", "8"]
    # the JAX CLI's persistent compile cache would be process-wide state
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda *a: None)
    want = jcli.main(args + ["--out-dir", str(tmp_path / "jax")])
    got = tcli.main(args + ["--out-dir", str(tmp_path / "port"),
                            "--device", "cpu"])
    assert set(got) == set(want) == {"train", "valid"}
    for split in ("train", "valid"):
        feats, labs, acc = want[split]
        res = got[split]
        np.testing.assert_allclose(res.features, feats, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(res.labels, labs)
        np.testing.assert_array_equal(res.predictions, pred[:len(labs)])
        assert res.accuracy == acc == 0.5
    files = {d: sorted(f for f in os.listdir(tmp_path / d) if f != "log")
             for d in ("jax", "port")}
    assert files["jax"] == files["port"] == [
        "feature_vector_train.csv", "feature_vector_valid.csv",
        "label_train.csv", "label_valid.csv", "train.npz", "valid.npz"]
    for split in ("train", "valid"):
        a = read_feature_csv(str(tmp_path / "jax" / f"feature_vector_{split}.csv"))
        b = read_feature_csv(str(tmp_path / "port" / f"feature_vector_{split}.csv"))
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(
            read_labels_csv(str(tmp_path / "port" / f"label_{split}.csv")),
            read_labels_csv(str(tmp_path / "jax" / f"label_{split}.csv")))
        with np.load(tmp_path / "port" / f"{split}.npz") as z, \
                np.load(tmp_path / "jax" / f"{split}.npz") as w:
            np.testing.assert_array_equal(z["labels"], w["labels"])
            np.testing.assert_allclose(z["features"], w["features"],
                                       rtol=1e-4, atol=1e-4)


def test_exports_load_both_ways(jax_export, tmp_path):
    """(f) a JAX export runs in the port; the port's export of that net
    loads in the JAX package (batch_stats included) and gives the same
    features there."""
    name, model, variables, export = jax_export
    x = np.random.default_rng(9).random((3, SIDE, SIDE, 1)).astype(np.float32)
    want = np.asarray(_apply(model, variables, x)[1])
    net = from_jax_params(export, device="cpu")
    assert net.model_name == name and net.input_hw == (SIDE, SIDE)
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.from_numpy(x))[1].numpy(), want,
                                   rtol=1e-4, atol=1e-4)
    export_model(str(tmp_path / "port"), net)
    params, stats, manifest = jexport.load_exported_params(
        str(tmp_path / "port"))
    assert manifest["model"] == name
    assert manifest["feature_dim"] == model.feature_dim
    assert (manifest["input"]["height"], manifest["input"]["width"],
            manifest["input"]["channels"]) == (SIDE, SIDE, 1)
    back = {"params": params}
    if name == "lightcnn29":
        assert set(stats) == {"fc1_bn"}
        back["batch_stats"] = stats
    else:
        assert not stats
    np.testing.assert_array_equal(np.asarray(_apply(model, back, x)[1]),
                                  want)


def test_extract_features_pads_and_refuses(tmp_path):
    """The last batch is padded and its pad rows dropped (features do not
    depend on the batch size); uint8 rows equal float rows / 255;
    data-parallel extraction (library and CLI) gives the same rows, and
    int8 runs."""
    net = from_jax_params(_variables("lightcnn9")[1], device="cpu")
    imgs, labels = tdata.synthetic_faces(num_ids=3, per_id=3, size=SIDE)
    u8 = (imgs * 255.0).clip(0, 255).astype(np.uint8)
    f4, lab, acc, p4 = extract_features(net, u8, labels, batch_size=4)
    f9, _, acc9, p9 = extract_features(net, u8, labels, batch_size=9)
    assert f4.shape == (9, 256) and p4.shape == (9,)
    np.testing.assert_allclose(f4, f9, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(f4, axis=1), 1.0, rtol=1e-5)
    assert acc == acc9 and np.array_equal(lab, labels)
    with torch.no_grad():
        logits = net(torch.from_numpy(u8.astype(np.float32) / 255.0))[0]
    assert np.all(argmax_margins(logits.numpy(), 1e-5) > 0)
    np.testing.assert_array_equal(p4, p9)
    ff, *_ = extract_features(net, u8.astype(np.float32) / np.float32(255),
                                batch_size=4)
    np.testing.assert_allclose(ff, f4, rtol=1e-5, atol=1e-6)
    # data-parallel extraction over a group of one gives the same rows
    # (tests/test_torch_parallel_serve.py: 2 ranks against JAX), and so
    # does the CLI's --data-parallel
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
        parallel,
    )

    with parallel.process_group("cpu"):
        fd, _, accd, pd = extract_features(net, u8, labels, batch_size=4,
                                           data_parallel=True)
    np.testing.assert_array_equal(fd, f4)
    np.testing.assert_array_equal(pd, p4)
    assert accd == acc
    argv = ["--synthetic", "--model", "lightcnn9", "--device", "cpu",
            "--batch-size", "16"]
    dp = tcli.main(argv + ["--data-parallel", "--out-dir",
                           str(tmp_path / "dp")])
    plain = tcli.main(argv + ["--out-dir", str(tmp_path / "plain")])
    for split in ("train", "valid"):
        np.testing.assert_array_equal(dp[split].features,
                                      plain[split].features)
        np.testing.assert_array_equal(dp[split].predictions,
                                      plain[split].predictions)
    # int8 is ported (tests/test_torch_quantized.py): padded batches too
    q4, *_ = extract_features(net, u8, batch_size=4, int8=True)
    assert q4.shape == f4.shape
    assert (q4 * f4).sum(1).min() >= 0.999
    # DeepFace is ported: --synthetic gives it 3-channel 72x72 faces
    out = tcli.main(["--synthetic", "--model", "deepface", "--device", "cpu",
                     "--batch-size", "32", "--out-dir", str(tmp_path)])
    assert out["valid"].features.shape == (32, 4096)


def test_synthetic_extract_sizes_from_manifest(jax_export, tmp_path):
    """--synthetic takes the fixture's size from the export manifest, as
    the JAX CLI does, and writes both splits."""
    name, model, _, export = jax_export
    res = tcli.main(["--synthetic", "--export-dir", export, "--device",
                     "cpu", "--out-dir", str(tmp_path), "--bf16"])
    assert res["train"].features.shape == (64, model.feature_dim)
    assert res["valid"].features.shape == (32, model.feature_dim)
    assert np.isfinite(res["train"].features).all()


@pytest.mark.parametrize("kind", ["npz", "mmap"])
def test_image_stores_round_trip_between_packages(kind, tmp_path):
    """(g) a store written by either package loads in the other with the
    same uint8 images and labels; synthetic_faces draws the same arrays."""
    imgs, labels = tdata.synthetic_faces(num_ids=3, per_id=2, size=12,
                                         channels=3, seed=4)
    jimgs, jlabels = jsynthetic.synthetic_faces(num_ids=3, per_id=2, size=12,
                                                channels=3, seed=4)
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(labels, jlabels)
    u8 = (imgs * 255.0).clip(0, 255).astype(np.uint8)
    if kind == "npz":
        writers = (tdata.save_image_store, jrecords.save_image_store)
        readers = (jrecords.load_image_store, tdata.load_image_store)
        paths = (str(tmp_path / "a.npz"), str(tmp_path / "b.npz"))
    else:
        writers = (tdata.save_image_store_mmap, jrecords.save_image_store_mmap)
        readers = (jrecords.load_image_store_mmap, tdata.load_image_store_mmap)
        paths = (str(tmp_path / "a"), str(tmp_path / "b"))
    for write, read, path in zip(writers, readers, paths):
        write(path, imgs, labels)          # floats in [0, 1] -> uint8
        got, lab = read(path)
        assert got.dtype == np.uint8 and lab.dtype == np.int64
        np.testing.assert_array_equal(np.asarray(got), u8)
        np.testing.assert_array_equal(lab, labels)
