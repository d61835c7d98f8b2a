"""The port's backbone CLIs on the CPU: ``train_backbone`` (a run, a
resume, its export in the port's extractor and the JAX package),
``train_final`` on that export, ``pack_dataset`` against the JAX
package's, and the flags that are not ported.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    pack_dataset as jpack_dataset,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    LightCNN29 as JLightCNN29,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    export as jexport,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    train as ttrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    pack_dataset,
    train_backbone,
    train_final,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    load_image_store,
    load_image_store_mmap,
    save_image_store_mmap,
    synthetic_faces,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
    extract_features,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools oversubscribe the cores (a 10x slowdown
    measured under the suite's six workers)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


BATCH = 16


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A uint8 mmap store of 96 synthetic faces at 32x32, 6 identities."""
    d = tmp_path_factory.mktemp("bbstore")
    faces, labels = synthetic_faces(num_ids=6, per_id=16, size=32, seed=3)
    path = str(d / "store")
    save_image_store_mmap(path, faces, labels)
    return path


def _train_argv(store, out, epochs, *extra):
    return ["--images", store, "--model", "lightcnn29", "--epochs",
            str(epochs), "--batch-size", str(BATCH), "--mining",
            "semi_hard_fused", "--device", "cpu", "--out-dir", out,
            "--seed", "2", *extra]


@pytest.fixture(scope="module")
def run(store, tmp_path_factory):
    """One epoch of train_backbone, then --resume to two, with prefetch,
    scan chunks of 2, an EMA and TF32 set on before each main."""
    out = str(tmp_path_factory.mktemp("bbrun") / "run")
    results, tf32 = [], []
    for epochs, extra in ((1, ()), (2, ("--resume",))):
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        results.append(train_backbone.main(_train_argv(
            store, out, epochs, "--prefetch", "2", "--scan-chunk", "2",
            "--ema-decay", "0.9", *extra)))
        tf32.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
    return out, results, tf32


def test_train_backbone_runs_and_resumes(run):
    """96 rows at batch 16: 6 steps an epoch, 3 chunks of 2. The resumed
    run starts at epoch 1, continues the step count and Adam's moments,
    and writes the CSV rows, checkpoints and export."""
    out, ((s1, h1), (s2, h2)), tf32 = run
    assert tf32 == [(False, False), (False, False)]
    assert [h.epoch for h in h1] == [0] and [h.epoch for h in h2] == [1]
    assert s1.step == 6 and s2.step == 12
    assert all(np.isfinite(s["loss"]) for h in h1 + h2 for s in h.steps)
    adam = s2.optimizer.state[next(s2.model.parameters())]
    assert int(adam["step"]) == 12
    assert ttrain.Checkpointer(os.path.join(out, "ckpt")).latest_step() == 1
    rows = np.loadtxt(os.path.join(out, "cosine_similarity.csv"), ndmin=2)
    assert rows.shape == (12 * BATCH, 2)
    for name in ("weights.npz", "manifest.json"):
        assert os.path.exists(os.path.join(out, "export", name))


def test_export_loads_in_port_and_jax(run, store):
    """The export (EMA weights, the BatchNorm statistics) gives the same
    features in the port's extractor and the JAX LightCNN29 (1e-4)."""
    out, ((_, _), (state, _)), _ = run
    params, stats, manifest = jexport.load_exported_params(
        os.path.join(out, "export"))
    assert manifest["model"] == "lightcnn29" and manifest["precision"] == "f32"
    assert manifest["input"]["height"] == 32 and stats["fc1_bn"]["var"].shape \
        == (684,)
    ema = ttrain.get_ema_params(state)
    np.testing.assert_array_equal(params["fc2"]["kernel"],
                                  ema["fc2.weight"].numpy().T)
    images, labels = load_image_store_mmap(store)
    model = from_jax_params(os.path.join(out, "export"), device="cpu")
    feats, _, _, _ = extract_features(model, images[:8], labels[:8],
                                      batch_size=8)
    x = jnp.asarray(np.asarray(images[:8], np.float32) / 255.0)
    _, want = JLightCNN29(num_classes=6).apply(
        {"params": params, "batch_stats": stats}, x, train=False)
    want = np.array(want)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_allclose(feats, want, atol=1e-4)


def test_train_final_on_the_export(run, store, tmp_path):
    """The head trains over the frozen export's features; its main turns
    TF32 off like every CLI that computes on the card."""
    out = run[0]
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    state, history = train_final.main([
        "--images", store, "--export-dir", os.path.join(out, "export"),
        "--epochs", "2", "--batch-size", "32", "--mining", "semi_hard_fused",
        "--device", "cpu", "--out-dir", str(tmp_path)])
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    assert len(history) == 2 and state.step == 2 * (96 // 32)
    assert all(np.isfinite(s["loss"]) for h in history for s in h.steps)
    params, _, manifest = jexport.load_exported_params(
        str(tmp_path / "export"))
    assert manifest["model"] == "linear_head"
    assert params["proj"]["kernel"].shape == (684, 342)


@pytest.mark.parametrize("flag,item", [
    (["--data-parallel"], None),
    (["--class-parallel", "3"], "--class-parallel 3 must divide the class "
                                "count 16")])
def test_unported_flags_exit_naming_their_item(flag, item, tmp_path):
    """(Named when the flags refused.) Run plainly, ``--data-parallel`` and
    ``--class-parallel 1`` are a group of one and take the same updates;
    ``--class-parallel`` exits with the JAX CLI's text when M does not
    divide the classes. Several ranks: tests/test_torch_parallel_cli.py."""
    argv = ["--synthetic", "--synthetic-size", "32", "--model", "lightcnn9",
            "--epochs", "1", "--batch-size", "64", "--mining", "semi_hard",
            "--optimizer", "sgd", "--device", "cpu"]
    if item is not None:
        with pytest.raises(SystemExit, match=item):
            train_backbone.main(argv + flag + ["--out-dir", str(tmp_path)])
        return
    _, dp = train_backbone.main(argv + flag + ["--out-dir",
                                               str(tmp_path / "dp")])
    _, cp = train_backbone.main(argv + ["--class-parallel", "1",
                                        "--out-dir", str(tmp_path / "cp")])
    # both fold data rank 0 into each step's generator: the same updates,
    # up to the class-parallel CE's other rounding of the log-sum-exp
    # (sgd: Adam's first updates are the gradients' signs)
    got = [s["loss"] for s in dp[0].steps]
    assert len(got) == 4 and np.isfinite(got).all()
    np.testing.assert_allclose(got, [s["loss"] for s in cp[0].steps],
                               rtol=1e-5)
    a = np.load(tmp_path / "dp" / "export" / "weights.npz")
    b = np.load(tmp_path / "cp" / "export" / "weights.npz")
    for k in a.files:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-5,
                                   err_msg=k)


def test_train_backbone_synthetic_options(tmp_path):
    """--synthetic with the device mirror, a center-loss table, a crop
    and bf16 compute: a few finite steps on the CPU."""
    state, history = train_backbone.main([
        "--synthetic", "--synthetic-size", "40", "--crop-size", "32",
        "--model", "efmnet342", "--epochs", "1", "--batch-size", "64",
        "--device-augment", "--center-loss-weight", "0.1", "--bf16",
        "--optimizer", "rmsprop", "--device", "cpu",
        "--out-dir", str(tmp_path)])
    assert state.step == 4 and state.aux.shape == (16, 342)
    assert all(np.isfinite(s["loss"]) for h in history for s in h.steps)
    _, _, manifest = jexport.load_exported_params(str(tmp_path / "export"))
    assert manifest["input"]["height"] == 32
    assert manifest["precision"] == "bf16"


def _write_tree(root):
    import cv2

    rng = np.random.default_rng(0)
    for c in range(5):
        d = root / f"id{c:02d}"
        d.mkdir(parents=True)
        for i in range(3):
            img = rng.integers(0, 256, (20 + c, 24, 3)).astype(np.uint8)
            cv2.imwrite(str(d / f"{i}.png"), img)
    (root / "id01" / "broken.png").write_bytes(b"not an image")


@pytest.mark.parametrize("mmap", [False, True])
def test_pack_dataset_matches_jax(tmp_path, mmap):
    """The same tree packs into the same stores (and splits) as the JAX
    CLI's, the undecodable file skipped."""
    if importlib.util.find_spec("cv2") is None:
        pytest.skip("pack_dataset decodes with cv2, which is not installed")
    _write_tree(tmp_path / "tree")
    outs = {}
    for name, cli in (("j", jpack_dataset), ("t", pack_dataset)):
        out = str(tmp_path / (name if mmap else f"{name}.npz"))
        cli.main([str(tmp_path / "tree"), out, "--image-size", "16",
                  "--train-frac", "0.6", "--workers", "2"]
                 + (["--mmap"] if mmap else []))
        outs[name] = out
    load = load_image_store_mmap if mmap else load_image_store

    def path(name, sfx):
        return outs[name] + sfx if mmap else outs[name][:-4] + sfx + ".npz"

    for sfx in ("", "_train", "_test"):
        (ti, tl), (ji, jl) = load(path("t", sfx)), load(path("j", sfx))
        np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))
        np.testing.assert_array_equal(tl, jl)
    images, labels = load(path("t", ""))
    assert images.shape == (15, 16, 16, 1)
    assert sorted(set(labels.tolist())) == [0, 1, 2, 3, 4]
