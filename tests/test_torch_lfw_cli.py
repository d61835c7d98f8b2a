"""The port's LFW CLIs (``lfw_eval``, ``lfw_run``) against the JAX
package's, on the CPU.

- ``lfw_eval --embeddings``: the result must EQUAL the JAX CLI's (both
  score the same embeddings with the same numpy protocol).
- ``lfw_eval --images --export-dir`` over a JAX export: both CLIs compute
  in bfloat16, so their embeddings are held by cosine, >= 0.999 row by
  row (the accepted bf16 bound), and the port's result must EQUAL
  ``eval.lfw.evaluate`` of the port's own embeddings. Results at a fixed
  threshold on bf16 embeddings are never compared across frameworks: a
  1e-3 move can flip a pair.
- ``lfw_run`` on the mini-LFW tree of ``tests/test_lfw_run.py`` (a tree
  and a tarball) with ``--export-dir``, ``--model``, ``--prewhiten`` and
  ``--append-baseline``: the JAX CLI's row names, pair counts, widths and
  table layout; each row's numbers EQUAL the protocol over the port's own
  embeddings of the same pair images.
- ``import_params`` -> ``lfw_run``: the imported and the native export
  give IDENTICAL rows (the ``.params`` round trip is lossless).
- ``lfw_run --align --device-cascade`` on a tiny tree, beside the JAX CLI
  with the same detector weights: the same pairs resolve.

Nets: EFMNet342 at 32 px with weights from seeds (numpy), and the
random-init LightCNN9 row of ``lfw_run --model`` at its 128 px.
"""

import json
import os
import tarfile
import warnings

import cv2
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    lfw_eval as jeval,
    lfw_run as jrun,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.extract import (
    extract_features as jextract,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
    export_params as jexport,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    import_params as timport,
    lfw_eval as teval,
    lfw_run as trun,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.lfw import (
    get_paths,
    read_pairs,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.synthetic import (
    synthetic_faces,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.eval import (
    lfw,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.export import (
    export_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.utils.mxnet_import import (
    efm_params_to_mxnet,
    write_mxnet_params,
)
from _torch_weights import flax_params, mtcnn_params

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


COS_MIN = 0.999
PROTOCOL = ("accuracy_mean", "accuracy_std", "val", "val_std", "far",
            "n_pairs")


def _mini_lfw(root, n_ids=4, per_id=3, size=48):
    """LFW-layout tree of synthetic identity images + a pairs.txt (the
    fixture of tests/test_lfw_run.py, from the port's synthetic_faces)."""
    imgs, labels = synthetic_faces(num_ids=n_ids, per_id=per_id, size=size,
                                   seed=7)
    names = [f"Person_{chr(65 + i)}" for i in range(n_ids)]
    counters = {n: 0 for n in names}
    tree = os.path.join(root, "lfw")
    for img, lab in zip(imgs, labels):
        name = names[int(lab)]
        counters[name] += 1
        d = os.path.join(tree, name)
        os.makedirs(d, exist_ok=True)
        u8 = (img[..., 0] * 255).astype(np.uint8)
        cv2.imwrite(os.path.join(d, f"{name}_{counters[name]:04d}.jpg"), u8)
    pairs_path = os.path.join(root, "pairs.txt")
    with open(pairs_path, "w") as f:
        f.write("1\t6\n")
        for i in range(n_ids):
            f.write(f"{names[i]}\t1\t2\n")
        for i in range(n_ids - 1):
            f.write(f"{names[i]}\t1\t{names[i + 1]}\t2\n")
    return tree, pairs_path


@pytest.fixture(scope="module")
def efm_export(tmp_path_factory):
    """(flax EFMNet342, params, a JAX export dir) at 32x32."""
    model = JEFMNet342(num_classes=8)
    params = flax_params(model, 32, seed=21)
    out = str(tmp_path_factory.mktemp("efm") / "export")
    jexport(out, params, model_name="efmnet342", feature_dim=342,
            input_hw=(32, 32))
    return model, params, out


def test_lfw_eval_embeddings_equals_jax(tmp_path, capsys):
    rng = np.random.default_rng(0)
    e1 = rng.normal(size=(90, 24)).astype(np.float32)
    issame = rng.random(90) < 0.5
    e2 = np.where(issame[:, None], e1 + 0.5 * rng.normal(size=e1.shape),
                  rng.normal(size=e1.shape)).astype(np.float32)
    path = str(tmp_path / "emb.npz")
    np.savez(path, embeddings1=e1, embeddings2=e2, issame=issame)
    for extra in ([], ["--distance-metric", "1", "--subtract-mean",
                       "--folds", "9", "--far-target", "0.05"]):
        jout, tout = str(tmp_path / "j.json"), str(tmp_path / "t" / "r.json")
        want = jeval.main(["--embeddings", path, "--out", jout] + extra)
        jtext = capsys.readouterr().out
        got = teval.main(["--embeddings", path, "--out", tout] + extra)
        assert got == want and capsys.readouterr().out == jtext
        assert json.load(open(tout)) == json.load(open(jout))
    with pytest.raises(SystemExit, match="--embeddings or --images"):
        teval.main([])


def _cosines(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def test_lfw_eval_images_bf16(efm_export, tmp_path):
    """uint8 pair images through a JAX export: the port's bf16 embeddings
    within cosine 0.999 of JAX's bf16 ones; the port's result is the
    protocol over its own embeddings, exactly. The batch of 16 leaves a
    partial last batch."""
    model, params, export = efm_export
    faces, _ = synthetic_faces(num_ids=10, per_id=4, size=32, seed=3)
    images = (faces * 255).astype(np.uint8)             # 20 pairs
    issame = np.arange(20) % 2 == 0
    store = str(tmp_path / "pairs.npz")
    np.savez(store, images=images, issame=issame)
    argv = ["--images", store, "--export-dir", export, "--model",
            "efmnet342", "--batch-size", "16", "--folds", "4"]
    got = teval.main(argv + ["--device", "cpu"])

    args = teval.build_parser().parse_args(argv)
    tmodel = teval.build_model(args, images.shape, torch.device("cpu"))
    assert next(tmodel.parameters()).dtype == torch.bfloat16
    temb = teval.pair_embeddings(tmodel, images, 16)
    assert got == teval.evaluate_pairs(temb[0::2], temb[1::2], issame, args)
    assert set(got) == set(PROTOCOL) and got["n_pairs"] == 20

    import jax.numpy as jnp

    jmodel = JEFMNet342(num_classes=8, dtype=jnp.bfloat16)
    jemb, _, _ = jextract(jmodel, {"params": params},
                          images.astype(np.float32) / 255.0, batch_size=16)
    cos = _cosines(temb, jemb)
    assert temb.shape == (40, 342) and cos.min() >= COS_MIN, cos.min()
    # the host division: a float32 store goes through unscaled
    np.testing.assert_array_equal(teval.scale_pair_images(images),
                                  images.astype(np.float32) / 255.0)


def _rows_match(got, want):
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert (g["n_pairs"], g["embedding_dim"]) == (w["n_pairs"],
                                                       w["embedding_dim"])
        assert 0.0 <= g["accuracy_mean"] <= 1.0 and np.isfinite(g["val"])


def _row_from_own_embeddings(row, model, paths, issame, hw, prewhiten):
    images = trun._load_pair_images(paths, hw, 1)
    if prewhiten:
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.records import (
            prewhiten as pw,
        )

        images = pw(torch.from_numpy(images)).numpy()
    emb = teval.pair_embeddings(model, images, 8)
    want = lfw.evaluate(emb[0::2], emb[1::2], issame, nrof_folds=2)
    assert (row["accuracy_mean"], row["accuracy_std"], row["val"],
            row["val_std"], row["far"]) == tuple(want[2:])


@pytest.mark.parametrize("prewhiten", [False, True])
def test_lfw_run_tree_and_tarball(efm_export, tmp_path, prewhiten):
    """A tarball and a tree, one export row (its input size from the
    manifest) and one random-init row, the table appended to a baseline
    file: rows as the JAX CLI's, numbers the protocol over the port's own
    embeddings."""
    _, _, export = efm_export
    tree, pairs = _mini_lfw(str(tmp_path), size=40)
    tgz = str(tmp_path / "lfw.tgz")
    with tarfile.open(tgz, "w:gz") as tf:
        tf.add(tree, arcname="lfw")
    base = str(tmp_path / "BASE.md")
    with open(base, "w") as f:
        f.write("# base\n")
    common = ["--pairs", pairs, "--export-dir", export, "--model",
              "lightcnn9", "--num-classes", "8", "--folds", "2",
              "--batch-size", "8"] + (["--prewhiten"] if prewhiten else [])
    want = jrun.main(["--lfw", tgz] + common)
    got = trun.main(["--lfw", tgz, "--append-baseline", base,
                     "--out", str(tmp_path / "rows.json"),
                     "--device", "cpu"] + common)
    _rows_match(got, want)
    assert got[0]["name"].startswith("efmnet342 (efm") and got[0]["n_pairs"] == 7
    assert json.load(open(tmp_path / "rows.json")) == got
    text = open(base).read()
    assert "### LFW 10-fold results" in text
    assert trun.results_table(got) in text
    assert trun.results_table(got).splitlines()[0] == jrun.results_table(
        want).splitlines()[0]

    paths, issame = get_paths(tree, read_pairs(pairs))
    _row_from_own_embeddings(
        got[0], from_jax_params(export, dtype=torch.bfloat16, device="cpu"),
        paths, issame, (32, 32), prewhiten)
    # the tree gives the tarball's rows
    assert trun.main(["--lfw", tree, "--device", "cpu"] + common) == got


def test_import_params_then_lfw_run_identical(tmp_path):
    """A reference-layout checkpoint of some weights, imported, scores LFW
    exactly as the native export of the same weights."""
    model = JEFMNet342(num_classes=8)
    params = flax_params(model, 32, seed=22)
    native = str(tmp_path / "native")
    export_params(native, params, model_name="efmnet342", feature_dim=342,
                  input_hw=(32, 32))
    ckpt = str(tmp_path / "EFM_RES-0280.params")
    write_mxnet_params(ckpt, efm_params_to_mxnet(params))
    imported = str(tmp_path / "imported")
    timport.main([ckpt, "--out-dir", imported])
    tree, pairs = _mini_lfw(str(tmp_path), size=32)
    common = ["--lfw", tree, "--pairs", pairs, "--folds", "2",
              "--batch-size", "8", "--device", "cpu"]
    rows_imp = trun.main(["--export-dir", imported] + common)
    rows_nat = trun.main(["--export-dir", native] + common)
    assert rows_imp[0]["n_pairs"] == 7
    for k in PROTOCOL + ("embedding_dim",):
        assert rows_imp[0][k] == rows_nat[0][k], k


def test_lfw_run_align_device_cascade(efm_export, tmp_path, monkeypatch):
    """``--align --device-cascade``: the JAX and the port CLI align the
    same tree with the same MTCNN weights (their face heads biased so that
    random weights pass the default thresholds; the port takes them by
    ``--det-weights``, the JAX CLI's detector is patched to them), the
    same pairs resolve, and the rows have the JAX CLI's layout."""
    from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
        MTCNNDetector as JDetector,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
        align as jalign,
    )

    specs = (jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC, jmtcnn._ONET_SPEC)
    params = [mtcnn_params(s, seed=30 + i) for i, s in enumerate(specs)]
    weights = []
    for i, (p, head) in enumerate(zip(params,
                                      ("conv4-1", "conv5-1", "conv6-1"))):
        p[head]["biases"] = np.asarray([-3.0, 3.0], np.float32)
        weights.append(str(tmp_path / f"det{i + 1}.npy"))
        np.save(weights[-1], p, allow_pickle=True)
    monkeypatch.setattr(jalign, "MTCNNDetector", lambda: JDetector(
        *[jmtcnn.load_npy_params(p) for p in params]))
    _, _, export = efm_export
    tree, pairs = _mini_lfw(str(tmp_path), n_ids=2, per_id=2, size=64)
    common = ["--lfw", tree, "--pairs", pairs, "--align", "--device-cascade",
              "--align-size", "40", "--align-margin", "8", "--export-dir",
              export, "--num-classes", "8", "--folds", "2", "--batch-size",
              "4"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jrun.main(common)
        got = trun.main(common + ["--det-weights", *weights,
                                  "--device", "cpu"])
    _rows_match(got, want)
    assert got[0]["n_pairs"] == want[0]["n_pairs"] == 3
    # without weights the random-init detector finds no face at the
    # default thresholds, as the JAX CLI's: no pair resolves
    with pytest.raises(SystemExit, match="no resolvable pairs"):
        trun.main(common + ["--device", "cpu"])
