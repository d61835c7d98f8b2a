"""The port's 68-point landmarks (``detect/ert.py``, ``detect/landmarks.py``,
``detect/dlib_import.py``, ``serve/export.py::export_ert`` and the
``landmarks68`` CLI) against the JAX package's, on the CPU.

The ERT code is numpy in both packages, so one seed trains the same
predictor bit for bit (the JAX fixture's size, tests/test_ert.py:82), and
predictions, ``.npz`` / ``.dat`` files and ``export_ert`` arrays are equal
byte for byte. The MTCNN detections come from seeded det*.npy-layout
weights given to both packages at thresholds 0.3 (tests/test_torch_align.py):
boxes within 1e-3 (float32 convs summed in another order on each side);
landmarks within 1e-3 of JAX's on the same boxes (the ERT samples pixels at
truncated coordinates, so they are bit-equal when handed identical
detections, checked too). The port's ``NativeErt`` over the port's export
matches ``predict`` within 1e-3 (tests/test_native_ert.py:94).
"""

import json
import os

import cv2
import numpy as np
import pytest

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    landmarks68 as jcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    MTCNNDetector as JDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    dlib_import as jdlib,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    ert as jert,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    landmarks as jlm,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    pipeline as jpipeline,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
    export_ert as j_export_ert,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    detect as tdetect,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    landmarks68 as tcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    dlib_import as tdlib,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    ert as tert,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    landmarks as tlm,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    pipeline as tpipeline,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.export import (
    export_ert as t_export_ert,
)

from _torch_weights import mtcnn_params
from test_ert import _dataset

TRAIN = dict(cascades=4, trees_per_cascade=40, tree_depth=3,
             feature_pool=150, n_split_candidates=20, nu=0.3,
             oversampling=3, seed=0)
TH = (0.3, 0.3, 0.3)
FIELDS = ("anchors", "deltas", "split_idx1", "split_idx2", "split_thresh",
          "leaf_values")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a smaller training that leaves no degenerate node (a node no candidate
# splits gets an infinite threshold, which has no ``.dat`` encoding in
# either package; dlib never writes one): the ``.dat`` round trips use it
DAT_TRAIN = dict(cascades=2, trees_per_cascade=10, tree_depth=3,
                 feature_pool=60, n_split_candidates=20, nu=0.3,
                 oversampling=10, seed=0)


def _textured(n, seed):
    """``_dataset`` faces over seeded noise, so feature pixels vary."""
    images, rects, shapes = _dataset(n, seed)
    rng = np.random.default_rng(seed + 1000)
    images = [im + rng.uniform(0, 40, im.shape).astype(np.float32)
              for im in images]
    return images, rects, shapes


@pytest.fixture(scope="module")
def trained():
    images, rects, shapes = _dataset(60, seed=0)
    return (jert.train_shape_predictor(images, rects, shapes, **TRAIN),
            tert.train_shape_predictor(images, rects, shapes, **TRAIN))


def _same_predictor(a, b):
    assert a.mean_shape.tobytes() == b.mean_shape.tobytes()
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        for f in FIELDS:
            x, y = getattr(la, f), getattr(lb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f


def test_training_and_prediction_bit_equal(trained):
    """The fixture of tests/test_ert.py; it leaves degenerate nodes,
    which neither package writes to a ``.dat``."""
    jpred, tpred = trained
    assert len(tpred.levels) == 4 and tpred.num_points == 68
    _same_predictor(jpred, tpred)
    assert any(np.isinf(lv.split_thresh).any() for lv in tpred.levels)
    for mod, pred in ((tdlib, tpred), (jdlib, jpred)):
        with pytest.raises(ValueError, match="non-finite"):
            mod.write_shape_predictor_dat(os.devnull, pred)
    images, rects, shapes = _textured(8, seed=99)
    for i in range(8):
        five = tert.five_points_from_68(shapes[i])
        assert five.tobytes() == jert.five_points_from_68(shapes[i]).tobytes()
        init = tpred.init_shape_from_5pt(five, rects[i])
        assert init.tobytes() == jpred.init_shape_from_5pt(
            five, rects[i]).tobytes()
        for ini in (None, init):
            assert tpred.predict(images[i], rects[i], ini).tobytes() == \
                jpred.predict(images[i], rects[i], ini).tobytes()


def test_landmark_helpers_bit_equal():
    rng = np.random.default_rng(4)
    src = rng.uniform(0, 100, (5, 2)).astype(np.float32)
    dst = rng.uniform(0, 100, (5, 2)).astype(np.float32)
    m = tlm.similarity_transform(src, dst)
    assert m.tobytes() == jlm.similarity_transform(src, dst).tobytes()
    assert tlm.apply_affine(src, m).tobytes() == \
        jlm.apply_affine(src, m).tobytes()
    pts = rng.uniform(0, 64, (10, 3)).astype(np.float32)
    assert tlm.mtcnn_points_to_xy(pts, 2).tobytes() == \
        jlm.mtcnn_points_to_xy(pts, 2).tobytes()
    img = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(tlm.align_face(img, src, 48),
                                  jlm.align_face(img, src, 48))


def test_files_cross_load_byte_equal(trained, tmp_path):
    """Predictor ``.npz`` both ways, ``.dat`` bytes equal and read by the
    other package, ``export_ert`` arrays equal."""
    jpred, tpred = trained
    tpred.save(str(tmp_path / "t.npz"))
    jpred.save(str(tmp_path / "j.npz"))
    _same_predictor(jert.ShapePredictor.load(str(tmp_path / "t.npz")), tpred)
    _same_predictor(tert.ShapePredictor.load(str(tmp_path / "j.npz")), jpred)
    data = _textured(30, seed=0)
    jfin = jert.train_shape_predictor(*data, **DAT_TRAIN)
    tfin = tert.train_shape_predictor(*data, **DAT_TRAIN)
    assert all(np.isfinite(lv.split_thresh).all() for lv in tfin.levels)
    tdlib.write_shape_predictor_dat(str(tmp_path / "t.dat"), tfin)
    jdlib.write_shape_predictor_dat(str(tmp_path / "j.dat"), jfin)
    tbytes = (tmp_path / "t.dat").read_bytes()
    assert tbytes == (tmp_path / "j.dat").read_bytes() and len(tbytes) > 1000
    _same_predictor(tdlib.read_shape_predictor_dat(str(tmp_path / "j.dat")),
                    jfin)
    _same_predictor(jdlib.read_shape_predictor_dat(str(tmp_path / "t.dat")),
                    tfin)
    tn = t_export_ert(str(tmp_path / "tn"), tpred)
    jn = j_export_ert(str(tmp_path / "jn"), jpred)
    assert tn.endswith(".npz")
    with np.load(tn) as a, np.load(jn) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            assert a[k].tobytes() == b[k].tobytes(), k


def test_dat_guards_match_jax(tmp_path):
    bad = str(tmp_path / "bad.dat")
    with open(bad, "wb") as f:
        tdlib._write_int(f, 7)
    with pytest.raises(ValueError, match="version"):
        tdlib.read_shape_predictor_dat(bad)
    with open(bad, "wb") as f:
        f.write(b"\x04\x01")
    with pytest.raises(EOFError, match="truncated"):
        tdlib.read_shape_predictor_dat(bad)
    for v in (0, 1, 255, -256, 1 << 40):
        for mod in (tdlib, jdlib):
            with open(bad, "wb") as f:
                mod._write_int(f, v)
        with open(bad, "rb") as f:
            assert tdlib._read_int(f) == v


def test_native_ert_runs_the_port_export(trained, tmp_path):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        native,
    )

    _, tpred = trained
    npz = t_export_ert(str(tmp_path / "ert.npz"), tpred)
    images, rects, shapes = _textured(4, seed=7)
    with native.NativeErt(npz) as ert:
        assert ert.num_points == 68
        for i in range(4):
            np.testing.assert_allclose(ert.predict(images[i], rects[i]),
                                       tpred.predict(images[i], rects[i]),
                                       atol=1e-3)
            five = tert.five_points_from_68(shapes[i])
            init = tpred.init_shape_from_5pt(five, rects[i])
            np.testing.assert_allclose(
                ert.predict(images[i], rects[i], five_xy=five),
                tpred.predict(images[i], rects[i], init), atol=1e-3)


@pytest.fixture(scope="module")
def dets():
    params = [mtcnn_params(spec, seed=i) for i, spec in enumerate(
        (jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC, jmtcnn._ONET_SPEC))]
    return (JDetector(*[jmtcnn.load_npy_params(p) for p in params]),
            tpipeline.MTCNNDetector(*params, device="cpu"))


def _frames(n):
    return (np.random.default_rng(0).random((n, 64, 64, 3)) * 255).astype(
        np.uint8)


class _Fixed:
    """A detector that returns the detections it was given."""

    def __init__(self, boxes, points):
        self.out = boxes, points

    def detect(self, img, minsize, thresholds, factor):
        return self.out


def test_mtcnn_ert_detect_matches_jax(trained, dets):
    jpred, tpred = trained
    jdet, tdet = dets
    assert tdetect.mtcnn_ert_detect is tert.mtcnn_ert_detect
    for img in _frames(2):
        jb, jl = jert.mtcnn_ert_detect(img, jpred, jdet, thresholds=TH)
        tb, tl = tert.mtcnn_ert_detect(img, tpred, tdet, thresholds=TH)
        assert jb.shape[0] > 0 and tb.shape == jb.shape
        assert tl.shape == jl.shape == (jb.shape[0], 68, 2)
        np.testing.assert_allclose(tb, jb, atol=1e-3)
        np.testing.assert_allclose(tl, jl, atol=1e-3)
        fixed = _Fixed(*jdet.detect(img, 20, TH, 0.709))
        fb, fl = tert.mtcnn_ert_detect(img, tpred, fixed, thresholds=TH)
        assert fb.tobytes() == jb.tobytes() and fl.tobytes() == jl.tobytes()


def test_landmarks68_cli_matches_jax(trained, dets, tmp_path, monkeypatch,
                                     capsys):
    """All four subcommands of both CLIs on the same inputs: the trained
    predictor, the ``.dat`` and the native export equal; ``detect`` (the
    same MTCNN nets given to both) writes the same JSONL."""
    jdet, tdet = dets
    images, rects, shapes = _textured(30, seed=0)
    ann = str(tmp_path / "ann.npz")
    np.savez(ann, images=np.stack(images), rects=rects, shapes=shapes)
    small = ["--cascades", "2", "--trees", "10", "--depth", "3",
             "--feature-pool", "60", "--oversampling", "10", "--nu", "0.3"]
    out = {}
    for name, cli in (("jax", jcli), ("port", tcli)):
        d = tmp_path / name
        cli.main(["train", "--annotations", ann, "--out", str(d / "sp.npz"),
                  "--export-native", str(d / "native.npz"), *small])
        cli.main(["export-dat", str(d / "sp.npz"), "--out",
                  str(d / "sp.dat")])
        cli.main(["import-dat", str(d / "sp.dat"), "--out",
                  str(d / "back.npz"), "--export-native",
                  str(d / "back_native.npz")])
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"].replace(str(tmp_path / "jax"),
                                             str(tmp_path / "port"))
    for f in ("sp.dat",):
        assert (tmp_path / "port" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    for f in ("sp.npz", "back.npz", "native.npz", "back_native.npz"):
        with np.load(tmp_path / "port" / f) as a, \
                np.load(tmp_path / "jax" / f) as b:
            assert sorted(a.files) == sorted(b.files)
            assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)

    paths = []
    for i, img in enumerate(_frames(2)):
        paths.append(str(tmp_path / f"face{i}.png"))
        cv2.imwrite(paths[-1], cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    pred = str(tmp_path / "port" / "sp.npz")
    monkeypatch.setattr(jpipeline, "MTCNNDetector", lambda: jdet)
    monkeypatch.setattr(tpipeline, "MTCNNDetector", lambda device: tdet)
    argv = ["detect", "--predictor", pred, *paths, "--thresholds", "0.3",
            "0.3", "0.3"]
    jcli.main(argv + ["--out", str(tmp_path / "j.jsonl")])
    res = tcli.main(argv + ["--out", str(tmp_path / "t.jsonl"),
                            "--device", "cpu"])
    assert len(res) == 2
    rows = [[json.loads(line) for line in open(tmp_path / f)]
            for f in ("j.jsonl", "t.jsonl")]
    for want, got in zip(*rows):
        assert got["path"] == want["path"] and len(want["boxes"]) > 0
        for key in ("boxes", "landmarks"):
            np.testing.assert_allclose(got[key], want[key], atol=0.011)
    assert os.path.getsize(tmp_path / "t.jsonl") > 0
