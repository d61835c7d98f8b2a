"""The port's face alignment against the JAX package's, on the CPU: the
host cascade (``MTCNNDetector.detect``, with and without
``device_pyramid``), ``DeviceCascade`` (``detect`` and ``detect_batch``),
``select_main_face``, ``crop_face``, ``align_directory`` and the ``align``
CLI with ``--export-native-mtcnn``.

The MTCNN weights are made from seeds 0-2 with numpy in the det*.npy
layout and given to both packages; the frames are seeded noise at 64x64
and thresholds of 0.3, permissive enough that random weights detect.
Box and point coordinates match at atol 1e-3 (float32 convs summed in
another order on each side); counts, ``last_stats`` and the saturation
warnings must be equal. No score of these seeds lies within 1e-5 of a
threshold (checked), and ``_assert_detect_margins`` holds every NMS of both
cascades to the same candidates, none within its own rounding of another
(``tests/_torch_ties.py``), and the face ``select_main_face`` picks to a
lead over the next that the boxes' rounding cannot undo.

Crops and the ``bounding_boxes.txt`` log are compared EXACTLY. They
truncate ``det +- margin / 2`` to integers, so a box 1e-4 off an integer
could move a crop by a pixel: every box the test crops lies at least 1e-3
from an integer (checked).
"""

import os
import warnings

import cv2
import numpy as np
import pytest

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    align as jcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    align as jalign,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    MTCNNDetector as JDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect.device_cascade import (
    DeviceCascade as JCascade,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    align as tcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    align as talign,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    MTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_cascade import (
    DeviceCascade,
)
from _torch_ties import (
    assert_cascade_margins,
    assert_face_rank_margins,
    assert_host_nms_margins,
    record_cascade_nms,
    record_host_nms,
)
from _torch_weights import mtcnn_params

H = W = 64
TH = (0.3, 0.3, 0.3)
SPECS = (jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC, jmtcnn._ONET_SPEC)


def _frames(seed, n, h=H, w=W):
    return (np.random.default_rng(seed).random((n, h, w, 3)) * 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def dets():
    """(det*.npy-layout params, JAX detector, port detector)."""
    params = [mtcnn_params(spec, seed=i) for i, spec in enumerate(SPECS)]
    return (params, JDetector(*[jmtcnn.load_npy_params(p) for p in params]),
            MTCNNDetector(*params, device="cpu"))


def _assert_detect_margins(params, images, how):
    """The margins that keep rounding from deciding what the cascades
    detect in ``images``, on fresh detectors of both packages: ``how`` is
    ``host`` (the host cascade), ``pyramid`` (its device stage 1) or
    ``device`` (``DeviceCascade``). Every host NMS and every device NMS
    (``_torch_ties``) of each image, and the face ``select_main_face``
    picks among the detections."""
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        host = record_host_nms(mp)
        port, jax_calls = record_cascade_nms(mp)
        jdet = JDetector(*[jmtcnn.load_npy_params(p) for p in params])
        tdet = MTCNNDetector(*params, device="cpu")
        jc, tc = JCascade(jdet, thresholds=TH), DeviceCascade(
            tdet, thresholds=TH)
        device_th = [TH[0], TH[0]] + ([TH[1], TH[2]] if how == "device"
                                      else [])
        for img in images:
            if how == "device":
                got, want = tc.detect(img), jc.detect(img)
            else:
                pyr = how == "pyramid"
                got = tdet.detect(img, 20, TH, 0.709, pyr)
                want = jdet.detect(img, 20, TH, 0.709, pyr)
            if how != "host":
                n = len(device_th)
                assert_cascade_margins(port[-n:], jax_calls[-n:], 1,
                                       device_th)
            assert got[0].shape == want[0].shape
            assert_face_rank_margins(got[0], want[0], *img.shape[:2])
        assert_host_nms_margins(*host)


def _same_boxes(got, want):
    gb, gp = got
    wb, wp = want
    assert gb.shape == wb.shape and gp.shape == wp.shape
    assert wb.shape[0] > 0
    np.testing.assert_allclose(gb, wb, atol=1e-3)
    np.testing.assert_allclose(gp, wp, atol=1e-3)
    assert np.all(np.abs(wb[:, 4] - TH[2]) > 1e-5)


@pytest.mark.parametrize("device_pyramid", [False, True])
def test_host_cascade_matches_jax(dets, device_pyramid):
    params, jdet, tdet = dets
    _assert_detect_margins(
        params, [*_frames(0, 2), _frames(1, 1)[0, :, :, 0]],
        "pyramid" if device_pyramid else "host")
    for img in _frames(0, 2):
        _same_boxes(tdet.detect(img, 20, TH, 0.709, device_pyramid),
                    jdet.detect(img, 20, TH, 0.709, device_pyramid))
    gray = _frames(1, 1)[0, :, :, 0]        # [H, W]: repeated to 3 channels
    _same_boxes(tdet.detect(gray, 20, TH), jdet.detect(gray, 20, TH))


def _with_warnings(fn):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [(w.category, str(w.message)) for w in rec]


def test_device_cascade_matches_jax(dets):
    """``detect`` (one frame, grayscale too) and ``detect_batch`` (three
    frames): boxes, points [10, N], ``last_stats`` and the saturation
    warning. The first frames saturate stage 1's per-scale caps and the
    stage-3 input, the quiet frame saturates nothing."""
    params, jdet, tdet = dets
    jc, tc = JCascade(jdet, thresholds=TH), DeviceCascade(tdet, thresholds=TH)
    frames = _frames(0, 3)
    _assert_detect_margins(params, [*frames, frames[2, :, :, 0]], "device")
    want, jw = _with_warnings(lambda: jc.detect_batch(frames))
    got, tw = _with_warnings(lambda: tc.detect_batch(frames))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _same_boxes(g, w)
    assert tc.last_stats == jc.last_stats
    assert tc.last_stats["stage1_k_dropped"] > 0
    assert tw == jw and len(tw) == 1 and tw[0][0] is RuntimeWarning
    for img in (frames[1], frames[2, :, :, 0]):
        want, jw = _with_warnings(lambda: jc.detect(img))
        got, tw = _with_warnings(lambda: tc.detect(img))
        _same_boxes(got, want)
        assert tc.last_stats == jc.last_stats and tw == jw
    # a flat frame: no candidate survives, nothing dropped, no warning
    quiet = np.full((H, W, 3), 128, np.uint8)
    cq = (0.9, 0.9, 0.9)
    want, jw = _with_warnings(
        lambda: JCascade(jdet, thresholds=cq).detect(quiet))
    tq = DeviceCascade(tdet, thresholds=cq)
    got, tw = _with_warnings(lambda: tq.detect(quiet))
    assert got[0].shape == want[0].shape == (0, 5)
    assert got[1].shape == want[1].shape == (10, 0)
    assert tw == jw == []
    assert tq.last_stats == {"stage1_k_dropped": 0, "stage2_input_dropped": 0,
                             "stage3_input_dropped": 0, "detections": 0}


def test_select_and_crop_equal_jax():
    rng = np.random.default_rng(3)
    img = (rng.random((50, 70, 3)) * 255).astype(np.uint8)
    boxes = np.concatenate([rng.uniform(-5, 30, (6, 2)), rng.uniform(
        10, 40, (6, 2)), rng.random((6, 1))], 1)
    boxes[:, 2:4] += boxes[:, 0:2]
    for multiple in (False, True):
        for n in (1, 6):
            np.testing.assert_array_equal(
                talign.select_main_face(boxes[:n], img.shape, multiple),
                jalign.select_main_face(boxes[:n], img.shape, multiple))
    for det in boxes:
        for size, margin in ((32, 8), (40, 44)):
            got = talign.crop_face(img, det[:4], size, margin)
            want = jalign.crop_face(img, det[:4], size, margin)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


def _tree(root, n_ids=3, per_id=2):
    """An LFW-layout tree of seeded noise frames (one unreadable file)."""
    frames = _frames(4, n_ids * per_id)
    for i, img in enumerate(frames):
        name = f"Person_{chr(65 + i // per_id)}"
        os.makedirs(os.path.join(root, name), exist_ok=True)
        cv2.imwrite(os.path.join(root, name,
                                 f"{name}_{i % per_id + 1:04d}.png"), img)
    with open(os.path.join(root, "Person_A", "Person_A_0009.jpg"), "wb") as f:
        f.write(b"not an image")
    return root


def _read_tree(out):
    files = {}
    for dirpath, _, names in os.walk(out):
        for name in names:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, out)
            if name.endswith(".png"):
                files[rel] = cv2.imread(path)
            else:
                files[rel] = open(path).read().replace(out, "<out>")
    return files


def _detections_off_integers(boxes):
    """The corners of the boxes cropped lie at least 1e-3 from an integer,
    and so does ``det +- margin / 2`` for the even margins used here."""
    frac = np.abs(boxes[:, :4] - np.round(boxes[:, :4]))
    assert frac.min() >= 1e-3, frac.min()


@pytest.mark.parametrize("device_cascade", [False, True])
def test_align_directory_equals_jax(dets, tmp_path, device_cascade):
    """The same PNG names and pixels, the same ``bounding_boxes.txt`` lines
    and the same counts (the unreadable file skipped on both sides)."""
    params, jdet, tdet = dets
    src = _tree(str(tmp_path / "src"))
    _assert_detect_margins(params, _frames(4, 6),
                           "device" if device_cascade else "host")
    kw = dict(image_size=32, margin=8, thresholds=TH,
              device_cascade=device_cascade)
    jout, tout = str(tmp_path / "j"), str(tmp_path / "t")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want = jalign.align_directory(src, jout, jdet, **kw)
        got = talign.align_directory(src, tout, tdet, **kw)
    assert (got.total, got.aligned, got.skipped) == (
        want.total, want.aligned, want.skipped) == (7, 6, 1)
    # the boxes the crops come from lie off integers by >= 1e-3
    jc = JCascade(jdet, thresholds=TH)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for img in _frames(4, 6):
            boxes, _ = (jc.detect(img) if device_cascade
                        else jdet.detect(img, 20, TH))
            _detections_off_integers(
                jalign.select_main_face(boxes, img.shape))
    jfiles, tfiles = _read_tree(jout), _read_tree(tout)
    assert sorted(tfiles) == sorted(jfiles) and len(jfiles) == 7
    for k, v in jfiles.items():
        if isinstance(v, str):
            assert tfiles[k] == v, k
        else:
            np.testing.assert_array_equal(tfiles[k], v, err_msg=k)


def test_align_cli_and_native_export_equal_jax(dets, tmp_path, capsys):
    """``align --det-weights ... --export-native-mtcnn``: the same npz keys
    and arrays, the same printed counts and the same crops."""
    params, _, _ = dets
    weights = []
    for i, p in enumerate(params):
        path = str(tmp_path / f"det{i + 1}.npy")
        np.save(path, p, allow_pickle=True)
        weights.append(path)
    src = _tree(str(tmp_path / "src"))
    _assert_detect_margins(params, _frames(4, 6), "host")
    common = ["--image-size", "24", "--margin", "6", "--thresholds", "0.3",
              "0.3", "0.3", "--det-weights", *weights]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        jres = jcli.main([src, str(tmp_path / "j"), *common,
                          "--export-native-mtcnn", str(tmp_path / "j.npz")])
        jtext = capsys.readouterr().out
        tres = tcli.main([src, str(tmp_path / "t"), *common,
                          "--export-native-mtcnn", str(tmp_path / "t"),
                          "--device", "cpu"])
        ttext = capsys.readouterr().out
    assert (tres.total, tres.aligned) == (jres.total, jres.aligned)
    assert ttext.split("\n")[1:] == jtext.split("\n")[1:]
    assert "native MTCNN export: " + str(tmp_path / "t.npz") in ttext
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files) and len(j.files) == 50
        for k in j.files:
            assert t[k].dtype == j[k].dtype == np.float32
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    jfiles, tfiles = _read_tree(str(tmp_path / "j")), _read_tree(
        str(tmp_path / "t"))
    assert sorted(tfiles) == sorted(jfiles)
    for k, v in jfiles.items():
        if not isinstance(v, str):
            np.testing.assert_array_equal(tfiles[k], v, err_msg=k)
