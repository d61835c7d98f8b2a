"""The port's spans and counters (``utils/profiling.py``), on the CPU at
tiny sizes.

Off (no profiler session), ``span`` hands back one shared no-op context
and nothing is recorded. Under ``torch.profiler`` (CPU activity) a serving
dispatch, a backbone training step and an ``extract_features`` call each
give their spans as top-level host events, in order, none of them a user
annotation (the kind the CUDA profiler copies onto the device's
timeline), with every ATen op of the call under one of them; the frames'
upload is counted at the bytes that cross; the results are bit-equal
with and without the profiler; ``trace``'s Chrome trace names the spans.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    extract,
    models,
    train,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    serve_demo,
    train_backbone,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    pipeline as serve_pipeline,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.utils import (
    profiling,
)

SERVE_SPANS = ["serve.upload", "serve.stage1", "serve.stage2",
               "serve.stage3", "serve.crop", "serve.embed", "serve.match"]
TRAIN_SPANS = ["train.batch", "train.upload", "train.forward", "train.loss",
               "train.backward", "train.optimizer"]
EXTRACT_SPANS = ["extract.slice", "extract.upload", "extract.forward",
                 "extract.readback"]
H, W, STREAMS = 48, 64, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _root(ev):
    while ev.cpu_parent is not None:
        ev = ev.cpu_parent
    return ev


def _assert_spans_cover(events, names, units=1):
    """The spans are the only top-level events, in order, ``units`` times;
    none is a user annotation and every ATen op is under one of them."""
    top = [ev for ev in events if ev.cpu_parent is None]
    assert [ev.name for ev in top] == names * units
    assert not any(ev.is_user_annotation for ev in top)
    aten = [ev for ev in events if ev.name.startswith("aten::")]
    assert aten
    assert {_root(ev).name for ev in aten} <= set(names)


@pytest.fixture(scope="module")
def serve_parts():
    args = serve_demo.parse_args([
        "--streams", str(STREAMS), "--frame-size", str(H), str(W),
        "--image-size", "32", "--num-classes", "10", "--identities", "50",
        "--det-thresholds", "0.3", "0.3", "0.3", "--device", "cpu"])
    dev = torch.device("cpu")
    model = serve_demo._embed_model(args, dev)
    det = serve_demo._detector(args, dev)
    gallery = np.random.default_rng(0).normal(size=(50, 342)).astype(
        np.float32)
    frames = np.random.default_rng(1).integers(
        0, 256, size=(STREAMS, H, W, 3), dtype=np.uint8)
    return det, model, gallery, frames


def _pipe(serve_parts, max_faces):
    det, model, gallery, _ = serve_parts
    return serve_pipeline.make_multistream_pipeline(
        det, model, gallery, frame_h=H, frame_w=W, embed_size=32,
        thresholds=(0.3, 0.3, 0.3), max_faces=max_faces, device="cpu")


def _state(seed=0):
    model = models.model_by_name(
        "lightcnn29", 40, input_hw=(32, 32),
        generator=torch.Generator().manual_seed(seed), device="cpu")
    tx = train.backbone_optimizer("adam", base_lr=1e-3, decay_every_steps=10,
                                  factor=0.9, weight_decay=0.0)
    return train.create_train_state(model, tx, seed)


def _batches():
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(12, 32, 32, 1), dtype=np.uint8)
    labels = np.repeat(np.arange(6), 2)
    batcher = train_backbone.make_batcher(
        images, labels, 4, argparse.Namespace(seed=0, shuffle_window=64),
        True)
    return iter(train_backbone.MirrorBatches(batcher, True, 0))


def _train_step(state, batches):
    step = train.make_backbone_train_step(margin=0.2, alpha=0.1,
                                          mining_mode="semi_hard_fused")
    anc, pos, lab = next(batches)
    return step(state, anc, pos, lab)


def _extract_model():
    model = models.model_by_name(
        "lightcnn29", 40, input_hw=(32, 32),
        generator=torch.Generator().manual_seed(1), device="cpu")
    images = np.random.default_rng(2).integers(
        0, 256, size=(10, 32, 32, 1), dtype=np.uint8)
    return model, images


def test_span_off_is_one_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = profiling.span("serve.upload"), profiling.span("train.loss")
    assert a is b
    before = (list(profiling._RECORDER.spans), profiling.counters())
    with a:
        profiling.count("serve.upload_bytes", 10)
    assert (list(profiling._RECORDER.spans), profiling.counters()) == before


def test_span_is_off_while_compiling(monkeypatch):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("x") is profiling.span("y")
        profiling.count("compiling", 1)
        assert "compiling" not in profiling.counters()


@pytest.mark.parametrize("max_faces", [0, 2], ids=["best_face", "multiface"])
def test_serving_dispatch_spans(serve_parts, max_faces):
    pipe = _pipe(serve_parts, max_faces)
    frames = serve_parts[3]
    want = pipe(frames)
    got, events = _profiled(lambda: pipe(frames))
    _assert_spans_cover(events, SERVE_SPANS)
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(want[k], got[k]), k


@pytest.mark.parametrize("source,itemsize", [
    ("numpy", 1), ("cpu_tensor", 1), ("float32_numpy", 4)])
def test_upload_bytes_counts_the_copy(serve_parts, source, itemsize):
    """Host frames are counted at the bytes that cross: uint8 frames in
    uint8 (they are widened after the copy), float32 frames in float32."""
    pipe = _pipe(serve_parts, 0)
    frames = serve_parts[3]
    if source == "cpu_tensor":
        frames = torch.from_numpy(frames)
    elif source == "float32_numpy":
        frames = frames.astype(np.float32)
    _profiled(lambda: pipe(frames))
    assert profiling.counters() == {
        "serve.upload_bytes": STREAMS * H * W * 3 * itemsize}
    # a later session holds only its own counts
    _profiled(lambda: pipe(frames[:1]))
    assert profiling.counters() == {"serve.upload_bytes": H * W * 3 * itemsize}


def test_train_step_spans_and_bit_equal():
    plain, traced = _state(), _state()
    plain, want = _train_step(plain, _batches())
    batches = _batches()
    (traced, got), events = _profiled(lambda: _train_step(traced, batches))
    _assert_spans_cover(events, TRAIN_SPANS)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    for (k, p), q in zip(plain.model.named_parameters(),
                         traced.model.parameters()):
        assert torch.equal(p, q), k


def test_extract_spans_and_bit_equal():
    model, images = _extract_model()
    want = extract.extract_features(model, images, batch_size=4)
    got, events = _profiled(
        lambda: extract.extract_features(model, images, batch_size=4))
    # 10 rows at batch 4: three batches, the last padded
    _assert_spans_cover(events, EXTRACT_SPANS, units=3)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[3], got[3])


def test_span_device_ms_is_none_on_the_cpu(serve_parts):
    pipe = _pipe(serve_parts, 0)
    _profiled(lambda: pipe(serve_parts[3]))
    assert profiling.span_device_ms() is None


def test_trace_chrome_trace_names_the_spans(tmp_path):
    model, images = _extract_model()
    with profiling.trace(str(tmp_path / "tr")) as d:
        extract.extract_features(model, images[:4], batch_size=4)
    with open(os.path.join(d, "trace.json")) as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert set(EXTRACT_SPANS) <= names
