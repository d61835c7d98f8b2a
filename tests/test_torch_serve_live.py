"""The port's live-recognition stack against the JAX package's, on the CPU.

The weights are made from seeds with numpy in the JAX layouts and carried
into the port (``from_jax_params``; the MTCNN det*.npy layout), and the
demos of both packages are handed the same nets. Frames are 64x80, crops
32x32, cascade thresholds 0.05 (random MTCNN nets fire on every frame).

- ``make_multiface_pipeline``, baked and dynamic (an f32 gallery at
  ``max_faces`` 1, int8 at 4), and the multi-stream multi-face batch against
  the JAX single-frame multiface pipeline: ``found``, ``indices``,
  ``cap_dropped`` and ``topk_dropped`` equal, boxes within 1e-3 and
  similarities and embeddings within 1e-4 where a face was found (f32
  convolutions summed in another order on each side).
- ``detect_faces_bulk`` over three resolution buckets.
- ``RecognitionService`` and ``VideoProducer`` over a cv2-written video.
- Each ``serve_demo`` mode against the JAX demo. The drop-stale queue
  makes the set of frames each run identifies depend on speed, so two
  runs are compared on the frames both identified: names equal and
  similarities within 1e-4 (1e-3 where a demo prints three decimals);
  the native modes call the same C++ library on both sides and are
  exact.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    serve_demo as jdemo,
    train_backbone as jtrain_backbone,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    pipeline as jdetect_pipeline,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.extract import (
    make_extract_fn as j_extract_fn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    pipeline as jpipe,
    recognition as jrec,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
    export_mtcnn,
    export_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    serve_demo as tdemo,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    MTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.bulk import (
    detect_faces_bulk,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
    make_extract_fn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    native as tnative,
    pipeline as tpipe,
    recognition as trec,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.device_gallery import (
    DeviceGallery,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.video import (
    VideoProducer,
    write_test_video,
)
from _torch_ties import (
    assert_cascade_margins,
    assert_face_rank_margins,
    assert_gallery_margins,
    assert_host_nms_margins,
    assert_largest_face_margins,
    int8_margins,
    record_cascade_nms,
    record_host_nms,
    rounding_ties,
    unit_rows,
)
from _torch_weights import flax_params, mtcnn_params

H, W, S = 64, 80, 32
TH = (0.05, 0.05, 0.05)
KW = dict(frame_h=H, frame_w=W, embed_size=S, thresholds=TH,
          sim_threshold=-1.0)


def _frames(seed, n):
    return (np.random.default_rng(seed).random((n, H, W, 3)) * 255).astype(
        np.float32)


def _scene(seed):
    """A smooth 64x80 scene (8x8 blocks): MJPG keeps it nearly intact."""
    base = np.random.default_rng(seed).uniform(40, 210, (8, 10, 3))
    return np.kron(base, np.ones((8, 8, 1))).astype(np.uint8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools would oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def nets():
    """(JAX detector, JAX model, params, port detector, port model)."""
    det_params = [mtcnn_params(spec, seed=i) for i, spec in enumerate(
        (jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC, jmtcnn._ONET_SPEC))]
    for p in det_params:                   # the JAX init's zero biases
        for entry in p.values():
            if "biases" in entry:
                entry["biases"][:] = 0.0
            if "alpha" in entry:
                entry["alpha"][:] = 0.25
    jdet = jdetect_pipeline.MTCNNDetector(
        *[jmtcnn.load_npy_params(p) for p in det_params])
    model = JEFMNet342(num_classes=4)
    params = flax_params(model, S, seed=0)
    tdet = MTCNNDetector(*det_params, device="cpu")
    tmodel = from_jax_params(params, device="cpu")
    return jdet, model, params, tdet, tmodel


CASCADE_TH = [TH[0], TH[0], TH[1], TH[2]]   # the threshold of each NMS


@pytest.fixture
def nms_calls(monkeypatch):
    """Both cascades' NMS inputs (``_torch_ties.record_cascade_nms``): the
    JAX pipelines a test builds and traces report them."""
    return record_cascade_nms(monkeypatch)


def _assert_face_margins(nms_calls, jax_calls, frames, got, want, rows_n,
                         rows=None):
    """The margins of a multiface comparison: the port's last cascade run
    against ``jax_calls`` (the JAX runs of the same ``frames`` frames;
    ``_torch_ties.assert_cascade_margins``, which also keeps apart the
    final scores that pick the ``max_faces``), then the gallery match of
    each found face. An f32 gallery (``rows_n``, the stored rows, the
    first ``rows`` of them valid): the best row leads the next by more
    than the two sides' similarities differ. An int8 gallery: both sides
    narrow the embeddings to the same int8 codes
    (``_torch_ties.int8_margins``), so their integer products are equal."""
    port = nms_calls[0]
    assert_cascade_margins(port[-len(CASCADE_TH):], jax_calls, frames,
                           CASCADE_TH)
    found = np.concatenate([np.asarray(x["found"]).reshape(-1)
                            for x in got])
    emb, wemb = (np.stack([np.asarray(x["embeddings"], np.float64)
                           for x in side]).reshape(found.size, -1)[found]
                 for side in (got, want))
    assert_gallery_margins(emb, wemb, rows_n, rows)


def _same_faces(got, want):
    found = np.asarray(want["found"])
    for key in ("found", "indices", "cap_dropped", "topk_dropped"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(np.asarray(got["boxes"])[found],
                               np.asarray(want["boxes"])[found], atol=1e-3)
    for key in ("similarities", "embeddings", "scores"):
        np.testing.assert_allclose(np.asarray(got[key])[found],
                                   np.asarray(want[key])[found], atol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("max_faces", [1, 4])
def test_multiface_pipeline_matches_jax(nets, max_faces, nms_calls):
    """Baked and dynamic (f32 or int8 rows, with a ``rows`` mask), one
    frame and a batch of frames: every output of the port equals the JAX
    single-frame multiface pipeline's, each comparison after the margins
    that keep rounding from deciding it (``_assert_face_margins``)."""
    jdet, model, params, tdet, tmodel = nets
    gallery = np.random.default_rng(5).normal(size=(6, 342))
    gallery_n = gallery / np.linalg.norm(gallery, axis=1, keepdims=True)
    kw = dict(KW, max_faces=max_faces)
    jfn = jpipe.make_multiface_pipeline(jdet, model, {"params": params},
                                        gallery, **kw)
    frames = _frames(3, 3)
    for calls in nms_calls:
        calls.clear()
    want = [jfn(jnp.asarray(f)) for f in frames]
    jax_calls = list(nms_calls[1])
    assert all(bool(w["found"].any()) for w in want)
    if max_faces > 1:
        assert int(want[0]["found"].sum()) > 1
    tfn = tpipe.make_multiface_pipeline(tdet, tmodel, gallery, device="cpu",
                                        **kw)
    got = {k: v.numpy() for k, v in tfn(frames[0]).items()}
    assert got["boxes"].shape == (max_faces, 4)
    assert got["embeddings"].shape == (max_faces, 342)
    _assert_face_margins(nms_calls, jax_calls[:len(CASCADE_TH)], 1, [got],
                         want[:1], gallery_n)
    _same_faces(got, want[0])
    # multi-stream x multi-face: one batch, the same per frame
    batched = tpipe.make_multistream_pipeline(
        tdet, tmodel, gallery, device="cpu", **kw)(frames)
    assert batched["boxes"].shape == (3, max_faces, 4)
    _assert_face_margins(
        nms_calls, jax_calls, 3,
        [{k: v[i].numpy() for k, v in batched.items()} for i in range(3)],
        want, gallery_n)
    for i in range(3):
        _same_faces({k: v[i].numpy() for k, v in batched.items()}, want[i])
    # the dynamic gallery (f32 rows with one face, int8 with four) equals
    # JAX's; rows past ``rows`` never win
    jdyn = jpipe.make_multiface_pipeline(jdet, model, {"params": params},
                                         None, dynamic_gallery=True, **kw)
    tdyn = tpipe.make_multiface_pipeline(tdet, tmodel, dynamic_gallery=True,
                                         device="cpu", **kw)
    jdt, tdt = ((jnp.float32, torch.float32) if max_faces == 1
                else (jnp.int8, torch.int8))
    dg = DeviceGallery(342, capacity=8, initial=gallery, dtype=tdt,
                       device="cpu")
    for rows in (6, 4):
        nms_calls[1].clear()
        w = jdyn(jnp.asarray(frames[1]), jpipe.normalize_gallery(gallery, jdt),
                 jnp.int32(rows))
        g = tdyn(frames[1], dg.gallery_n, torch.tensor(rows, dtype=torch.int32))
        _assert_face_margins(nms_calls, nms_calls[1], 1, [g], [w],
                             dg.gallery_n.numpy(), rows)
        _same_faces({k: v.numpy() for k, v in g.items()}, w)
        assert (g["indices"].numpy() < rows).all()


def test_multiface_limits(nets):
    _, _, _, tdet, tmodel = nets
    with pytest.raises(ValueError, match="64"):
        tpipe.make_multiface_pipeline(tdet, tmodel, np.ones((1, 342)),
                                      max_faces=65, device="cpu", **KW)
    # int8_embed is ported (tests/test_torch_quantized_serve.py)
    for maker in (tpipe.make_multiface_pipeline,
                  tpipe.make_multistream_pipeline):
        assert callable(maker(tdet, tmodel, np.ones((1, 342)),
                              int8_embed=True, device="cpu", **KW))


def _record_nms(monkeypatch, bulk_module):
    """Record every NMS a bulk detector runs, as ``(bucket (h, w), its
    candidates [n, 5+])``: the bucket is the last one whose pyramid
    scales the detector asked for."""
    calls, bucket = [], {}
    nms, scales = bulk_module.nms, bulk_module.pyramid_scales

    def recorded_scales(h, w, *args, **kwargs):
        bucket["hw"] = (h, w)
        return scales(h, w, *args, **kwargs)

    def recorded_nms(boxes, threshold, method="Union"):
        calls.append((bucket["hw"], np.array(boxes)))
        return nms(boxes, threshold, method)

    monkeypatch.setattr(bulk_module, "pyramid_scales", recorded_scales)
    monkeypatch.setattr(bulk_module, "nms", recorded_nms)
    return calls


def _run_jax_nets(tdet, jdet):
    """A ``_run`` for the port's detector that runs the JAX detector's
    nets on the same inputs, as the JAX bulk detector calls them."""
    def run(net, x):
        x = np.asarray(x, np.float32)
        if net is tdet.pnet:
            return tuple(np.asarray(o)
                         for o in jdet._pnet(jdet.pnet_params, x))
        if net is tdet.rnet:
            return jdet._run_batched(jdet._rnet, jdet.rnet_params, x)
        return jdet._run_batched(jdet._onet, jdet.onet_params, x)
    return run


def _same_detections(got, want):
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        if w is not None:
            assert g[0].shape == w[0].shape
            np.testing.assert_allclose(g[0], w[0], atol=1e-3)
            np.testing.assert_allclose(g[1], w[1], atol=1e-3)


def test_detect_faces_bulk_matches_jax(monkeypatch):
    """The bulk detector over three resolution buckets against the JAX
    one. The nets keep their random biases and the thresholds are 0.3, as
    in tests/test_torch_align.py.

    On the two 64x64 images and the 48x56 one the scores spread: every
    NMS of both sides sees the same candidates, no two with different
    boxes within their own rounding (``_torch_ties.rounding_ties``) and no
    final score within 1e-5 of the threshold, so the detections are held
    to JAX's as they are (boxes and points within 1e-3, the same images
    without a face). On the blank 48x48 frame every PNet window scores the
    same within rounding, and the order of those ties, which rounding
    decides, picks the boxes every NMS keeps. For that frame the port's
    bookkeeping runs on the JAX nets' outputs (the port detector's
    ``_run`` routed to them) and is held to JAX's at the same tolerances;
    it is held so on the other images too."""
    from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
        bulk as jbulk,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        bulk as tbulk,
    )

    params = [mtcnn_params(spec, seed=i) for i, spec in enumerate(
        (jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC, jmtcnn._ONET_SPEC))]
    jdet = jdetect_pipeline.MTCNNDetector(
        *[jmtcnn.load_npy_params(p) for p in params])
    tdet = MTCNNDetector(*params, device="cpu")
    rng = np.random.default_rng(0)
    images = [(rng.random((64, 64, 3)) * 255).astype(np.uint8)
              for _ in range(2)] + [
        np.zeros((48, 48, 3), np.uint8),
        (rng.random((48, 56)) * 255).astype(np.uint8)]
    th = (0.3, 0.3, 0.3)
    tcalls = _record_nms(monkeypatch, tbulk)
    jcalls = _record_nms(monkeypatch, jbulk)
    got = detect_faces_bulk(images, detector=tdet, thresholds=th)
    want = jbulk.detect_faces_bulk(images, detector=jdet, thresholds=th)
    assert sum(w is not None for w in want) >= 2

    tied = set()
    for hw in {im.shape[:2] for im in images}:
        tc = [c for b, c in tcalls if b == hw]
        jc = [c for b, c in jcalls if b == hw]
        assert tc and jc, hw
        if rounding_ties(tc[0][:, 4], jc[0][:, 4], tc[0][:, :4]):
            tied.add(hw)
            continue
        assert len(tc) == len(jc), hw
        for k, (t, j) in enumerate(zip(tc, jc)):
            assert t.shape == j.shape, (hw, k)
            np.testing.assert_allclose(t[:, :4], j[:, :4], atol=1e-3,
                                       err_msg=f"{hw} NMS {k}")
            ties = rounding_ties(t[:, 4], j[:, 4], t[:, :4])
            assert not ties, (hw, k, ties[:5])
    assert tied == {(48, 48)}
    _same_detections(
        [g for g, im in zip(got, images) if im.shape[:2] not in tied],
        [w for w, im in zip(want, images) if im.shape[:2] not in tied])
    for w, im in zip(want, images):
        if w is not None and im.shape[:2] not in tied:
            assert np.all(np.abs(w[0][:, 4] - th[2]) > 1e-5)

    monkeypatch.setattr(tdet, "_run", _run_jax_nets(tdet, jdet))
    routed = detect_faces_bulk(images, detector=tdet, thresholds=th)
    assert routed[2] is not None
    _same_detections(routed, want)


def test_recognition_service_and_video_producer(nets, tmp_path):
    """A cv2-written video through ``VideoProducer`` into the port's
    ``RecognitionService`` (drop-stale: the freshest frame wins); then the
    same frames pushed one by one through the port's service and the JAX
    one with the same weights: equal registrations and matches."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.synthetic import (
        synthetic_faces,
    )

    _, model, params, _, tmodel = nets
    imgs, _ = synthetic_faces(num_ids=1, per_id=10, size=S, seed=3)
    path = str(tmp_path / "cam.avi")
    assert write_test_video(path, imgs[..., 0], fps=10) == 10
    t_extract = make_extract_fn(tmodel)
    j_extract = j_extract_fn(model, normalize=True)

    def t_embed(x):
        return t_extract(torch.as_tensor(np.asarray(x, np.float32)))[1].numpy()

    def j_embed(x):
        return np.asarray(j_extract({"params": params},
                                    np.asarray(x, np.float32))[1])

    with trec.RecognitionService(t_embed, str(tmp_path / "t.fjdb"), 342,
                                 sim_threshold=0.3,
                                 frame_shape=(S, S, 1)) as svc:
        with VideoProducer(path, svc, fps_cap=500.0) as producer:
            assert producer.finished.wait(20)
        assert producer.frames_pushed == 10
        flat, seq = svc.queue.consume(S * S, remove_old=True)
        assert seq == 9 and flat.shape == (S * S,)
    cap_frames = []
    import cv2

    cap = cv2.VideoCapture(path)
    ok, frame = cap.read()
    while ok:
        cap_frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)[..., None]
                          .astype(np.float32) / 255.0)
        ok, frame = cap.read()
    cap.release()
    results = []
    for rec, embed, side in ((trec, t_embed, "t"), (jrec, j_embed, "j")):
        with rec.RecognitionService(embed, str(tmp_path / f"{side}2.fjdb"),
                                    342, sim_threshold=0.3,
                                    frame_shape=(S, S, 1)) as svc:
            stored = svc.register("alice", np.stack(cap_frames[:3]))
            ids = []
            for seq, f in enumerate(cap_frames[3:]):
                svc.push_frame(f, seq=seq)
                ids.append(svc.identify_latest())
            assert svc.sm.state == "Identification"
            results.append((stored, ids))
    (t_stored, t_ids), (j_stored, j_ids) = results
    # one identity: only the 0.3 threshold decides a name, and every
    # similarity clears it by far more than the 1e-4 they are held to
    assert min(s for _, s, _ in j_ids) > 0.3 + 1e-4
    assert t_stored == j_stored >= 1
    assert [(n, s) for n, _, s in t_ids] == [(n, s) for n, _, s in j_ids]
    assert all(n == "alice" for n, _, _ in t_ids)
    np.testing.assert_allclose([s for _, s, _ in t_ids],
                               [s for _, s, _ in j_ids], atol=1e-4)


# ------------------------------------------------------------- serve_demo


class _Fixed:
    """A JAX model whose ``init`` returns the given variables."""

    def __init__(self, model, variables):
        self._model, self._variables = model, variables

    def init(self, *args, **kwargs):
        return self._variables

    def __getattr__(self, name):
        return getattr(self._model, name)


@pytest.fixture
def same_nets(nets, monkeypatch):
    """Both demos build the fixture's nets: the JAX one through its own
    model factory and detector class, the port through its helpers."""
    jdet, model, params, tdet, tmodel = nets
    monkeypatch.setattr(jtrain_backbone, "_model_by_name",
                        lambda *a, **k: _Fixed(model, {"params": params}))
    monkeypatch.setattr(jdetect_pipeline, "MTCNNDetector",
                        lambda *a, **k: jdet)
    monkeypatch.setattr(tdemo, "_embed_model", lambda args, device: tmodel)
    monkeypatch.setattr(tdemo, "_detector", lambda args, device: tdet)
    return nets


def _both(argv, tmp_path, port_extra=("--device", "cpu")):
    """Run ``argv`` through the port's demo then the JAX one, each with its
    own store; returns (port result, JAX result)."""
    got = tdemo.main(argv + ["--store", str(tmp_path / "t.fjdb"),
                             *port_extra])
    want = jdemo.main(argv + ["--store", str(tmp_path / "j.fjdb")])
    return got, want


def _common_frames(got, want, atol):
    """Results ``[(seq, name, sim)]`` of two runs on the frames both
    identified."""
    g = {seq: (n, s) for seq, n, s in got}
    w = {seq: (n, s) for seq, n, s in want}
    both = sorted(set(g) & set(w))
    assert both, (sorted(g), sorted(w))
    for seq in both:
        assert g[seq][0] == w[seq][0], seq
        assert abs(g[seq][1] - w[seq][1]) <= atol, seq
    return both


def _printed_frames(text):
    """{seq: (name, sim)} from the default mode's printed lines."""
    return {int(m[1]): (m[2], float(m[3])) for m in re.finditer(
        r"frame +(\d+): (\S+) \(sim ([-+.\d]+)\)", text)}


def _assert_camera_margins(nets, argv):
    """The margins of the camera mode's decisions, from both demos'
    embeddings of its synthetic faces (each identity's first four enroll,
    frames come from all six): the representatives' selection (cosine
    0.98) and the store's deduplication (0.99999) are decided by more than
    the two sides' cosines differ; and every face's similarity to each
    enrolled face of its own identity beats its similarity to any other
    identity's by more than twice that, so whichever faces enroll, the
    name and the 0.6 threshold are decided alike."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.synthetic import (
        synthetic_faces,
    )

    _, model, params, _, tmodel = nets
    targs = tdemo.parse_args(argv + ["--device", "cpu"])
    jargs = jdemo.build_parser().parse_args(argv)
    imgs, labels = synthetic_faces(num_ids=targs.identities, per_id=6,
                                   size=S, seed=targs.seed)
    cos = [unit_rows(e) @ unit_rows(e).T for e in (
        tdemo._make_embed_fn(targs, tmodel, torch.device("cpu"))(imgs),
        jdemo._make_embed_fn(jargs, model, {"params": params})(imgs))]
    err = np.abs(cos[0] - cos[1])
    enrolled = np.concatenate([np.flatnonzero(labels == i)[:4]
                               for i in range(targs.identities)])
    pairs = np.ix_(enrolled, enrolled)
    off = ~np.eye(len(enrolled), dtype=bool)
    for th in (0.98, 0.99999):
        assert (np.abs(cos[0][pairs] - th) > err[pairs])[off].all(), th
    sims, owners = cos[0][:, enrolled], labels[enrolled]
    for s, who in zip(sims, labels):
        assert s[owners == who].min() - s[owners != who].max() \
            > 2 * err.max()
    assert sims.min() > targs.sim_threshold + err.max()


def test_serve_demo_camera_mode_matches_jax(same_nets, tmp_path, capsys):
    argv = ["--image-size", str(S), "--identities", "3", "--frames", "10"]
    _assert_camera_margins(same_nets, argv)
    tdemo.main(argv + ["--store", str(tmp_path / "t.fjdb"), "--device",
                       "cpu"])
    got = capsys.readouterr().out
    correct, seen = jdemo.main(argv + ["--store", str(tmp_path / "j.fjdb")])
    want = capsys.readouterr().out
    assert re.findall(r"enrolled .*", got) == re.findall(r"enrolled .*",
                                                         want)
    g, w = _printed_frames(got), _printed_frames(want)
    both = set(g) & set(w)
    assert both and correct == seen >= 1
    for seq in both:
        assert g[seq][0] == w[seq][0]
        assert abs(g[seq][1] - w[seq][1]) <= 1e-3


def test_serve_demo_video_mode_matches_jax(same_nets, tmp_path):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.synthetic import (
        synthetic_faces,
    )

    imgs, _ = synthetic_faces(num_ids=1, per_id=24, size=S, seed=3)
    path = str(tmp_path / "cam.avi")
    write_test_video(path, imgs[..., 0])
    got, want = _both(["--video", path, "--image-size", str(S),
                       "--register-name", "alice", "--register-frames", "3",
                       "--sim-threshold", "0.3", "--fps-cap", "25"],
                      tmp_path)
    _common_frames(got, want, 1e-4)
    assert all(n == "alice" for _, n, _ in got)
    # one identity: only the threshold decides a name, by far
    assert min(s for _, _, s in want) > 0.3 + 1e-4


def _scene_video(tmp_path, n, name="scene.avi", seed=42):
    path = str(tmp_path / name)
    write_test_video(path, np.stack([_scene(seed)] * n))
    return path


DETECT = ["--detect", "--frame-size", str(H), str(W), "--image-size", str(S),
          "--det-thresholds", *map(str, TH), "--sim-threshold", "0.3",
          "--fps-cap", "25"]


def test_serve_demo_video_detect_matches_jax(same_nets, tmp_path, nms_calls,
                                            monkeypatch):
    """--video --detect with the baked gallery built from the host
    cascade's registration crops. The scene's margins: its host cascade
    (the registration crops), its device cascade and the largest-centered
    face the fused pipeline picks."""
    path = _scene_video(tmp_path, 16)
    frame = _assert_video_margins(same_nets, nms_calls, path, 1, False)
    assert_largest_face_margins(*nms_calls, 1, H, W)
    host = record_host_nms(monkeypatch)
    jdet, _, _, tdet, _ = same_nets
    got, want = (d.detect(frame, thresholds=TH)[0] for d in (tdet, jdet))
    assert_host_nms_margins(*host)
    assert_face_rank_margins(got, want, H, W)
    got, want = _both(["--video", path, *DETECT, "--register-name", "alice",
                       "--register-frames", "2"], tmp_path)
    _common_frames(got, want, 1e-4)
    assert all(n == "alice" for _, n, _ in got)
    # one identity: only the threshold decides a name, by far
    assert min(s for _, _, s in want) > 0.3 + 1e-4


def _assert_video_margins(nets, nms_calls, path, max_faces, int8):
    """The margins of a ``--video --detect`` run's decisions on the frame
    of ``path`` (every frame is one scene), read as the demos read it:
    both multiface pipelines over it with no detection decision within
    rounding, and (``int8``) both sides narrowing the found faces'
    embeddings to the same int8 codes, so that the int8 matches are
    exact. Returns the frame."""
    import cv2

    jdet, model, params, tdet, tmodel = nets
    cap = cv2.VideoCapture(path)
    ok, frame = cap.read()
    cap.release()
    assert ok
    frame = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32)
    frame = frame / 255.0 * 255.0
    kw = dict(KW, thresholds=TH, max_faces=max_faces, dynamic_gallery=True)
    rows = np.ones((1, 342), np.float32)
    for calls in nms_calls:
        calls.clear()
    want = jpipe.make_multiface_pipeline(jdet, model, {"params": params},
                                         None, **kw)(
        jnp.asarray(frame), jpipe.normalize_gallery(rows, jnp.int8),
        jnp.int32(1))
    got = tpipe.make_multiface_pipeline(tdet, tmodel, device="cpu", **kw)(
        frame, tpipe.normalize_gallery(rows, torch.int8, device="cpu"),
        torch.tensor(1, dtype=torch.int32))
    assert_cascade_margins(*nms_calls, 1, CASCADE_TH)
    found = np.asarray(want["found"])
    assert found.any()
    if int8:
        assert int8_margins(got["embeddings"].numpy()[found],
                            np.asarray(want["embeddings"])[found]) > 0
    return frame


def test_serve_demo_person_db_multiface_int8_matches_jax(same_nets,
                                                         tmp_path,
                                                         nms_calls):
    """--video --detect --max-faces 4 --dynamic-gallery --person-db
    --gallery-dtype int8: enrollment writes through to a person DB (the
    port's run writes it), then each demo identifies a copy of that DB
    with --register-frames 0. The int8 products are exact on both sides."""
    import shutil

    alice = _scene_video(tmp_path, 12, "alice.avi", seed=1)
    bob = _scene_video(tmp_path, 12, "bob.avi", seed=2)
    db = str(tmp_path / "people.sqlite")
    common = [*DETECT, "--max-faces", "4", "--dynamic-gallery",
              "--gallery-dtype", "int8"]
    for name, path in (("alice", alice), ("bob", bob)):
        res = tdemo.main(["--video", path, "--person-db", db,
                          "--register-name", name, "--register-frames", "2",
                          "--store", str(tmp_path / f"{name}.fjdb"),
                          "--device", "cpu", *common])
        assert res
    shutil.copy(db, tmp_path / "j.sqlite")
    _assert_video_margins(same_nets, nms_calls, alice, 4, True)
    got = tdemo.main(["--video", alice, "--person-db", db,
                      "--register-frames", "0", "--store",
                      str(tmp_path / "t.fjdb"), "--device", "cpu", *common])
    want = jdemo.main(["--video", alice, "--person-db",
                       str(tmp_path / "j.sqlite"), "--register-frames", "0",
                       "--store", str(tmp_path / "j.fjdb"), *common])
    _common_frames(got, want, 1e-4)
    # random nets embed every scene nearly alike: any enrolled person
    assert {n for _, n, _ in got} <= {"alice", "bob"} and got


def test_serve_demo_streams_dynamic_gallery_matches_jax(same_nets, tmp_path,
                                                        capsys, nms_calls):
    """--streams with the gallery in a DeviceGallery (int8 rows): the same
    per-stream lines as the JAX demo. The demo's frames, drawn from its
    seed, go first through the port's pipeline and the JAX single-frame
    one: no detection decision within rounding, and both sides narrow the
    faces' embeddings to the same int8 codes, so their int8 matches are
    exact."""
    argv = ["--streams", "2", "--frames", "2", "--frame-size", str(H),
            str(W), "--image-size", str(S), "--det-thresholds", *map(str, TH),
            "--identities", "5", "--dynamic-gallery", "--gallery-dtype",
            "int8"]
    jdet, model, params, tdet, tmodel = same_nets
    pipe, frames = tdemo.build_streams(tdemo.parse_args(argv + [
        "--device", "cpu"]))
    jfn = jpipe.make_recognition_pipeline(
        jdet, model, {"params": params}, None, dynamic_gallery=True,
        frame_h=H, frame_w=W, embed_size=S, thresholds=TH)
    rows = jpipe.normalize_gallery(np.zeros((1, 342), np.float32) + 1.0)
    for calls in nms_calls:
        calls.clear()
    wants = [jfn(jnp.asarray(f), rows) for f in frames.numpy()]
    out = pipe(frames)
    assert_cascade_margins(*nms_calls, len(wants), CASCADE_TH)
    assert_largest_face_margins(*nms_calls, len(wants), H, W)
    found = out["found"].numpy()
    assert found.any()
    assert int8_margins(out["embedding"].numpy()[found], np.stack(
        [np.asarray(w["embedding"]) for w in wants])[found]) > 0
    res = tdemo.main(argv + ["--device", "cpu"])
    got = re.findall(r"stream +\d+: .*", capsys.readouterr().out)
    found, streams = jdemo.main(argv + ["--store", str(tmp_path / "j.fjdb")])
    want = re.findall(r"stream +\d+: .*", capsys.readouterr().out)
    assert got == want and len(got) == 2
    assert (res["found"], res["streams"]) == (found, streams) == (2, 2)


@pytest.fixture(scope="module")
def native_export(tmp_path_factory, nets):
    """The fixture's EFMNet342 as an export and its MTCNN as an
    ``export_mtcnn`` npz, for the native modes."""
    tnative.load_native()
    jdet, model, params, _, _ = nets
    d = tmp_path_factory.mktemp("native")
    export_params(str(d / "export"), params, model_name="efmnet342",
                  feature_dim=342, input_hw=(S, S), input_channels=1)
    export_mtcnn(str(d / "mtcnn.npz"), jdet.pnet_params, jdet.rnet_params,
                 jdet.onet_params)
    return str(d / "export"), str(d / "mtcnn.npz")


def test_serve_demo_native_modes_match_jax(same_nets, native_export,
                                           tmp_path, capsys):
    """--native (the default loop with the C++ forward) and --video
    --detect --native --native-mtcnn: the same C++ library on both sides,
    so equal results on the frames both identified."""
    export, npz = native_export
    argv = ["--image-size", str(S), "--identities", "3", "--frames", "8",
            "--export-dir", export, "--native"]
    tdemo.main(argv + ["--store", str(tmp_path / "t.fjdb"), "--device",
                       "cpu"])
    g = _printed_frames(capsys.readouterr().out)
    jdemo.main(argv + ["--store", str(tmp_path / "j.fjdb")])
    w = _printed_frames(capsys.readouterr().out)
    assert set(g) & set(w)
    assert all(g[s] == w[s] for s in set(g) & set(w))
    path = _scene_video(tmp_path, 12)
    got, want = _both(["--video", path, *DETECT, "--native",
                       "--native-mtcnn", npz, "--export-dir", export,
                       "--register-name", "alice", "--register-frames", "2"],
                      tmp_path)
    _common_frames(got, want, 0.0)
    assert got and all(n == "alice" for _, n, _ in got)


def test_serve_demo_flag_checks(tmp_path):
    """The JAX demo's flag checks: each exits before any device work."""
    for argv in (["--dynamic-gallery"],
                 ["--video", "x.avi", "--detect", "--native",
                  "--dynamic-gallery"],
                 ["--person-db", "p.sqlite"],
                 ["--streams", "2", "--dynamic-gallery", "--person-db", "p"],
                 ["--gallery-dtype", "int8"],
                 ["--video", "x.avi", "--detect", "--register-frames", "0"]):
        with pytest.raises(SystemExit):
            tdemo.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="--export-dir"):
        tdemo.main(["--native", "--image-size", "32", "--device", "cpu",
                    "--store", str(tmp_path / "x.fjdb")])
