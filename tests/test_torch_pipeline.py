"""The port's serving path against the JAX package's, on the CPU.

64x64 frames, embed size 32, cascade thresholds 0.05 and the seeds of
tests/test_fused_pipeline.py (weights 0, frames 0, 2 and 5), with the
weights made from those seeds with numpy in the JAX layouts and carried
into the port. Integer and boolean outputs (``found``, ``index``,
``cap_dropped``, the stage-1 and cascade validity) must be equal; boxes
match at atol 1e-3 and similarities and embeddings at 1e-4 (float32 convs
summed in another order on each side).

The two sides' convolutions round differently, so each comparison first
asserts the margins that keep rounding from deciding what it compares
(``tests/_torch_ties.py``): every NMS of both cascades sees the same valid
candidates, no two of them (with different boxes) within their own
rounding of each other and none within its rounding of its threshold, and
the final scores clear the last threshold by 1e-5; the face the pipelines
pick leads the runner-up by more than its boxes' rounding can move it, and
its best gallery row leads the next by more than the two sides'
similarities differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    MTCNNDetector as JMTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect.device_cascade import (
    make_device_cascade as j_cascade,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.detect.device_pnet import (
    make_device_stage1 as j_stage1,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    LightCNN9 as JLightCNN9,
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.pipeline import (
    make_recognition_pipeline as j_pipeline,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    serve_demo,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    MTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_cascade import (
    make_device_cascade,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_pnet import (
    make_device_stage1,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.pipeline import (
    make_multistream_pipeline,
    make_recognition_pipeline,
    normalize_gallery,
)
from _torch_ties import (
    assert_cascade_margins,
    assert_gallery_margins,
    assert_largest_face_margins,
    record_cascade_nms,
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


H = W = 64
TH = (0.05, 0.05, 0.05)
KW = dict(frame_h=H, frame_w=W, embed_size=32, thresholds=TH,
          sim_threshold=-1.0)


def _frames(seed, n):
    return (np.random.default_rng(seed).random((n, H, W, 3)) * 255).astype(
        np.float32)


@pytest.fixture(scope="module")
def nms_calls():
    """The NMS inputs of both packages' cascades (``record_cascade_nms``),
    recorded for the whole module: the JAX pipeline fixture is traced
    once, with the recording compiled in. Tests clear the lists."""
    with pytest.MonkeyPatch.context() as mp:
        yield record_cascade_nms(mp)


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
    jdet = JMTCNNDetector(*[jmtcnn.load_npy_params(p) for p in det_params])
    model = JEFMNet342(num_classes=4)
    params = flax_params(model, 32, seed=0)
    tdet = MTCNNDetector(*det_params, device="cpu")
    tmodel = from_jax_params(params, device="cpu")
    return jdet, model, params, tdet, tmodel


@pytest.fixture(scope="module")
def jax_pipeline(nets, nms_calls):
    jdet, model, params, _, _ = nets
    gallery = np.random.default_rng(5).normal(size=(5, 342))
    return gallery, j_pipeline(jdet, model, {"params": params}, gallery, **KW)


def _clear(nms_calls):
    for calls in nms_calls:
        calls.clear()


def test_device_stage1_matches_jax(nets, nms_calls):
    jdet, _, _, tdet, _ = nets
    _clear(nms_calls)
    frames = _frames(0, 2)
    jfn = j_stage1(jdet.pnet_params, H, W, threshold=TH[0], with_counts=True)
    tout, tdrop = make_device_stage1(tdet.pnet, H, W, threshold=TH[0],
                                     with_counts=True, device="cpu")(frames)
    jouts = [[np.asarray(a) for a in jfn(jnp.asarray(f))] for f in frames]
    # the per-scale and cross-scale NMS: no decision within rounding
    assert assert_cascade_margins(*nms_calls, 2, [TH[0]] * 2) > 2
    for i in range(2):
        jout, jdrop = jouts[i]
        got = tout[i].numpy()
        valid = np.isfinite(jout[:, 4])
        assert valid.any()
        np.testing.assert_array_equal(np.isfinite(got[:, 4]), valid)
        assert int(tdrop[i]) == int(jdrop)
        np.testing.assert_allclose(got[valid], jout[valid], atol=1e-4)
        # no score within 1e-5 of the threshold: rounding cannot flip one
        assert np.all(np.abs(jout[valid, 4] - TH[0]) > 1e-5)


def test_device_cascade_matches_jax(nets, nms_calls):
    jdet, _, _, tdet, _ = nets
    _clear(nms_calls)
    frames = _frames(2, 2)
    jfn = j_cascade(jdet.pnet_params, jdet.rnet_params, jdet.onet_params,
                    H, W, thresholds=TH)
    tboxes, tpts, tcounts = make_device_cascade(
        tdet.pnet, tdet.rnet, tdet.onet, H, W, thresholds=TH,
        device="cpu")(frames)
    jouts = [[np.asarray(a) for a in jfn(jnp.asarray(f))] for f in frames]
    assert assert_cascade_margins(*nms_calls, 2, CASCADE_TH) > 4
    for i in range(2):
        jboxes, jpts, jcounts = jouts[i]
        valid = np.isfinite(jboxes[:, 4])
        assert valid.any()
        np.testing.assert_array_equal(np.isfinite(tboxes[i, :, 4].numpy()),
                                      valid)
        np.testing.assert_array_equal(tcounts[i].numpy(), jcounts)
        np.testing.assert_allclose(tboxes[i].numpy()[valid], jboxes[valid],
                                   atol=1e-3)
        np.testing.assert_allclose(tpts[i].numpy()[valid], jpts[valid],
                                   atol=1e-3)
        assert np.all(np.abs(jboxes[valid, 4] - TH[2]) > 1e-5)


# the score threshold that let in the candidates of each NMS of a frame's
# cascade: stage 1's per-scale and cross-scale passes, stages 2 and 3
CASCADE_TH = [TH[0], TH[0], TH[1], TH[2]]


def _assert_pipeline_margins(nms_calls, frames, outs, wants, gallery):
    """The margins of a single-face pipeline comparison over ``frames``
    frames: the cascade's (``assert_cascade_margins``), the face it picks
    (``assert_largest_face_margins``) and the gallery row it matches
    (``assert_gallery_margins``, from ``outs`` and ``wants``)."""
    assert_cascade_margins(*nms_calls, frames, CASCADE_TH)
    assert_largest_face_margins(*nms_calls, frames, H, W)
    found = np.array([bool(o["found"]) for o in outs])
    emb, wemb = (np.stack([np.asarray(o["embedding"]) for o in side])[found]
                 for side in (outs, wants))
    assert_gallery_margins(
        emb, wemb, gallery / np.linalg.norm(gallery, axis=1, keepdims=True))


def _assert_same(got, want):
    for key in ("found", "index", "cap_dropped"):
        assert np.asarray(got[key]) == np.asarray(want[key]), key
    np.testing.assert_allclose(np.asarray(got["box"]), np.asarray(want["box"]),
                               atol=1e-3)
    for key in ("similarity", "embedding"):
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), atol=1e-4)


def test_recognition_pipeline_matches_jax(nets, jax_pipeline, nms_calls):
    _, _, _, tdet, tmodel = nets
    gallery, jfn = jax_pipeline
    tfn = make_recognition_pipeline(tdet, tmodel, gallery, device="cpu", **KW)
    frame = _frames(0, 1)[0]
    _clear(nms_calls)
    want = jfn(jnp.asarray(frame))
    assert bool(want["found"])
    got = {k: v.numpy() for k, v in tfn(frame).items()}
    assert got["box"].shape == (4,) and got["embedding"].shape == (342,)
    _assert_pipeline_margins(nms_calls, 1, [got], [want], gallery)
    _assert_same(got, want)


def test_multistream_pipeline_matches_jax(nets, jax_pipeline, nms_calls):
    """Every stream of the port's batched pipeline equals the JAX
    single-frame pipeline on that frame (which tests/test_fused_pipeline.py
    pins to the JAX multistream one); the dynamic gallery, f32 or bf16,
    with every row enrolled, gives the baked one's answers."""
    _, _, _, tdet, tmodel = nets
    gallery, jfn = jax_pipeline
    frames = _frames(5, 3)
    _clear(nms_calls)
    out = make_multistream_pipeline(tdet, tmodel, gallery, device="cpu",
                                    **KW)(frames)
    assert out["box"].shape == (3, 4) and out["embedding"].shape == (3, 342)
    wants = [jfn(jnp.asarray(f)) for f in frames]
    got = [{k: v[i].numpy() for k, v in out.items()} for i in range(3)]
    _assert_pipeline_margins(nms_calls, 3, got, wants, gallery)
    for i in range(3):
        _assert_same(got[i], wants[i])
    dyn = make_multistream_pipeline(tdet, tmodel, dynamic_gallery=True,
                                    device="cpu", **KW)
    for dtype, atol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        got = dyn(frames, normalize_gallery(gallery, dtype, device="cpu"), 5)
        np.testing.assert_array_equal(got["index"].numpy(),
                                      out["index"].numpy())
        np.testing.assert_allclose(got["similarity"].numpy(),
                                   out["similarity"].numpy(), atol=atol)


class _ScalarCreations(torch.overrides.TorchFunctionMode):
    """Counts the 0-d tensors that creation functions make: each is a
    host-to-device copy (and a stream synchronization) on the card."""

    CREATORS = {torch.tensor, torch.as_tensor, torch.full,
                torch.scalar_tensor, torch.zeros, torch.ones, torch.empty}

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func in self.CREATORS and isinstance(out, torch.Tensor)
                and out.dim() == 0):
            self.made.append(func.__name__)
        return out


@pytest.mark.parametrize("max_faces", [0, 4])
def test_warm_dispatch_creates_no_scalar_tensor(nets, max_faces):
    """C6: a warm multistream dispatch (one face or ``max_faces`` a
    stream, the dynamic gallery with a device ``rows``) builds no scalar
    tensor: the cascade's constants are built with the stage."""
    _, _, _, tdet, tmodel = nets
    frames = torch.from_numpy(_frames(5, 2))
    gallery = np.random.default_rng(5).normal(size=(5, 342))
    fn = make_multistream_pipeline(tdet, tmodel, dynamic_gallery=True,
                                   max_faces=max_faces, device="cpu", **KW)
    gal_n = normalize_gallery(gallery, device="cpu")
    rows = torch.tensor(5, dtype=torch.int32)
    fn(frames, gal_n, rows)                          # warm
    with _ScalarCreations() as mode:
        out = fn(frames, gal_n, rows)
    assert out["found"].any()
    assert mode.made == []


def test_dynamic_gallery_rows_mask_padding(nets):
    """Rows past ``rows`` never win, even when they would match best."""
    _, _, _, tdet, tmodel = nets
    frames = _frames(5, 2)
    base = make_multistream_pipeline(tdet, tmodel, np.ones((1, 342)),
                                     device="cpu", **KW)(frames)
    emb = base["embedding"].numpy()
    gallery = np.concatenate([np.random.default_rng(9).normal(size=(3, 342)),
                              emb])
    dyn = make_multistream_pipeline(tdet, tmodel, dynamic_gallery=True,
                                    device="cpu", **KW)
    gal_n = normalize_gallery(gallery, device="cpu")
    full = dyn(frames, gal_n)
    np.testing.assert_array_equal(full["index"].numpy(), [3, 4])
    masked = dyn(frames, gal_n, 3)
    assert (masked["index"].numpy() < 3).all()
    none = dyn(frames, gal_n, 0)
    np.testing.assert_array_equal(none["index"].numpy(), [-1, -1])
    np.testing.assert_array_equal(none["similarity"].numpy(), [-2.0, -2.0])


def test_serve_demo_runs_an_export_in_bf16(nets, tmp_path):
    """``--export-dir`` loads a JAX export and serves it in bf16."""
    from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
        export_params,
    )

    _, _, params, _, _ = nets
    export_params(str(tmp_path), params, model_name="efmnet342",
                  feature_dim=342, input_hw=(32, 32))
    res = serve_demo.main([
        "--streams", "2", "--frames", "2", "--frame-size", "48", "48",
        "--image-size", "32", "--device", "cpu", "--export-dir",
        str(tmp_path), "--det-thresholds", "0.3", "0.3", "0.3"])
    emb = res["out"]["embedding"]
    assert emb.dtype == torch.float32 and emb.shape == (2, 342)
    assert torch.isfinite(emb).all()


def test_serve_demo_streams_runs_on_cpu(capsys):
    res = serve_demo.main([
        "--streams", "2", "--frames", "4", "--frame-size", "48", "48",
        "--image-size", "32", "--device", "cpu", "--identities", "3",
        "--det-thresholds", "0.3", "0.3", "0.3", "--dynamic-gallery",
        "--gallery-dtype", "bf16"])
    assert res["streams"] == 2 and res["dispatches"] == 2
    assert res["out"]["embedding"].shape == (2, 342)
    text = capsys.readouterr().out
    assert "stream   1:" in text and "frames/s" in text
    # every mode of the JAX demo is ported (int8 rows too: see
    # tests/test_torch_serve_live.py); its flag checks remain
    for argv in (["--dynamic-gallery"],
                 ["--video", "cam.avi", "--person-db", "p.sqlite"],
                 ["--streams", "2", "--gallery-dtype", "int8"]):
        with pytest.raises(SystemExit, match="dynamic-gallery"):
            serve_demo.main(argv + ["--device", "cpu"])


def test_lightcnn9_multistream_pipeline_matches_jax(nets):
    """(h) the serving path with LightCNN9 as the embedding net: every
    stream of the port's batched pipeline equals the JAX single-frame
    pipeline with the same LightCNN9 weights (256-d embeddings)."""
    jdet, _, _, tdet, _ = nets
    model = JLightCNN9(num_classes=4)
    params = flax_params(model, 32, seed=1)
    gallery = np.random.default_rng(6).normal(size=(5, 256))
    jfn = j_pipeline(jdet, model, {"params": params}, gallery, **KW)
    tmodel = from_jax_params(params, device="cpu")
    frames = _frames(5, 2)
    out = make_multistream_pipeline(tdet, tmodel, gallery, device="cpu",
                                    **KW)(frames)
    assert out["embedding"].shape == (2, 256)
    for i in range(2):
        _assert_same({k: v[i].numpy() for k, v in out.items()},
                     jfn(jnp.asarray(frames[i])))


@pytest.mark.parametrize("model,dim", [("lightcnn9", 256), ("lightcnn29", 684)])
def test_serve_demo_streams_runs_lightcnn_models(model, dim):
    """``--model lightcnn9|lightcnn29`` serve with the embedding width of
    the model."""
    res = serve_demo.main([
        "--streams", "2", "--frames", "2", "--frame-size", "48", "48",
        "--image-size", "32", "--model", model, "--device", "cpu",
        "--det-thresholds", "0.3", "0.3", "0.3"])
    emb = res["out"]["embedding"]
    assert emb.shape == (2, dim) and torch.isfinite(emb).all()
