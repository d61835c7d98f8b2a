"""The port's sharded extraction and serving on gloo ranks.

Two spawned CPU processes (``_torch_ranks.run_ranks``, one torch thread
each) run, from the same numpy weights and inputs, and are held to the
JAX package at the same layout on the conftest's CPU mesh:

- ``make_sharded_extract_fn`` / ``extract_features(data_parallel=True)``
  (LightCNN9 at 32x32) against JAX's sharded extractor on 2 devices:
  features to 1e-4, predictions equal; the int8 route with the whole
  batch's activation scale against the port's world-1 int8 run to 1e-6;
- ``match_gallery_sharded`` against JAX's on 2 devices: indices exact
  (a duplicate row ties to the smaller index, a NaN row never wins, the
  odd row count pads), similarities to 1e-6;
- ``make_sharded_multistream_pipeline`` and
  ``make_gallery_sharded_multistream_pipeline`` (MTCNN + EFMNet342 at 32,
  64x64 frames, the seeds of tests/test_torch_pipeline.py) against JAX's
  on 2 devices: ``found``, ``index`` and ``cap_dropped`` equal, boxes to
  1e-3, similarities and embeddings to 1e-4; a stream count that does not
  divide raises JAX's message;
- ``DeviceGallery(mesh=...)`` in f32, bf16 and int8 through every mutation
  and a doubling against JAX's with ``mesh=``: each rank's block is its
  shard of JAX's matrix, bit-equal for the initial rows (normalized on the
  host on both sides), within one ulp or int8 step for rows written by
  ``add`` / ``set_row`` (normalized in XLA by JAX, as
  tests/test_torch_gallery.py holds the unsharded gallery); ``PersonGalleryService(mesh=...)``
  against JAX's over twin stores (the same persons, faces and
  similarities to 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from _torch_ranks import run_ranks
from _torch_ties import (
    argmax_margins,
    assert_cascade_margins,
    assert_gallery_margins,
    assert_largest_face_margins,
    assert_match_margins,
    record_cascade_nms,
    unit_rows,
)
from _torch_weights import flax_params, mtcnn_params
from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    MTCNNDetector as JMTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.extract import (
    make_sharded_extract_fn as jsharded_extract,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    LightCNN9 as JLightCNN9,
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.parallel import (
    make_mesh as jmake_mesh,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    gallery_service as jgs,
    person_store as jps,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.device_gallery import (
    DeviceGallery as JDeviceGallery,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.gallery import (
    match_gallery_sharded as jmatch_sharded,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.pipeline import (
    make_gallery_sharded_multistream_pipeline as jgallery_sharded,
    make_sharded_multistream_pipeline as jsharded,
    shard_gallery as jshard_gallery,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    synthetic_faces,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
    extract_features,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    person_store as tps,
)

SIDE, H, W, DIM = 32, 64, 64, 16
TH = (0.05, 0.05, 0.05)
KW = dict(frame_h=H, frame_w=W, embed_size=32, thresholds=TH,
          sim_threshold=-1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _extract_inputs():
    model = JLightCNN9(num_classes=6)
    params = flax_params(model, SIDE, seed=0)
    imgs, labels = synthetic_faces(num_ids=5, per_id=4, size=SIDE)
    u8 = (imgs * 255.0).clip(0, 255).astype(np.uint8)
    return model, params, u8, labels % 6


def _gallery_inputs():
    rng = np.random.default_rng(4)
    gallery = rng.normal(size=(11, 24)).astype(np.float32)
    gallery[7] = gallery[2]                     # a tie: row 2 wins
    gallery[4] = np.nan                          # never wins
    queries = rng.normal(size=(6, 24)).astype(np.float32)
    queries[0] = gallery[2] * 3.0
    queries[1] = gallery[10]                     # the last, padded block
    return gallery, queries


def _serving_inputs():
    det_params = [mtcnn_params(spec, seed=i) for i, spec in enumerate(
        (jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC, jmtcnn._ONET_SPEC))]
    for p in det_params:                   # the JAX init's zero biases
        for entry in p.values():
            if "biases" in entry:
                entry["biases"][:] = 0.0
            if "alpha" in entry:
                entry["alpha"][:] = 0.25
    params = flax_params(JEFMNet342(num_classes=4), 32, seed=0)
    gallery = np.random.default_rng(5).normal(size=(5, 342)).astype(
        np.float32)
    frames = np.concatenate([
        (np.random.default_rng(s).random((2, H, W, 3)) * 255).astype(
            np.float32) for s in (0, 5)])
    return det_params, params, gallery, frames


def _clustered(n_ids=5, per_id=3, dim=DIM, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_ids, dim)).astype(np.float32)
    feats = np.concatenate([
        centers[i] + rng.normal(size=(per_id, dim)).astype(np.float32) * 0.05
        for i in range(n_ids)])
    return feats, np.repeat(np.arange(n_ids), per_id)


def _dg_inputs():
    rng = np.random.default_rng(6)
    return (rng.normal(size=(3, 8)).astype(np.float32),
            [rng.normal(size=8).astype(np.float32) for _ in range(3)])


def _fill_store(ps, path, feats, labels):
    with ps.PersonStore(path, DIM) as store:
        for i in range(3):
            store.register_person(ps.Person(name=f"p{i}"),
                                  list(feats[labels == i]))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    _, params, u8, labels = _extract_inputs()
    gallery, queries = _gallery_inputs()
    det_params, eparams, sgallery, frames = _serving_inputs()
    initial, adds = _dg_inputs()
    feats, flabels = _clustered()
    _fill_store(tps, str(tmp / "t.sqlite"), feats, flabels)
    payload = {
        "extract_job": {"model": "lightcnn9", "classes": 6, "size": SIDE,
                        "params": params, "images": u8, "labels": labels,
                        "batch": 8},
        "gallery_job": {"gallery": gallery, "queries": queries,
                        "sim_th": 0.1},
        "pipelines_job": {"det_params": det_params, "params": eparams,
                          "gallery": sgallery, "frames": frames, "kw": KW},
        "device_gallery_job": {"dim": 8, "initial": initial, "adds": adds},
        "service_job": {"store": str(tmp / "t.sqlite"), "feats": feats,
                        "labels": flabels,
                        "probes": feats[[0, 3, 6, 9, 12]] + 0.02},
    }
    return {"tmp": tmp, "ranks": run_ranks(list(payload), 2, payload)}


def test_sharded_extraction_matches_jax(ranks):
    model, params, u8, labels = _extract_inputs()
    fn = jsharded_extract(model, mesh=jmake_mesh(jax.devices()[:2]))
    want_logits, want = [], []
    for start in range(0, 24, 8):           # 20 rows, the last batch padded
        chunk = u8[start:start + 8]
        chunk = np.concatenate([chunk, np.zeros((8 - len(chunk),)
                                                + chunk.shape[1:], np.uint8)])
        lg, ft = fn({"params": params}, jnp.asarray(chunk))
        want_logits.append(np.asarray(lg))
        want.append(np.asarray(ft))
    want = np.concatenate(want)[:20]
    preds = np.concatenate(want_logits)[:20].argmax(-1)
    # no prediction within the features' tolerance of a tie
    assert np.all(argmax_margins(np.concatenate(want_logits)[:20], 1e-4) > 0)
    port = model_by_name("lightcnn9", 6, input_hw=(SIDE, SIDE),
                         params=params, device="cpu")
    q1, _, qacc, qpred = extract_features(port, u8, labels, batch_size=8,
                                          int8=True)
    for out in (r["extract_job"] for r in ranks["ranks"]):
        feats, acc, pred = out[False]
        np.testing.assert_allclose(feats, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(pred, preds)
        assert acc == float((preds == labels).mean())
        logits, f8 = out["fn"]
        np.testing.assert_allclose(f8, want[:8], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(logits, want_logits[0], rtol=1e-4,
                                   atol=1e-4)
        qf, qa, qp = out[True]
        np.testing.assert_allclose(qf, q1, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(qp, qpred)
        assert out["error"] == ("--data-parallel needs batch_size (3) "
                                "divisible by the device count (2)")


def test_sharded_gallery_matcher_matches_jax(ranks):
    gallery, queries = _gallery_inputs()
    idx, sim = jmatch_sharded(gallery, queries, 0.1,
                              mesh=jmake_mesh(jax.devices()[:2]))
    assert idx[0] == 2 and idx[1] == 10
    # every best row leads its runner-up, and clears the 0.1 threshold, by
    # more than the 1e-6 the similarities are held to; row 7 repeats row 2
    # exactly, a tie that the first-row rule decides without rounding
    g = gallery / np.linalg.norm(gallery, axis=1, keepdims=True)
    sims = (queries / np.linalg.norm(queries, axis=1, keepdims=True)) @ g.T
    valid = np.all(np.isfinite(gallery), 1)
    valid[7] = False
    assert np.all(argmax_margins(sims, 1e-6, valid=valid) > 0)
    assert np.all(np.abs(np.where(valid, sims, -np.inf).max(1) - 0.1) > 1e-6)
    for got_idx, got_sim in (r["gallery_job"] for r in ranks["ranks"]):
        np.testing.assert_array_equal(got_idx, idx)
        np.testing.assert_allclose(got_sim, sim, rtol=0, atol=1e-6)


def _jax_serving():
    det_params, params, gallery, frames = _serving_inputs()
    jdet = JMTCNNDetector(*[jmtcnn.load_npy_params(p) for p in det_params])
    return jdet, JEFMNet342(num_classes=4), {"params": params}, gallery, \
        frames


def _assert_serving_margins(monkeypatch, outs, want, rows_n):
    """The margins of the sharded pipelines' comparisons: the device
    cascade of the port (in this process, over all the frames) against the
    JAX one frame by frame (``_torch_ties.assert_cascade_margins``), the
    face each frame picks (``assert_largest_face_margins``), and each
    rank's gallery match against JAX's (``assert_gallery_margins``)."""
    from improving_face_recognition_performance_using_triplet_loss_tpu.detect.device_cascade import (
        make_device_cascade as jcascade,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_cascade import (
        make_device_cascade as tcascade,
    )

    det_params, _, _, frames = _serving_inputs()
    port, jax_calls = record_cascade_nms(monkeypatch)
    jdet = JMTCNNDetector(*[jmtcnn.load_npy_params(p) for p in det_params])
    jfn = jcascade(jdet.pnet_params, jdet.rnet_params, jdet.onet_params, H,
                   W, thresholds=TH)
    for f in frames:
        jfn(jnp.asarray(f))
    tdet = MTCNNDetector(*det_params, device="cpu")
    tcascade(tdet.pnet, tdet.rnet, tdet.onet, H, W, thresholds=TH,
             device="cpu")(frames)
    n = len(frames)
    assert_cascade_margins(port, jax_calls, n, [TH[0], TH[0], TH[1], TH[2]])
    assert_largest_face_margins(port, jax_calls, n, H, W)
    found = np.asarray(want["found"])
    for out in outs:
        assert_gallery_margins(out["embedding"][found],
                               np.asarray(want["embedding"])[found], rows_n)


def _assert_same(got, want):
    for key in ("found", "index", "cap_dropped"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), key)
    np.testing.assert_allclose(got["box"], np.asarray(want["box"]),
                               atol=1e-3)
    for key in ("similarity", "embedding"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=1e-4)


def test_sharded_multistream_pipeline_matches_jax(ranks, monkeypatch):
    jdet, model, variables, gallery, frames = _jax_serving()
    fn = jsharded(jdet, model, variables, gallery,
                  jmake_mesh(jax.devices()[:2]), **KW)
    want = fn(frames)
    assert np.asarray(want["found"]).any()
    _assert_serving_margins(
        monkeypatch, [r["pipelines_job"]["sharded"] for r in ranks["ranks"]],
        want, gallery / np.linalg.norm(gallery, axis=1, keepdims=True))
    with pytest.raises(ValueError) as err:
        fn(frames[:3])
    for out in (r["pipelines_job"] for r in ranks["ranks"]):
        _assert_same(out["sharded"], want)
        assert out["error"] == str(err.value)


def test_gallery_sharded_pipeline_matches_jax(ranks, monkeypatch):
    jdet, model, variables, gallery, frames = _jax_serving()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    gal_n, rows = jshard_gallery(gallery, mesh)
    kw = {k: v for k, v in KW.items()}
    fn = jgallery_sharded(jdet, model, variables, mesh, **kw)
    want = fn(frames, gal_n, rows)
    _assert_serving_margins(
        monkeypatch,
        [r["pipelines_job"]["gallery_sharded"] for r in ranks["ranks"]],
        want, np.asarray(gal_n)[:rows])
    with pytest.raises(ValueError) as err:
        fn(frames[:3], gal_n, rows)
    full = np.asarray(gal_n)
    for r, out in enumerate(x["pipelines_job"] for x in ranks["ranks"]):
        _assert_same(out["gallery_sharded"], want)
        np.testing.assert_array_equal(out["block"], full[3 * r:3 * r + 3])
        assert out["gallery_error"] == str(err.value)


def test_sharded_device_gallery_matches_jax(ranks):
    initial, adds = _dg_inputs()
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    for name, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16),
                        ("int8", jnp.int8)):
        dg = JDeviceGallery(dim=8, capacity=3, initial=initial, mesh=mesh,
                            dtype=dtype)
        want = []

        def snap():
            want.append((dg.rows, dg.capacity,
                         np.asarray(dg.gallery_n, np.float32),
                         dg.to_host()))

        snap()
        for v in adds:
            dg.add(v)
            snap()
        dg.set_row(1, adds[0])
        dg.clear_row(2)
        snap()
        assert [w[1] for w in want] == [4, 4, 8, 8, 8]
        # one f32 ulp, one bf16 ulp, one int8 step (``block`` in stored
        # units, ``host`` widened)
        ulp = {"f32": (1e-7, 1e-7), "bf16": (2 ** -8, 2 ** -8),
               "int8": (1.0, 1.0 / 127 + 1e-7)}[name]
        for r, out in enumerate(x["device_gallery_job"][name]
                                for x in ranks["ranks"]):
            for i, (got, (rows, cap, full, host)) in enumerate(
                    zip(out, want)):
                assert (got["rows"], got["capacity"]) == (rows, cap)
                assert got["rows_arg"] == rows
                half = cap // 2
                block = full[r * half:(r + 1) * half]
                if i == 0:      # initial rows: normalized on the host
                    np.testing.assert_array_equal(got["block"], block)
                    np.testing.assert_array_equal(got["host"], host)
                np.testing.assert_allclose(got["block"], block, rtol=0,
                                           atol=ulp[0])
                np.testing.assert_allclose(got["host"], host, rtol=0,
                                           atol=ulp[1])


def test_sharded_gallery_service_matches_jax(ranks):
    feats, labels = _clustered()
    probes = feats[[0, 3, 6, 9, 12]] + 0.02
    # the galleries hold subsets of these faces as they change; the
    # similarities are held to 1e-6
    assert_match_margins(probes, unit_rows(feats), 0.5, 1e-6, subsets=True)
    path = str(ranks["tmp"] / "j.sqlite")
    _fill_store(jps, path, feats, labels)
    mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    want = []
    with jps.PersonStore(path, DIM) as store:
        svc = jgs.PersonGalleryService(store, capacity=4, mesh=mesh)

        def who():
            want.append([(r.person.name if r.person else None,
                          round(float(r.similarity), 6), r.fid)
                         for r in svc.match_batch(probes, sim_th=0.5)])

        who()
        want.append(svc.enroll(jps.Person(name="p3"),
                               list(feats[labels == 3])))
        want.append(svc.add_face(1, feats[labels == 4][0]))
        who()
        want.append(svc.retire_person(2))
        who()
        svc.refresh()
        who()
        want.append((svc.rows, svc._dg.capacity))
    for out in (r["service_job"] for r in ranks["ranks"]):
        assert len(out) == len(want)
        for got, w in zip(out, want):
            if isinstance(w, list):
                assert [(n, f) for n, _, f in got] == [(n, f)
                                                       for n, _, f in w]
                np.testing.assert_allclose([s for _, s, _ in got],
                                           [s for _, s, _ in w], atol=1e-6)
            else:
                assert got == w
