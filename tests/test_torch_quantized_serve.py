"""The port's ``int8_embed`` serving pipelines against the JAX package's,
on the CPU.

MTCNN and EFMNet342 weights from the seeds of tests/test_torch_pipeline.py
(64x64 frames, 32x32 crops, cascade thresholds 0.05), carried into the
port. The single-frame and multistream pipelines (one face a frame) and
the multiface one (four crops a frame, the empty slots included) run the
embedding net on the int8 route with one activation scale a frame, as the
JAX pipelines compute it under ``vmap``: found, index and the capacity
counts equal to JAX's frame by frame, embeddings within cosine 0.9995
(tests/test_torch_quantized.py says why not 0.9999), and the gallery
index equal wherever JAX's best similarity leads the next by more than
twice the distance between the two embeddings (a unit gallery row moves a
similarity by at most that distance, so only such a lead decides the
argmax on both sides; random EFMNet342 embeddings lie close together, and
the int8 noise reorders near-ties). Each port run's cascade is first held
to the JAX runs' on the same frames (``_torch_ties.assert_cascade_margins``):
no detection decision sits within rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
    MTCNNDetector as JMTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    pipeline as jpipe,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    MTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    pipeline as tpipe,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)

from _torch_ties import assert_cascade_margins, record_cascade_nms
from _torch_weights import flax_params, mtcnn_params

COS_JAX = 0.9995


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decided_equal(got_idx, want_idx, got_emb, want_emb, gallery):
    """Indices equal wherever JAX's top-two lead exceeds twice the
    embeddings' distance; returns how many faces were decided."""
    g = gallery / np.linalg.norm(gallery, axis=1, keepdims=True)
    sims = np.sort(np.asarray(want_emb, np.float64) @ g.T, axis=-1)
    lead = sims[..., -1] - sims[..., -2]
    dist = np.linalg.norm(np.asarray(got_emb, np.float64)
                          - np.asarray(want_emb, np.float64), axis=-1)
    decided = lead > 2.0 * dist
    np.testing.assert_array_equal(np.asarray(got_idx)[decided],
                                  np.asarray(want_idx)[decided])
    return int(decided.sum())


def _cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


@pytest.fixture(scope="module")
def serving():
    """MTCNN nets with the JAX init's zero biases and an EFMNet342 at
    32x32, both packages (tests/test_torch_pipeline.py's seeds)."""
    det_params = [mtcnn_params(spec, seed=i) for i, spec in enumerate(
        (jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC, jmtcnn._ONET_SPEC))]
    for p in det_params:
        for entry in p.values():
            if "biases" in entry:
                entry["biases"][:] = 0.0
            if "alpha" in entry:
                entry["alpha"][:] = 0.25
    jdet = JMTCNNDetector(*[jmtcnn.load_npy_params(p) for p in det_params])
    model = JEFMNet342(num_classes=4)
    params = flax_params(model, 32, seed=0)
    return (jdet, model, params, MTCNNDetector(*det_params, device="cpu"),
            from_jax_params(params, device="cpu"))


KW = dict(frame_h=64, frame_w=64, embed_size=32,
          thresholds=(0.05, 0.05, 0.05), sim_threshold=-1.0)


def test_int8_embed_pipelines_match_jax(serving, monkeypatch):
    """``int8_embed=True``: the single-frame and multistream pipelines
    (one scale a frame: the JAX pipeline embeds each frame's face alone)
    and the multiface one (a frame's four crops, empty slots included),
    against the JAX pipelines frame by frame."""
    port_nms, jax_nms = record_cascade_nms(monkeypatch)
    cascade_th = [0.05] * 4

    def margins(jax_calls, n):
        assert_cascade_margins(port_nms[-4:], jax_calls, n, cascade_th)

    jdet, model, params, tdet, tmodel = serving
    frames = (np.random.default_rng(5).random((3, 64, 64, 3))
              * 255).astype(np.float32)
    gallery = np.random.default_rng(5).normal(size=(5, 342))
    jfn = jpipe.make_recognition_pipeline(jdet, model, {"params": params},
                                          gallery, int8_embed=True, **KW)
    jmf = jpipe.make_multiface_pipeline(jdet, model, {"params": params},
                                        gallery, max_faces=4,
                                        int8_embed=True, **KW)
    wants = [{k: np.asarray(v) for k, v in jfn(jnp.asarray(f)).items()}
             for f in frames]
    jax_single = list(jax_nms)
    jax_nms.clear()
    wmfs = [{k: np.asarray(v) for k, v in jmf(jnp.asarray(f)).items()}
            for f in frames]
    jax_multi = list(jax_nms)
    ms = tpipe.make_multistream_pipeline(tdet, tmodel, gallery,
                                         int8_embed=True, device="cpu", **KW)(
        frames)
    margins(jax_single, 3)
    single = tpipe.make_recognition_pipeline(tdet, tmodel, gallery,
                                             int8_embed=True, device="cpu",
                                             **KW)
    singles = []
    for i in range(3):
        singles.append({k: v.numpy() for k, v in single(frames[i]).items()})
        margins(jax_single[4 * i:4 * i + 4], 1)
    mf = tpipe.make_multistream_pipeline(tdet, tmodel, gallery, max_faces=4,
                                         int8_embed=True, device="cpu",
                                         **KW)(frames)
    margins(jax_multi, 3)
    decided = 0
    for i in range(3):
        want = wants[i]
        assert want["found"]
        for got in ({k: v[i].numpy() for k, v in ms.items()}, singles[i]):
            for key in ("found", "cap_dropped"):
                np.testing.assert_array_equal(got[key], want[key])
            assert _cos(got["embedding"][None],
                        want["embedding"][None])[0] >= COS_JAX
            decided += _decided_equal(got["index"], want["index"],
                                      got["embedding"], want["embedding"],
                                      gallery)
        wmf = wmfs[i]
        gmf = {k: v[i].numpy() for k, v in mf.items()}
        for key in ("found", "cap_dropped", "topk_dropped"):
            np.testing.assert_array_equal(gmf[key], wmf[key])
        f = wmf["found"]
        assert _cos(gmf["embeddings"][f], wmf["embeddings"][f]).min() \
            >= COS_JAX
        decided += _decided_equal(gmf["indices"][f], wmf["indices"][f],
                                  gmf["embeddings"][f],
                                  wmf["embeddings"][f], gallery)
    assert decided > 0      # the check binds (4 of the 18 faces here)
