"""AOT export of the port (``serve/aot.py``, ``cli/export_aot.py``) on the
CPU: the ``facejax`` ops, ExportedProgram round trips against the live
pipelines, extraction artifacts fed new weights, a loading process that
refuses the port's models and detect, ``export_aot``'s guards, and one
artifact against the JAX package's.

64x64 frames, embed size 32 and thresholds 0.05 with the weights and seeds
of tests/test_torch_pipeline.py (no detection score within 1e-5 of a
threshold). A port artifact runs the live pipeline's own ops, so its
outputs must equal the live pipeline's; against the JAX artifact, integer
outputs are equal and similarities match at 1e-4 (float32 convs summed in
another order on each side).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    export_aot as jexport_aot,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    aot as jaot,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
    export_mtcnn,
    export_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    export_aot,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    save_feature_store,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
    MTCNNDetector,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
    make_extract_fn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    efm3,
    front9,
    mining,
    nms,
    stem,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    aot,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.pipeline import (
    make_multiface_pipeline,
    make_multistream_pipeline,
    make_recognition_pipeline,
    normalize_gallery,
)
from _torch_weights import flax_params, mtcnn_params

PORT = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"
H = W = 64
TH = (0.05, 0.05, 0.05)
KW = dict(frame_h=H, frame_w=W, embed_size=32, thresholds=TH,
          sim_threshold=-1.0, device="cpu")
G = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(seed, n):
    return (np.random.default_rng(seed).random((n, H, W, 3)) * 255).astype(
        np.float32)


@pytest.fixture(scope="module")
def nets():
    """(det params, flax EFMNet342 params, port detector, port model)."""
    det_params = [mtcnn_params(spec, seed=i) for i, spec in enumerate(
        (jmtcnn._PNET_SPEC, jmtcnn._RNET_SPEC, jmtcnn._ONET_SPEC))]
    for p in det_params:                   # the JAX init's zero biases
        for entry in p.values():
            if "biases" in entry:
                entry["biases"][:] = 0.0
            if "alpha" in entry:
                entry["alpha"][:] = 0.25
    params = flax_params(JEFMNet342(num_classes=4), 32, seed=0)
    return (det_params, params, MTCNNDetector(*det_params, device="cpu"),
            from_jax_params(params, device="cpu"))


def _gallery(seed=5, rows=G):
    return np.random.default_rng(seed).normal(size=(rows, 342)).astype(
        np.float32)


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------------------- ops

_g = torch.Generator().manual_seed(0)


def _r(*shape):
    return torch.randn(*shape, generator=_g)


def _boxes():
    b = torch.rand(3, 20, 5, generator=_g) * 50
    b[..., 2:4] += b[..., 0:2]
    return b


def _front9_args():
    params = [_r(5, 5, 1, 8), _r(8), _r(1, 1, 4, 8), _r(8), _r(3, 3, 4, 32),
              _r(32)]
    packed = front9.pack_front9_weights(front9._tree(params), torch.float32)
    return (_r(2, 8, 8, 1), params,
            [packed[n] for n in front9.PACKED_ORDER])


OP_CASES = {
    "efm3_rows": (lambda: torch.ops.facejax.efm3_rows,
                  lambda: (_r(7, 9),), (7, 6), torch.float32),
    "efm3_rows_bwd": (lambda: torch.ops.facejax.efm3_rows_bwd,
                      lambda: (_r(7, 9), _r(7, 6)), (7, 9), torch.float32),
    "nms_mask_batched": (lambda: torch.ops.facejax.nms_mask_batched,
                         lambda: (_boxes(), 0.5, "Union"), (3, 20),
                         torch.bool),
    "nms_mask_batched_min": (lambda: torch.ops.facejax.nms_mask_batched,
                             lambda: (_boxes(), 0.7, "Min"), (3, 20),
                             torch.bool),
    "semi_hard_mining": (lambda: torch.ops.facejax.semi_hard_mining,
                         lambda: (_r(8, 4), _r(8).abs(), torch.arange(8) % 3,
                                  _r(16, 4), torch.arange(16) % 4), (8,),
                         torch.int32),
    "stem_mfm2": (lambda: torch.ops.facejax.stem_conv_maxout_pool,
                  lambda: (_r(2, 8, 6, 1), _r(5, 5, 1, 6), _r(6), 2),
                  (2, 4, 3, 3), torch.float32),
    "stem_efm3_bf16": (lambda: torch.ops.facejax.stem_conv_maxout_pool,
                       lambda: (_r(2, 8, 6, 1).bfloat16(), _r(5, 5, 1, 9),
                                _r(9), 3), (2, 4, 3, 6), torch.bfloat16),
    "stem2_conv": (lambda: torch.ops.facejax.stem2_conv,
                   lambda: (_r(2, 8, 6, 1), _r(5, 5, 1, 8), _r(8),
                            _r(1, 1, 4, 6), _r(6)), (2, 4, 3, 3),
                   torch.float32),
    "front9_chain": (lambda: torch.ops.facejax.front9_chain,
                     lambda: _front9_args(), (2, 2, 2, 16), torch.float32),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_passes_opcheck_and_fake_shapes(case):
    """Each kernel entry point's ``torch.library`` op: ``opcheck`` (schema,
    fake tensor, AOT dispatch) and the fake's and the real output's shape
    and dtype."""
    get_op, make_args, shape, dtype = OP_CASES[case]
    op, args = get_op(), make_args()
    torch.library.opcheck(op, args)
    with torch._subclasses.fake_tensor.FakeTensorMode() as mode:
        fake = op(*[mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else [mode.from_tensor(t) for t in a]
                    if isinstance(a, list) else a for a in args])
    assert tuple(fake.shape) == shape and fake.dtype == dtype
    real = op(*args)
    assert tuple(real.shape) == shape and real.dtype == dtype


def test_ops_take_any_strides():
    """An op makes its inputs contiguous (Inductor may hand it a
    transposed or sliced view)."""
    x = _r(9, 7).T
    assert torch.equal(torch.ops.facejax.efm3_rows(x),
                       efm3.efm3_rows_plain(x.contiguous()))
    b = _boxes().transpose(0, 1).contiguous().transpose(0, 1)
    assert torch.equal(torch.ops.facejax.nms_mask_batched(b, 0.5, "Union"),
                       nms.nms_mask_plain(b.contiguous(), 0.5))


def test_eager_wrappers_do_not_dispatch_through_the_ops(monkeypatch):
    """Outside a trace every wrapper calls its launch directly: the op is
    taken only while ``torch.compiler.is_compiling()``."""
    def refuse(*a, **k):
        raise AssertionError("an eager call went through a facejax op")

    for mod, name in ((efm3, "efm3_rows_op"), (nms, "nms_mask_batched_op"),
                      (mining, "semi_hard_mining_op"),
                      (stem, "stem_conv_maxout_pool_op"),
                      (stem, "stem2_conv_op"), (front9, "front9_chain_op")):
        monkeypatch.setattr(mod, name, refuse)
    efm3.efm3_rows(_r(4, 6))
    nms.nms_mask_batched(_boxes(), 0.5)
    mining.semi_hard_mining(_r(4, 3), _r(4).abs(), torch.arange(4),
                            _r(8, 3), torch.arange(8) % 5)
    stem.stem_conv_maxout_pool(_r(1, 4, 4, 1), _r(5, 5, 1, 4), _r(4))
    stem.stem2_conv(_r(1, 4, 4, 1), _r(5, 5, 1, 8), _r(8), _r(4, 6), _r(6))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_explicit_efm3_backward_equals_autograd(dtype):
    """The backward op's CPU body writes out torch's derivatives: bit-equal
    to the plain version's autograd (``efm3_rows_bwd_plain``), sign of zero
    included, on ties (small integers), NaN, +-inf, -0.0 / +0.0 gradients
    and tiny gradients (f16 subnormals, where a halving rounds)."""
    rng = np.random.default_rng(7)
    rows, t = 256, 33
    x = rng.integers(-2, 3, (rows, 3 * t)).astype(np.float64)
    x[rng.random(x.shape) < 0.03] = np.nan
    x[rng.random(x.shape) < 0.02] = np.inf
    x[rng.random(x.shape) < 0.02] = -np.inf
    g = rng.normal(size=(rows, 2 * t))
    g[rng.random(g.shape) < 0.1] = -0.0
    g[rng.random(g.shape) < 0.1] = 0.0
    g[rng.random(g.shape) < 0.1] *= 2.0 ** -23   # f16 subnormals
    xt, gt = (torch.from_numpy(a).to(dtype) for a in (x, g))
    want = efm3.efm3_rows_bwd_plain(xt, gt)
    iv = {2: torch.int16, 4: torch.int32, 8: torch.int64}[want.element_size()]
    for got in (efm3._efm3_rows_bwd_written_out(xt, gt),
                torch.ops.facejax.efm3_rows_bwd(xt, gt)):
        assert torch.equal(got.view(iv), want.view(iv))


# ------------------------------------------------------- pipeline artifacts


def _pipeline(nets, kind, dtype=torch.float32):
    _, _, det, model = nets
    if kind == "multiface":
        return (make_multiface_pipeline(det, model, dynamic_gallery=True,
                                        max_faces=4, **KW),
                dict(gallery_shape=(G, 342)))
    return (make_multistream_pipeline(det, model, dynamic_gallery=True, **KW),
            dict(streams=2, gallery_shape=(G, 342), gallery_dtype=dtype))


@pytest.fixture(scope="module")
def multistream_f32(nets, tmp_path_factory):
    """The multistream dynamic-gallery pipeline (f32) and its artifact."""
    pipe, kw = _pipeline(nets, "multistream")
    path = str(tmp_path_factory.mktemp("aot") / "p.pt2")
    return pipe, aot.export_pipeline(path, pipe, H, W, device="cpu", **kw)


@pytest.mark.parametrize("kind,dtype", [
    ("multiface", torch.float32), ("multistream", torch.float32),
    ("multistream", torch.bfloat16), ("multistream", torch.int8)])
def test_export_load_pipeline_equals_live(nets, kind, dtype, tmp_path,
                                          multistream_f32):
    """Round trips of the multi-face and multistream pipelines with a
    dynamic gallery in each dtype (the single-frame baked pipeline is
    :func:`test_export_aot_matches_the_jax_artifact`'s)."""
    if (kind, dtype) == ("multistream", torch.float32):
        pipe, path = multistream_f32
    else:
        pipe, kw = _pipeline(nets, kind, dtype)
        path = aot.export_pipeline(str(tmp_path / "p.pt2"), pipe, H, W,
                                   device="cpu", **kw)
    meta = aot.read_meta(path)
    assert meta["platforms"] == ["cpu"] and meta["frame_h"] == H
    assert meta["dynamic_gallery"]
    fn = aot.load_pipeline(path)
    frames = _frames(0, 2)
    g = normalize_gallery(_gallery(), dtype, device="cpu")
    assert meta["gallery_dtype"] == str(dtype).removeprefix("torch.")
    rows = torch.tensor(4, dtype=torch.int32)
    x = frames if kind == "multistream" else frames[0]
    want = pipe(x, g, rows)
    got = fn(x, g, 4)
    _equal(got, want)
    idx = got["index"] if "index" in got else got["indices"]
    assert int(idx.max()) < 4          # rows >= 4 never win


def test_export_extract_takes_new_weights(tmp_path):
    """One extraction artifact serves every checkpoint: exported from one
    model, fed another's state dict at call time."""
    a = model_by_name("lightcnn9", 5, input_hw=(16, 16), device="cpu",
                      generator=torch.Generator().manual_seed(0))
    b = model_by_name("lightcnn9", 5, input_hw=(16, 16), device="cpu",
                      generator=torch.Generator().manual_seed(1))
    path = aot.export_extract(str(tmp_path / "x.pt2"), a, 4, 16, 16,
                              device="cpu")
    assert aot.read_meta(path)["batch_size"] == 4
    # the weights are the call's: the artifact holds no copy of them
    assert os.path.getsize(path) < 1_000_000
    fn = aot.load_extract(path)
    images = torch.rand(4, 16, 16, 1, generator=torch.Generator()
                        .manual_seed(2))
    for model in (b, a):
        got = fn(model.state_dict(), images)
        want = make_extract_fn(model)(images)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


_LOADER = r"""
import importlib.abc, sys
REFUSED = ({port!r} + ".models", {port!r} + ".detect", "jax", "flax")
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError(name + " is refused")
        return None
sys.meta_path.insert(0, Refuse())
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from {port}.serve import aot
fn = aot.load_pipeline({path!r})
frames = np.load({frames!r})
out = fn(frames, torch.from_numpy(np.load({gallery!r})), 5)
np.savez({out!r}, **{{k: v.numpy() for k, v in out.items()}})
bad = [m for m in sys.modules if m.startswith(({port!r} + ".models",
                                               {port!r} + ".detect"))]
print("LOADED", len(bad))
"""


def test_artifact_runs_in_a_process_without_model_code(multistream_f32,
                                                      tmp_path):
    """``load_pipeline`` in a fresh interpreter that refuses the port's
    models and detect (and JAX) runs the artifact to the live pipeline's
    answers."""
    pipe, path = multistream_f32
    frames = _frames(2, 2)
    g = normalize_gallery(_gallery(), device="cpu")
    np.save(tmp_path / "f.npy", frames)
    np.save(tmp_path / "g.npy", g.numpy())
    code = _LOADER.format(port=PORT, repo=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))), path=path,
        frames=str(tmp_path / "f.npy"), gallery=str(tmp_path / "g.npy"),
        out=str(tmp_path / "o.npz"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED 0" in r.stdout
    got = np.load(tmp_path / "o.npz")
    want = pipe(frames, g, torch.tensor(5, dtype=torch.int32))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)


# ------------------------------------------------------------- the CLI


@pytest.mark.parametrize("extra,message", [
    ([], "one of --gallery"),
    (["--gallery", "g.npz", "--dynamic-gallery-rows", "8"],
     "mutually exclusive"),
    (["--dynamic-gallery-rows", "-3"], "positive row count"),
    (["--gallery", "g.npz", "--gallery-dtype", "int8"], "baked gallery"),
    (["--dynamic-gallery-rows", "8", "--platforms", "tpu"],
     "tied to one device kind"),
    (["--dynamic-gallery-rows", "8", "--platforms", "cpu", "cuda"],
     "tied to one device kind"),
    (["--dynamic-gallery-rows", "8", "--platforms", "gpu", "--device",
      "cpu"], "name different devices"),
])
def test_export_aot_guards(extra, message):
    argv = ["--export-dir", "nowhere", "--frame-size", "64", "64", "--out",
            "a.pt2", *extra]
    with pytest.raises(SystemExit, match=message):
        export_aot.main(argv)


def test_export_aot_matches_the_jax_artifact(nets, tmp_path):
    """The same weights through both CLIs (``--precision f32``, the
    detector from an ``export_mtcnn`` .npz, a baked gallery): the JAX
    StableHLO artifact and the port's ``.pt2`` on the same seeded frame,
    ``found`` / ``index`` equal and the similarity within 1e-4."""
    det_params, params, _, _ = nets
    export_params(str(tmp_path / "export"), params, model_name="efmnet342",
                  feature_dim=342, input_hw=(32, 32))
    mt = export_mtcnn(str(tmp_path / "mtcnn.npz"), *det_params)
    gallery = _gallery()
    save_feature_store(str(tmp_path / "g.npz"), gallery,
                       np.arange(G, dtype=np.int64))
    common = ["--export-dir", str(tmp_path / "export"), "--gallery",
              str(tmp_path / "g.npz"), "--frame-size", str(H), str(W),
              "--mtcnn-npz", mt, "--thresholds", *map(str, TH),
              "--sim-threshold", "-1", "--precision", "f32"]
    jpath = jexport_aot.main([*common, "--out", str(tmp_path / "j.shlo")])
    tpath = export_aot.main([*common, "--out", str(tmp_path / "t.pt2"),
                             "--device", "cpu"])
    frame = _frames(5, 1)[0]
    jout = jaot.load_pipeline(jpath, use_cache_bundle=False)(frame)
    tout = aot.load_pipeline(tpath)(frame)
    assert bool(tout["found"]) and bool(jout["found"])
    assert int(tout["index"]) == int(jout["index"])
    np.testing.assert_allclose(float(tout["similarity"]),
                               float(jout["similarity"]), atol=1e-4)
    np.testing.assert_allclose(tout["embedding"].numpy(),
                               np.asarray(jout["embedding"]), atol=1e-4)
    # the port's artifact is the port's live pipeline
    live = make_recognition_pipeline(
        MTCNNDetector(*det_params, device="cpu"),
        from_jax_params(str(tmp_path / "export"), device="cpu"), gallery,
        **KW)
    _equal(tout, live(frame))
