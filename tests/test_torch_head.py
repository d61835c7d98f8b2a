"""The port's triplet-head slice against the JAX package, on the CPU.

The same weights (a JAX ``LinearHead`` init carried across with
``head_from_jax_params``) and the same numpy batches go through the JAX
step, loop and CLIs and through the port's. Losses and cosines agree to
1e-5 step for step, weights to 1e-6; ``semi_hard_fused`` runs the Pallas
kernel in interpret mode on the JAX side and kernel B1's plain version on
the port's.
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu import (
    train as jtrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    draw_cos as jdraw_cos,
    eval_cos as jeval_cos,
    slice_dataset as jslice_dataset,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.data import (
    PairBatcher as JPairBatcher,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.eval.cosine import (
    CosineSimilaritySink as JSink,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.losses import (
    triplet as jtriplet,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models.heads import (
    LinearHead as JLinearHead,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    export as jexport,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    train as ttrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    draw_cos as tdraw_cos,
    eval_cos as teval_cos,
    slice_dataset as tslice_dataset,
    train_head as ttrain_head,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    PairBatcher,
    save_feature_store,
    synthetic_features,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.eval.cosine import (
    CosineSimilaritySink,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.losses import (
    triplet as ttriplet,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.heads import (
    LinearHead,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.mining import (
    mine_random_negative,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    export as texport,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    head_from_jax_params,
    head_to_jax_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train.state import (
    step_generator,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


T = torch.from_numpy
D_IN, D_OUT, B = 24, 8, 32
LR, EMA = 0.05, 0.9


def _features(seed=0, num_ids=6, per_id=16, dim=D_IN):
    return synthetic_features(num_ids=num_ids, per_id=per_id, dim=dim,
                              seed=seed)


def _batches(n, seed=0):
    feats, labels = _features(seed)
    return list(JPairBatcher(feats, labels, B, shuffle=True, seed=seed))[:n]


def _jax_state(ema=True):
    tx = jtrain.sgd_wd(lr=LR)
    if ema:
        tx = jtrain.with_param_ema(tx, decay=EMA)
    model = JLinearHead(out_dim=D_OUT)
    state = jtrain.create_train_state(model, tx, jax.random.PRNGKey(0),
                                      jnp.zeros((1, D_IN), jnp.float32))
    return model, tx, state


def _port_state(params, ema=True, seed=0):
    tx = ttrain.sgd_wd(lr=LR)
    if ema:
        tx = ttrain.with_param_ema(tx, decay=EMA)
    return ttrain.create_train_state(
        head_from_jax_params(params, device="cpu"), tx, seed)


def _kernel(state):
    return head_to_jax_params(state.model)["proj"]["kernel"]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                               atol=tol)


# -------------------------------------------------------------- head, loss


def test_head_bridge_and_forward_match_jax():
    model, _, state = _jax_state(ema=False)
    x = np.random.default_rng(1).normal(size=(5, D_IN)).astype(np.float32)
    head = head_from_jax_params(state.params, device="cpu")
    want = np.asarray(model.apply({"params": state.params}, jnp.asarray(x)))
    _close(head(T(x)).detach().numpy(), want, 1e-6)
    back = head_to_jax_params(head)
    np.testing.assert_array_equal(back["proj"]["kernel"],
                                  np.asarray(state.params["proj"]["kernel"]))
    # the port's own init is flax's lecun_normal: std 1/sqrt(in), cut at 2
    k = LinearHead(342, 128, generator=torch.Generator().manual_seed(0))
    w = k.flax_params()["proj"]["kernel"] * np.sqrt(342)
    assert w.shape == (342, 128) and abs(w.std() - 1) < 0.02
    assert np.abs(w).max() <= 2 / 0.87962566103423978 + 1e-5


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "none"])
def test_triplet_loss_matches_jax(normalize, reduction):
    rng = np.random.default_rng(2)
    a, p, n = (rng.normal(size=(9, 6)).astype(np.float32) for _ in range(3))
    want = jtriplet.triplet_loss(jnp.asarray(a), jnp.asarray(p),
                                 jnp.asarray(n), margin=0.5,
                                 normalize=normalize, reduction=reduction)
    got = ttriplet.triplet_loss(T(a), T(p), T(n), margin=0.5,
                                normalize=normalize, reduction=reduction)
    _close(got.numpy(), want, 1e-6)


# ------------------------------------------------------------------ steps


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("mode", ["semi_hard", "semi_hard_fused", "hard"])
def test_head_train_step_matches_jax(mode, normalize):
    """Three SGD steps with a parameter EMA: loss, pos_cos and neg_cos step
    for step to 1e-5, the final kernel and EMA to 1e-6."""
    model, tx, jstate = _jax_state()
    tstate = _port_state(jstate.params)
    jstep = jax.jit(jtrain.make_head_train_step(
        model, tx, mining_mode=mode, normalize_embeddings=normalize))
    tstep = ttrain.make_head_train_step(mining_mode=mode,
                                        normalize_embeddings=normalize)
    for anchor, positive, labels in _batches(3):
        jstate, jm = jstep(jstate, anchor, positive, labels)
        tstate, tm = tstep(tstate, anchor, positive, labels)
        for k in ttrain.HEAD_METRIC_KEYS:
            _close(tm[k].numpy(), jm[k], 1e-5)
    assert tstate.step == int(jstate.step) == 3
    _close(_kernel(tstate), jstate.params["proj"]["kernel"], 1e-6)
    _close(ttrain.get_ema_params(tstate)["proj.weight"].numpy().T,
           jtrain.get_ema_params(jstate.opt_state)["proj"]["kernel"], 1e-6)


@pytest.mark.parametrize("mode", ["semi_hard", "semi_hard_fused", "hard"])
def test_head_eval_step_matches_jax(mode):
    model, _, jstate = _jax_state(ema=False)
    tstate = _port_state(jstate.params, ema=False)
    jstep = jax.jit(jtrain.make_head_eval_step(model, mining_mode=mode))
    tstep = ttrain.make_head_eval_step(mining_mode=mode)
    for anchor, positive, labels in _batches(2, seed=1):
        jm = jstep(jstate, anchor, positive, labels)
        tm = tstep(tstate, anchor, positive, labels)
        for k in ttrain.HEAD_METRIC_KEYS:
            _close(tm[k].numpy(), jm[k], 1e-5)
    assert tstate.step == 0


def test_random_mining_replays_from_seed_and_step():
    """``random`` mining draws from a generator derived from (seed, step):
    the same state replays the same negatives, the next step draws anew,
    and every pick is a negative."""
    _, _, jstate = _jax_state(ema=False)
    anchor, positive, labels = _batches(1)[0]
    step = ttrain.make_head_eval_step(mining_mode="random")
    a = _port_state(jstate.params, ema=False, seed=7)
    b = _port_state(jstate.params, ema=False, seed=7)
    ma, mb = step(a, anchor, positive, labels), step(b, anchor, positive,
                                                     labels)
    np.testing.assert_array_equal(ma["neg_cos"].numpy(), mb["neg_cos"].numpy())
    b.step = 1
    assert not torch.equal(ma["neg_cos"], step(b, anchor, positive,
                                               labels)["neg_cos"])
    gen = step_generator(a)
    lab = T(labels)
    pool_lab = torch.cat([lab, lab])
    idx = mine_random_negative(gen, lab, pool_lab)
    assert (pool_lab[idx.long()] != lab).all()


# ------------------------------------------------------------------- loop


def _read_csv(path):
    return np.loadtxt(path, dtype=np.float64, ndmin=2)


def test_train_loop_matches_jax(tmp_path):
    """Two epochs of train + eval through each package's loop with the same
    starting weights, batcher seed and sink: epoch histories and the CSVs
    agree to 1e-5."""
    feats, labels = _features(0)
    efeats, elabels = _features(1, num_ids=4)
    model, tx, jstate = _jax_state(ema=False)
    tstate = _port_state(jstate.params, ema=False)
    mode = "semi_hard"
    jb, jeb = (JPairBatcher(feats, labels, B, seed=3),
               JPairBatcher(efeats, elabels, B, shuffle=False))
    tb, teb = (PairBatcher(feats, labels, B, seed=3),
               PairBatcher(efeats, elabels, B, shuffle=False))
    jsink, tsink = (JSink(str(tmp_path / "j.csv")),
                    CosineSimilaritySink(str(tmp_path / "t.csv")))
    jstate, jhist = jtrain.train_loop(
        jstate, jax.jit(jtrain.make_head_train_step(model, tx,
                                                    mining_mode=mode)),
        lambda: iter(jb), epochs=2,
        eval_step=jax.jit(jtrain.make_head_eval_step(model,
                                                     mining_mode=mode)),
        eval_batches=lambda: iter(jeb), sink=jsink)
    tstate, thist = ttrain.train_loop(
        tstate, ttrain.make_head_train_step(mining_mode=mode),
        lambda: iter(tb), epochs=2,
        eval_step=ttrain.make_head_eval_step(mining_mode=mode),
        eval_batches=lambda: iter(teb), sink=tsink)
    assert [h.epoch for h in thist] == [h.epoch for h in jhist] == [0, 1]
    for th, jh in zip(thist, jhist):
        assert th.train.keys() == jh.train.keys() == {"loss"}
        assert th.valid.keys() == jh.valid.keys()
        for part in ("train", "valid"):
            for k, v in getattr(jh, part).items():
                assert abs(getattr(th, part)[k] - v) <= 1e-5, (part, k)
        assert len(th.steps) == len(tb)
    tcsv, jcsv = _read_csv(tmp_path / "t.csv"), _read_csv(tmp_path / "j.csv")
    assert tcsv.shape == jcsv.shape == (2 * len(tb) * B, 2)
    _close(tcsv, jcsv, 1e-5)


def test_resume_equals_straight_run_with_ema(tmp_path):
    """Two epochs, a checkpoint, a fresh state resumed to four: weights,
    EMA, step and the last epochs' history equal four straight epochs
    (``random`` mining replays its draws from (seed, step))."""
    feats, labels = _features(2)
    _, _, jstate = _jax_state(ema=False)
    batcher = PairBatcher(feats, labels, B, shuffle=False)
    step = ttrain.make_head_train_step(mining_mode="random")

    def run(state, epochs, ckpt=None, start=0):
        return ttrain.train_loop(state, step, lambda: iter(batcher),
                                 epochs=epochs, checkpointer=ckpt,
                                 start_epoch=start)

    straight, shist = run(_port_state(jstate.params), 4)
    ckpt = ttrain.Checkpointer(str(tmp_path / "ckpt"), max_to_keep=3)
    run(_port_state(jstate.params), 2, ckpt)
    assert ckpt.latest_step() == 1
    fresh = _port_state(jstate.params, seed=123)
    resumed, start = ttrain.resume_if_available(ckpt, fresh)
    assert start == 2 and resumed.seed == 0
    resumed, rhist = run(resumed, 4, ckpt, start)
    assert resumed.step == straight.step == 4 * len(batcher)
    assert torch.equal(resumed.model.proj.weight, straight.model.proj.weight)
    for k, v in ttrain.get_ema_params(straight).items():
        assert torch.equal(ttrain.get_ema_params(resumed)[k], v)
    assert [h.train for h in rhist] == [h.train for h in shist[2:]]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["1", "2", "3"]


# ------------------------------------------------------------------- CLIs


def test_export_manifest_matches_jax(tmp_path):
    params = {"proj": {"kernel": np.random.default_rng(3).normal(
        size=(D_IN, D_OUT)).astype(np.float32)}}
    kw = dict(model_name="linear_head", feature_dim=D_OUT,
              input_hw=(1, D_IN), input_channels=1)
    jexport.export_params(str(tmp_path / "j"), params, **kw)
    texport.export_params(str(tmp_path / "t"), params, **kw)
    assert ((tmp_path / "t" / "manifest.json").read_bytes()
            == (tmp_path / "j" / "manifest.json").read_bytes())
    jp, _, _ = jexport.load_exported_params(str(tmp_path / "t"))
    np.testing.assert_array_equal(jp["proj"]["kernel"],
                                  params["proj"]["kernel"])


@pytest.fixture(scope="module")
def head_run(tmp_path_factory):
    """The port's train_head at a toy size on the CPU with fused mining."""
    out = str(tmp_path_factory.mktemp("head") / "run")
    state, history = ttrain_head.main([
        "--synthetic", "--epochs", "2", "--batch-size", "256",
        "--mining", "semi_hard_fused", "--device", "cpu", "--out-dir", out])
    return out, state, history


def test_train_head_cli_writes_csv_checkpoints_export(head_run):
    out, state, history = head_run
    feats, labels = synthetic_features(num_ids=256, per_id=16, dim=342,
                                       seed=0)
    steps = len(feats) // 256
    assert len(history) == 2 and state.step == 2 * steps
    assert all(np.isfinite(s["loss"]) for h in history for s in h.steps)
    assert _read_csv(os.path.join(out, "cosine_similarity.csv")).shape == (
        2 * steps * 256, 2)
    assert ttrain.Checkpointer(os.path.join(out, "ckpt")).latest_step() == 1
    params, _, manifest = jexport.load_exported_params(
        os.path.join(out, "export"))
    assert manifest["model"] == "linear_head"
    assert manifest["input"] == {"height": 1, "width": 342, "channels": 1,
                                 "scale": "1/255", "layout": "NHWC"}
    want = np.asarray(JLinearHead(out_dim=128).apply(
        {"params": params}, jnp.asarray(feats[:64])))
    with torch.no_grad():
        got = state.model(T(feats[:64])).numpy()
    _close(got, want, 1e-6)
    # the same tree through the JAX exporter gives the same manifest
    jexport.export_params(os.path.join(out, "jax_export"), params,
                          model_name="linear_head", feature_dim=128,
                          input_hw=(1, 342), input_channels=1)
    with open(os.path.join(out, "export", "manifest.json")) as f, \
            open(os.path.join(out, "jax_export", "manifest.json")) as g:
        assert f.read() == g.read()


def test_draw_cos_matches_jax(head_run, tmp_path):
    csv = os.path.join(head_run[0], "cosine_similarity.csv")
    printed = {}
    for name, cli in (("jax", jdraw_cos), ("port", tdraw_cos)):
        buf = io.StringIO()
        out = str(tmp_path / f"{name}.jpg")
        with contextlib.redirect_stdout(buf):
            assert cli.main(["--csv", csv, "--out", out,
                             "--desire-epoch", "2"]) == out
        assert os.path.getsize(out) > 0
        printed[name] = buf.getvalue().split(";", 1)[1]
    assert printed["port"] == printed["jax"]


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    feats, labels = synthetic_features(num_ids=20, per_id=8, dim=342, seed=4)
    path = str(d / "feats.npz")
    save_feature_store(path, feats, labels)
    return path


def test_eval_cos_matches_jax(store, tmp_path):
    args = ["--features", store, "--batch-size", "64"]
    jpos, jneg = jeval_cos.main(args + ["--out-dir", str(tmp_path / "j")])
    tpos, tneg = teval_cos.main(args + ["--out-dir", str(tmp_path / "t"),
                                        "--device", "cpu"])
    assert tpos.shape == jpos.shape == tneg.shape == (128,)
    _close(tpos, jpos, 1e-6)
    assert np.all(np.abs(tneg) <= 1 + 1e-6)
    tcsv = _read_csv(tmp_path / "t" / "cosine_similarity.csv")
    jcsv = _read_csv(tmp_path / "j" / "cosine_similarity.csv")
    assert tcsv.shape == jcsv.shape == (128, 2)
    _close(tcsv[:, 0], jcsv[:, 0], 1e-6)


def test_slice_dataset_matches_jax(store, tmp_path):
    for name, cli in (("j", jslice_dataset), ("t", tslice_dataset)):
        cli.main(["--features", store, "--out-dir", str(tmp_path / name)])
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t")) == [
        "test.npz", "test_id.csv", "test_img.csv", "train.npz",
        "train_id.csv", "train_img.csv"]
    for f in files:
        if f.endswith(".csv"):
            assert ((tmp_path / "t" / f).read_bytes()
                    == (tmp_path / "j" / f).read_bytes()), f
        else:
            with np.load(tmp_path / "t" / f) as t, np.load(tmp_path / "j" / f) as j:
                for k in ("features", "labels"):
                    np.testing.assert_array_equal(t[k], j[k])

