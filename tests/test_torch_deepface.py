"""The port's DeepFace (``models/deepface.py``) against the JAX package's,
on the CPU.

``LocallyConnected2D`` and ``DeepFace`` at 65x65x3 (the ladder's floor)
with narrow widths (LC 4, f7 32) from flax's init, forwards held to
flax's ``apply`` at 1e-5 relative; one backbone train step against the
jitted JAX step (dropout off on both sides, the ``sgd`` family at 1e-5,
triplet margin 2, the per-leaf gradients by relative norm, as
``tests/test_torch_backbone.py`` holds the LightCNNs: after one update of
lr x |grad| DeepFace's near-equal cosines at flax's init may pick another
semi-hard negative, so one step is compared);
``from_jax_params`` telling DeepFace's tree apart; and ``train_backbone``
/ ``extract_features --model deepface`` at 72x72 on the CPU.

At flax's init DeepFace's features are nearly parallel, so some semi-hard
picks sit on near-ties that float32 rounding decides, and it decides them
differently on different CPUs. The step test therefore reads the JAX
step's picks, holds each pick that differs from the port's to the
near-tie rule of ``tests/_torch_ties.py`` and runs the port's step with
the JAX step's picks before it compares losses and gradients.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu import (
    train as jtrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models.deepface import (
    DeepFace as JDeepFace,
    LocallyConnected2D as JLocallyConnected2D,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
    load_exported_params as jload_exported_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    train as ttrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    extract_features,
    train_backbone,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    PairBatcher,
    synthetic_faces,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    DeepFace,
    LocallyConnected2D,
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.lightcnn import (
    Dropout,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    export_model,
    from_jax_params,
)

from _torch_ties import share_picks

NC, B, LR, MARGIN = 5, 6, 1e-5, 2.0
SIDE, FEAT, LC = 65, 32, 4
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_locally_connected_matches_flax():
    x = np.random.default_rng(0).normal(size=(2, 9, 8, 3)).astype(np.float32)
    jm = JLocallyConnected2D(features=5, kernel=(3, 3))
    v = jm.init(jax.random.PRNGKey(0), x)
    want = np.asarray(jm.apply(v, x))
    layer = LocallyConnected2D((9, 8), 3, 5, 3)
    layer.load_flax(_np(v["params"]))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 7, 6, 5)
    assert _rel(got, want) <= 1e-5
    assert all(np.array_equal(layer.flax_entry()[k], np.asarray(v["params"][k]))
               for k in ("kernel", "bias"))


def test_deepface_forward_matches_flax():
    x = np.random.default_rng(1).random((2, SIDE, SIDE, 3)).astype(np.float32)
    jm = JDeepFace(num_classes=NC, feature_dim=FEAT, lc_features=LC)
    v = jm.init(jax.random.PRNGKey(0), x)
    jl, jf = (np.asarray(a) for a in jm.apply(v, x))
    model = model_by_name("deepface", NC, input_hw=(SIDE, SIDE),
                          in_channels=3, params=_np(v["params"]),
                          device="cpu")
    assert isinstance(model, DeepFace) and model.feature_dim == FEAT
    with torch.no_grad():
        tl, tf = model(torch.from_numpy(x))
    assert _rel(tl.numpy(), jl) <= 1e-5 and _rel(tf.numpy(), jf) <= 1e-5
    # the flax tree round trips bit for bit
    for path, want in _leaves(_np(v["params"])):
        assert np.array_equal(_get(model.flax_params(), path), want), path
    with pytest.raises(ValueError, match="65x65"):
        model(torch.zeros(1, 64, 64, 3))


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _recording(tx):
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


@pytest.mark.parametrize("mode", ["semi_hard", "semi_hard_fused"])
def test_deepface_train_step_matches_jax(mode, monkeypatch):
    """One step against the jitted JAX step (``semi_hard_fused``: the
    port's plain B1 against the Pallas kernel in interpret mode). The
    picks where the two differ must be near-ties on both sides' own
    features (``_torch_ties.assert_picks_explained``); the port's step then
    gathers the JAX step's picks, and its losses, cosines and per-leaf
    gradients are held to the JAX step's."""
    shared = share_picks(monkeypatch)
    faces, labels = synthetic_faces(num_ids=NC, per_id=4, size=SIDE,
                                    channels=3, seed=0)
    batches = list(PairBatcher(faces, labels, B, seed=0))[:1]
    model = JDeepFace(num_classes=NC, feature_dim=FEAT, lc_features=LC)
    tx = _recording(jtrain.backbone_optimizer("sgd", base_lr=LR))
    init_rng, base_key = jax.random.split(jax.random.PRNGKey(0))
    variables = jax.jit(model.init)(init_rng, jnp.asarray(faces[:1]))
    jstate = jtrain.TrainState(
        params=variables["params"], opt_state=tx.init(variables["params"]),
        batch_stats={}, step=jnp.zeros((), jnp.int32), base_key=base_key)
    jstep = jax.jit(jtrain.make_backbone_train_step(
        model, tx, mining_mode=mode, margin=MARGIN))
    module = model_by_name("deepface", NC, input_hw=(SIDE, SIDE),
                           in_channels=3, params=_np(jstate.params),
                           device="cpu")
    for m in module.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    tstate = ttrain.create_train_state(
        module, ttrain.backbone_optimizer("sgd", base_lr=LR), 0)
    tstep = ttrain.make_backbone_train_step(mining_mode=mode, margin=MARGIN)
    for a, p, lab in batches:
        with fnn.intercept_methods(_no_dropout):
            jstate, jm = jstep(jstate, a, p, lab)
        tstate, tm = tstep(tstate, a, p, lab)
        for k in ("loss", "id_loss", "tl_loss"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-4, err_msg=k)
        for k in ("pos_cos", "neg_cos"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       atol=1e-5, err_msg=k)
        grads = {}
        for (name, layer) in tstate.model.named_parameters():
            grads[name] = layer.grad.detach().clone()
        twin = model_by_name("deepface", NC, input_hw=(SIDE, SIDE),
                             in_channels=3, params=_np(jstate.params),
                             device="cpu")
        with torch.no_grad():
            for name, q in twin.named_parameters():
                q.copy_(grads[name])
        got = twin.flax_params()
        for path, want in _leaves(_np(jstate.opt_state[0])):
            g = _get(got, path)
            assert np.linalg.norm(g) > 0, path
            rel = (np.linalg.norm(g.astype(np.float64) - want)
                   / np.linalg.norm(want))
            assert rel <= GRAD_RTOL, (path, rel)
    assert tstate.step == int(jstate.step) == 1
    assert len(shared) == 1 and shared[0]["port"].shape == (B,)


def test_convert_tells_deepface_apart(tmp_path):
    jm = JDeepFace(num_classes=NC, feature_dim=FEAT, lc_features=LC)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 152, 152, 3)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(size=s.shape).astype(np.float32) * 0.01,
        v["params"])
    model = from_jax_params(params, device="cpu")
    assert isinstance(model, DeepFace)
    assert model.input_hw == (152, 152) and model.in_channels == 3
    assert model.num_classes == NC and model.feature_dim == FEAT
    # an export of the port reads back in both packages
    export_model(str(tmp_path / "e"), model)
    back = from_jax_params(str(tmp_path / "e"), device="cpu")
    jparams, _, manifest = jload_exported_params(str(tmp_path / "e"))
    assert manifest["model"] == "deepface" and manifest["feature_dim"] == FEAT
    for path, want in _leaves(params):
        assert np.array_equal(_get(back.flax_params(), path), want), path
        assert np.array_equal(np.asarray(_get(jparams, path)), want), path


def test_deepface_clis_on_cpu(tmp_path):
    """``train_backbone --model deepface --synthetic`` (3 channels at
    72x72, the CLI's floor above 65) trains with B1's plain version and
    exports; ``extract_features --model deepface`` reads the export."""
    out = str(tmp_path / "df")
    state, history = train_backbone.main(
        ["--synthetic", "--model", "deepface", "--epochs", "1",
         "--batch-size", "32", "--mining", "semi_hard_fused", "--device",
         "cpu", "--out-dir", out])
    assert isinstance(state.model, DeepFace)
    assert state.model.input_hw == (72, 72) and state.model.in_channels == 3
    assert np.isfinite(history[0].train["loss"])
    res = extract_features.main(
        ["--synthetic", "--model", "deepface", "--export-dir",
         out + "/export", "--out-dir", str(tmp_path / "ex"),
         "--batch-size", "16", "--device", "cpu"])
    feats = res["valid"].features
    assert feats.shape[1] == 4096 and np.isfinite(feats).all()
