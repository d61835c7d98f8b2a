"""The port's data- and class-parallel training on gloo ranks.

Spawned CPU processes (``_torch_ranks.run_ranks``: 2 ranks, then 4; one
torch thread each) run the port's sharded steps on each rank's block of
the same seeded numpy batches, from weights carried over from the JAX
inits. They are held to the JAX package at the same layout on the
conftest's CPU mesh:

- ``shard_map_step`` of the head (``semi_hard_fused``: B1's plain
  version here, the Pallas kernel in interpret mode there) and of
  LightCNN29 at 32x32 (local BatchNorm statistics, averaged running
  ones; dropout off on both sides) on ``make_mesh(devices[:2])``;
- ``shard_map_step_2d`` with ``infer_class_parallel_specs`` on a 2x2
  (data, model) mesh with the JAX test's dropout- and BN-free net;
- ``shard_map_gan_step`` on 2 devices, each rank fed its device's ``z``.

The CLIs, the world-1 equalities and checkpoints are in
tests/test_torch_parallel_cli.py. Tolerances are stated at each check.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

from _torch_ranks import run_ranks
from improving_face_recognition_performance_using_triplet_loss_tpu import (
    train as jtrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    LightCNN29 as JLightCNN29,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models.began_cs import (
    AutoencoderDiscriminator as JAE,
    Generator as JGenerator,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models.heads import (
    LinearHead as JLinearHead,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.parallel import (
    make_mesh as jmake_mesh,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.train.gan import (
    create_gan_state as jcreate_gan_state,
    make_began_cs_train_step as jmake_gan_step,
    shard_map_gan_step as jshard_map_gan_step,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    PairBatcher,
    synthetic_faces,
    synthetic_features,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    model_by_name,
)

LR, NC, SIZE = 1e-5, 8, 32
GRAD_RTOL = 1e-2   # LightCNN29 vs JAX, as tests/test_torch_backbone.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _recording(tx):
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


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


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _flax_grads(name, classes, size, grads):
    """A port gradient dict (torch names) as a flax tree."""
    twin = model_by_name(name, classes, input_hw=(size, size), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    twin.load_state_dict({k: torch.from_numpy(v) for k, v in grads.items()},
                         strict=False)
    return twin.flax_params()


# ------------------------------------------------------------ 2 ranks


def _head_setup():
    feats, labels = synthetic_features(num_ids=8, per_id=8, dim=16, seed=3)
    batches = [tuple(np.asarray(x) for x in b)
               for b in list(PairBatcher(feats, labels, 16, seed=0))[:3]]
    model = JLinearHead(out_dim=8)
    state = jtrain.create_train_state(model, jtrain.sgd_wd(lr=1e-2),
                                      jax.random.PRNGKey(0), feats[:1])
    return model, state, batches


def _lightcnn29_setup():
    faces, labels = synthetic_faces(num_ids=NC, per_id=4, size=SIZE, seed=0)
    batches = list(PairBatcher(faces, labels, 8, seed=0))[:1]
    model = JLightCNN29(num_classes=NC)
    tx = _recording(jtrain.backbone_optimizer("sgd", base_lr=LR,
                                              decay_every_steps=1000))
    init_rng, base_key = jax.random.split(jax.random.PRNGKey(0))
    variables = jax.jit(model.init)(init_rng, jnp.asarray(faces[:1]))
    state = jtrain.TrainState(
        params=variables["params"], opt_state=tx.init(variables["params"]),
        batch_stats=variables["batch_stats"],
        step=jnp.zeros((), jnp.int32), base_key=base_key)
    return model, tx, state, batches


def _gan_setup():
    b, size, n, h = 4, 16, 8, 8
    rng = np.random.default_rng(3)
    anc = rng.uniform(-1, 1, (2 * b, size, size, 3)).astype(np.float32)
    pos = np.clip(anc + rng.normal(0, 0.1, anc.shape), -1, 1).astype(
        np.float32)
    batch = (anc, pos, np.arange(2 * b) % 3)
    g, d = (JGenerator(size=size, channels=3, n=n, h_dim=h),
            JAE(size=size, channels=3, n=n, h_dim=h))
    gtx, dtx = _recording(optax.sgd(1e-3)), _recording(optax.sgd(1e-3))
    state = jcreate_gan_state(g, d, gtx, dtx, jax.random.PRNGKey(0),
                              jnp.asarray(anc), h)
    # each device's z: fold_in(fold_in(base_key, step), index), split
    zs = []
    for i in range(2):
        key = jax.random.fold_in(jax.random.fold_in(state.base_key,
                                                    state.step), i)
        k_z, _ = jax.random.split(key)
        zs.append(np.asarray(jax.random.uniform(k_z, (2 * b, h), jnp.float32,
                                                -1.0, 1.0)))
    return (g, d, gtx, dtx, state, batch, zs,
            dict(size=size, filters=n, h_dim=h))


@pytest.fixture(scope="module")
def two():
    _, hstate, hbatches = _head_setup()
    _, _, bstate, bbatches = _lightcnn29_setup()
    *_, gstate, gbatch, zs, gcfg = _gan_setup()
    payload = {
        "head_dp_job": {"params": _np(hstate.params), "batches": hbatches,
                        "lr": 1e-2, "mode": "semi_hard_fused"},
        "backbone_parallel_job": {
            "model": "lightcnn29", "classes": NC, "size": SIZE,
            "params": _np(bstate.params),
            "batch_stats": _np(bstate.batch_stats), "no_dropout": True,
            "batches": bbatches, "lr": LR, "mode": "semi_hard",
            "margin": 2.0},
        "gan_dp_job": {"gen_params": _np(gstate.gen_params),
                       "disc_params": _np(gstate.disc_params),
                       "batch": gbatch, "z": zs, "lr": 1e-3,
                       "mode": "semi_hard", **gcfg},
    }
    return {"ranks": run_ranks(list(payload), 2, payload)}


def _jax_dp_first_step(jstep, state, batch, intercept=None):
    """JAX's ``shard_map_step`` from ``state`` on one global batch: its
    metrics, and its raw gradient (``_recording``) divided by the data
    axis size. Under ``check_vma=True`` the pbroadcast transpose already
    sums a replicated parameter's gradient over the axis, and the 1-D step
    then ``pmean``-s it once more, so the JAX update is n_data times the
    mean (ROADMAP.md C8; the 2-D step divides instead). The port averages:
    its gradient is JAX's over n_data, and only the first step starts
    from the same state."""
    if intercept is not None:
        with fnn.intercept_methods(intercept):
            new, m = jstep(state, *batch)
    else:
        new, m = jstep(state, *batch)
    grads = jax.tree_util.tree_map(lambda g: np.asarray(g) / 2.0,
                                   new.opt_state[0])
    return _np(m), grads, new


def test_head_dp_step_matches_jax(two):
    """2-rank head steps against JAX's ``shard_map_step`` on 2 devices
    (``semi_hard_fused``): the first step's loss to 1e-5 relative, its
    per-row cosines (gathered in rank order) to 1e-5 and its gradient to
    1e-5 by relative norm (JAX's over n_data, see
    ``_jax_dp_first_step``); the eval step to 1e-5. The later steps are
    held to one process running the global batch (the CLI test)."""
    model, state, batches = _head_setup()
    mesh = jmake_mesh(jax.devices()[:2])
    tx = _recording(jtrain.sgd_wd(lr=1e-2))
    jstep = jtrain.shard_map_step(
        jtrain.make_head_train_step(model, tx, mining_mode="semi_hard_fused",
                                    axis_name="data"),
        mesh, has_state_out=True, metric_keys=jtrain.HEAD_METRIC_KEYS)
    jev = jtrain.shard_map_step(
        jtrain.make_head_eval_step(model, mining_mode="semi_hard_fused",
                                   axis_name="data"),
        mesh, has_state_out=False, metric_keys=jtrain.HEAD_METRIC_KEYS)
    state = state.replace(opt_state=tx.init(state.params))
    want_eval = _np(jev(state, *batches[0]))
    w, wg, _ = _jax_dp_first_step(jstep, state, batches[0])
    for out in (r["head_dp_job"] for r in two["ranks"]):
        got = out["metrics"][0]
        assert got["loss"] == pytest.approx(float(w["loss"]), rel=1e-5)
        for k in ("pos_cos", "neg_cos"):
            assert got[k].shape == (16,)
            np.testing.assert_allclose(got[k], w[k], atol=1e-5)
        assert _rel(out["grads"][0]["proj.weight"].T,
                    wg["proj"]["kernel"]) <= 1e-5
        for k in ("loss", "pos_cos", "neg_cos"):
            np.testing.assert_allclose(out["eval"][k], want_eval[k],
                                       rtol=1e-5, atol=1e-6)


def test_backbone_dp_step_matches_jax(two):
    """LightCNN29 at 32x32 over 2 ranks against JAX's ``shard_map_step``
    (both normalize with each rank's batch statistics and average the
    running ones): the first step's losses to 1e-3 relative, cosines to
    5e-4, every leaf's gradient to 1e-2 by relative norm (the EFM max/min
    near-ties of tests/test_torch_backbone.py; JAX's over n_data), the
    running statistics after it to 1e-3."""
    model, tx, state, batches = _lightcnn29_setup()
    jstep = jtrain.shard_map_step(
        jtrain.make_backbone_train_step(model, tx, mining_mode="semi_hard",
                                        margin=2.0, axis_name="data"),
        jmake_mesh(jax.devices()[:2]), has_state_out=True)
    w, wg, new = _jax_dp_first_step(jstep, state, batches[0], _no_dropout)
    for out in (r["backbone_parallel_job"] for r in two["ranks"]):
        got = out["metrics"][0]
        for k in ("loss", "id_loss", "tl_loss"):
            assert got[k] == pytest.approx(float(w[k]), rel=1e-3), k
        for k in ("pos_cos", "neg_cos"):
            assert got[k].shape == (8,)
            np.testing.assert_allclose(got[k], w[k], atol=5e-4)
        tree = _flax_grads("lightcnn29", NC, SIZE, out["grads"][0])
        for path, leaf in _leaves(wg):
            assert _rel(_get(tree, path), leaf) <= GRAD_RTOL, path
        for path, leaf in _leaves(_np(new.batch_stats)):
            np.testing.assert_allclose(_get(out["batch_stats"], path), leaf,
                                       rtol=1e-3,
                                       atol=1e-5 * np.abs(leaf).max())


def test_gan_dp_step_matches_jax(two):
    """One 2-rank BEGAN-CS step against JAX's ``shard_map_gan_step``,
    each rank fed its device's ``z``: the averaged losses to 1e-5
    relative (``k_t``, 1e-3 times a difference of two of them, to 1e-9
    absolute), the gathered cosines to 1e-5, both players' averaged
    gradients to 1e-4 by relative norm (this step runs with
    ``check_vma=False``: JAX's ``pmean`` is the mean)."""
    g, d, gtx, dtx, state, batch, zs, cfg = _gan_setup()
    jstep = jshard_map_gan_step(jmake_gan_step(
        g, d, gtx, dtx, h_dim=cfg["h_dim"], mining_mode="semi_hard",
        triplet_margin=2.0, axis_name="data"), jmake_mesh(jax.devices()[:2]))
    state, m = jstep(state, *batch)
    m = _np(m)
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.began_cs import (
        AutoencoderDiscriminator,
        Generator,
    )

    for out in (r["gan_dp_job"] for r in two["ranks"]):
        for k, v in out["metrics"].items():
            if k in ("pos_cos", "neg_cos"):
                np.testing.assert_allclose(v, m[k], atol=1e-5)
            elif k == "k_t":   # 1e-3 x a difference of two losses
                assert float(v) == pytest.approx(float(m[k]), abs=1e-9)
            else:
                assert float(v) == pytest.approx(float(m[k]), rel=1e-5), k
        for cls, grads, want in (
                (Generator, out["gen_grads"], state.gen_opt[0]),
                (AutoencoderDiscriminator, out["disc_grads"],
                 state.disc_opt[0])):
            twin = cls(cfg["size"], 3, cfg["filters"], cfg["h_dim"])
            twin.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in grads.items()})
            tree = twin.flax_params()
            for path, leaf in _leaves(_np(want)):
                assert _rel(_get(tree, path), leaf) <= 1e-4, path


# ------------------------------------------------------------ 4 ranks


C4 = 12


class _TinyNet(fnn.Module):
    """The JAX class-parallel test's dropout- and BN-free net."""

    num_classes: int
    feature_dim: int = 8

    @fnn.compact
    def __call__(self, x, *, train: bool = False):
        x = x.reshape((x.shape[0], -1))
        feat = fnn.tanh(fnn.Dense(self.feature_dim, name="fc1")(x))
        return fnn.Dense(self.num_classes, name="fc2")(feat), feat


def _tiny_setup():
    rng = np.random.default_rng(3)
    b = 8
    batch = (rng.random((b, 6, 6, 1)).astype(np.float32),
             rng.random((b, 6, 6, 1)).astype(np.float32),
             rng.integers(0, C4, b))
    chunk = (rng.random((3, b, 6, 6, 1)).astype(np.float32),
             rng.random((3, b, 6, 6, 1)).astype(np.float32),
             rng.integers(0, C4, (3, b)))
    state = jtrain.create_train_state(_TinyNet(num_classes=C4),
                                      optax.sgd(0.1), jax.random.PRNGKey(0),
                                      batch[0][:1])
    return state, batch, chunk


@pytest.fixture(scope="module")
def four():
    state, batch, chunk = _tiny_setup()
    payload = {"class_parallel_tiny_job": {"params": _np(state.params),
                                           "classes": C4, "batch": batch,
                                           "chunk": chunk}}
    return run_ranks(list(payload), 4, payload)


def test_class_parallel_step_matches_jax(four):
    """A (data 2 x model 2) step of the tiny net against JAX's
    ``shard_map_step_2d`` with ``infer_class_parallel_specs``: id loss to
    1e-5 relative, triplet loss to 1e-4, accuracy exactly, the fc2 blocks
    gathered and fc1 after the update to 1e-5 (rtol 1e-4)."""
    state, batch, _ = _tiny_setup()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    tx = optax.sgd(0.1)
    specs = jtrain.infer_class_parallel_specs(state, C4, "model")
    jstep = jtrain.shard_map_step_2d(
        jtrain.make_backbone_train_step(_TinyNet(num_classes=C4 // 2), tx,
                                        mining_mode="hard", axis_name="data",
                                        class_axis_name="model"),
        mesh, specs, has_state_out=True)
    jstate, jm = jstep(state, *batch)
    jm = _np(jm)
    for out in (r["class_parallel_tiny_job"] for r in four):
        assert out["specs"] == {"fc2.weight": "model", "fc2.bias": "model"}
        assert out["fc2_local"] == (C4 // 2, 8)
        m = out["metrics"]
        assert float(m["id_loss"]) == pytest.approx(float(jm["id_loss"]),
                                                    rel=1e-5)
        assert float(m["tl_loss"]) == pytest.approx(float(jm["tl_loss"]),
                                                    rel=1e-4, abs=1e-6)
        assert float(m["acc"]) == float(jm["acc"])
        np.testing.assert_allclose(
            out["fc2"].T, np.asarray(jstate.params["fc2"]["kernel"]),
            rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(
            out["fc1"].T, np.asarray(jstate.params["fc1"]["kernel"]),
            rtol=1e-4, atol=1e-5)


def test_class_parallel_scanned_equals_sequential(four):
    """Three scanned 2-D steps equal three single ones: the same losses
    and bit-equal weights; per-row cosines stacked [K, B]."""
    for out in (r["class_parallel_tiny_job"] for r in four):
        np.testing.assert_array_equal(out["scan_losses"], out["seq_losses"])
        assert out["seq_equal_scan"] and out["scan_step"] == 3
        assert tuple(out["scan_pos_cos"]) == (3, 8)


