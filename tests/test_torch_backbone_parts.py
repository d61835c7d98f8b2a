"""The parts of the port's backbone slice against the JAX package, on the
CPU: the six optimizer families and the parameter EMA against optax, the
factor schedule, the joint and center losses, the streaming batcher, the
CLI's host mirror, the image store writer, the batch transforms and
device prefetching.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu import (
    train as jtrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    train_backbone as jtrain_backbone,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.data import (
    records as jrecords,
    streaming as jstreaming,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.losses import (
    center as jcenter,
    triplet as jtriplet,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    train as ttrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    train_backbone as ttrain_backbone,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    ShardedPairBatcher,
    records as trecords,
    shard_bounds,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.prefetch import (
    prefetch_to_device,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.losses import (
    center as tcenter,
    triplet as ttriplet,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's thread pools oversubscribe the cores (a 10x slowdown
    measured under the suite's six workers)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


T = torch.from_numpy


# -------------------------------------------------------------- optimizers


class _Tiny(torch.nn.Module):
    """Two raw parameters in the JAX tree's layout, ``{"w", "b"}``."""

    def __init__(self, w, b):
        super().__init__()
        self.w = torch.nn.Parameter(T(w.copy()))
        self.b = torch.nn.Parameter(T(b.copy()))


def _tree_and_grads(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


def _optax_run(tx, params, grads):
    state = tx.init(params)
    out = []
    p = jax.tree_util.tree_map(jnp.asarray, params)
    for g in grads:
        upd, state = tx.update(g, state, p)
        p = optax.apply_updates(p, upd)
        out.append(jax.tree_util.tree_map(np.asarray, p))
    return out, state


def _torch_run(spec, params, grads, seed=0):
    module = _Tiny(params["w"], params["b"])
    state = ttrain.create_train_state(module, spec, seed)
    out = []
    for g in grads:
        module.w.grad, module.b.grad = T(g["w"]), T(g["b"])
        state.apply_update()
        out.append({"w": module.w.detach().numpy().copy(),
                    "b": module.b.detach().numpy().copy()})
    return out, state


@pytest.mark.parametrize("family", ttrain.FAMILIES)
def test_optimizer_family_matches_optax(family):
    """Three updates of a small tree under each family on the factor
    schedule (halving every 2 updates) with coupled weight decay: the
    parameters agree with optax's to float32 rounding (rtol 1e-5)."""
    params, grads = _tree_and_grads()
    kw = dict(base_lr=0.05, decay_every_steps=2, factor=0.5,
              weight_decay=1e-2)
    want, _ = _optax_run(jtrain.backbone_optimizer(family, **kw), params,
                         grads)
    got, state = _torch_run(ttrain.backbone_optimizer(family, **kw), params,
                            grads)
    for g, w in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{family} {k}")
    assert state.step == 3
    assert not np.allclose(got[-1]["w"], params["w"])


def test_param_ema_matches_optax():
    params, grads = _tree_and_grads(1)
    kw = dict(base_lr=0.05, decay_every_steps=2, factor=0.5)
    _, jstate = _optax_run(jtrain.with_param_ema(
        jtrain.adam_factor(**kw), decay=0.9), params, grads)
    _, tstate = _torch_run(ttrain.with_param_ema(
        ttrain.adam_factor(**kw), decay=0.9), params, grads)
    ema = ttrain.get_ema_params(tstate)
    want = jtrain.get_ema_params(jstate)
    for k in ("w", "b"):
        np.testing.assert_allclose(ema[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_factor_schedule_matches_jax():
    want = jtrain.factor_schedule(2.4e-4, 3, 0.88, stop_lr=1e-5)
    got = ttrain.factor_schedule(2.4e-4, 3, 0.88, stop_lr=1e-5)
    for step in range(120):
        assert got(step) == pytest.approx(float(want(jnp.int32(step))),
                                          rel=1e-6)
    assert got(119) == pytest.approx(1e-5, rel=1e-6)   # the floor


def test_optimizer_state_survives_checkpoint(tmp_path):
    """Every family's moments and the step restore, so a resumed run takes
    the same next update."""
    params, grads = _tree_and_grads(2, steps=4)
    for family in ttrain.FAMILIES:
        spec = ttrain.with_param_ema(ttrain.backbone_optimizer(
            family, base_lr=0.05, decay_every_steps=2), 0.9)
        straight, _ = _torch_run(spec, params, grads)
        first, state = _torch_run(spec, params, grads[:2])
        ckpt = ttrain.Checkpointer(str(tmp_path / family))
        ckpt.save(0, state)
        fresh = ttrain.create_train_state(_Tiny(params["w"], params["b"]),
                                          spec, 9)
        fresh = ckpt.restore(fresh)
        assert fresh.step == 2 and fresh.seed == 0
        for g in grads[2:]:
            fresh.model.w.grad, fresh.model.b.grad = T(g["w"]), T(g["b"])
            fresh.apply_update()
        assert torch.equal(fresh.model.w.detach(), T(straight[-1]["w"])), \
            family


# ------------------------------------------------------------------ losses


def test_softmax_ce_and_joint_loss_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 9)).astype(np.float32) * 4
    labels = rng.integers(0, 9, 6)
    a, p, n = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3))
    for red in ("mean", "none"):
        np.testing.assert_allclose(
            ttriplet.softmax_cross_entropy(T(logits), T(labels),
                                           reduction=red).numpy(),
            np.asarray(jtriplet.softmax_cross_entropy(
                jnp.asarray(logits), jnp.asarray(labels), reduction=red)),
            rtol=1e-6, atol=1e-6)
    got = ttriplet.joint_id_triplet_loss(T(logits), T(labels), T(a), T(p),
                                         T(n), margin=0.2, alpha=0.1)
    want = jtriplet.joint_id_triplet_loss(jnp.asarray(logits),
                                          jnp.asarray(labels), a, p, n,
                                          margin=0.2, alpha=0.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_center_loss_matches_jax():
    """Duplicate labels accumulate their updates into the table."""
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(8, 5)).astype(np.float32)
    labels = np.array([0, 2, 2, 1, 0, 2, 3, 3])
    centers = rng.normal(size=(4, 5)).astype(np.float32)
    jl, jc = jcenter.center_loss(jnp.asarray(feats), jnp.asarray(labels),
                                 jnp.asarray(centers), alfa=0.8)
    tl, tc = tcenter.center_loss(T(feats), T(labels), T(centers), alfa=0.8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-6)


# -------------------------------------------------------------------- data


@pytest.mark.parametrize("n,hosts", [(10, 3), (7, 7), (100, 4), (5, 1)])
def test_shard_bounds_match_jax(n, hosts):
    for h in range(hosts):
        assert shard_bounds(n, h, hosts) == jstreaming.shard_bounds(n, h,
                                                                    hosts)
    with pytest.raises(ValueError):
        shard_bounds(n, hosts, hosts)


@pytest.mark.parametrize("window,hosts", [(16, 1), (0, 1), (7, 3)])
def test_sharded_pair_batcher_matches_jax(tmp_path, window, hosts):
    """The same seed gives the same uint8 batches, epoch after epoch, from
    a store directory and from a preloaded pair."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (61, 4, 4, 1)).astype(np.uint8)
    labels = rng.integers(0, 9, 61)
    store = str(tmp_path / "store")
    trecords.save_image_store_mmap(store, images, labels)
    for host in range(hosts):
        kw = dict(host_id=host, num_hosts=hosts, shuffle_window=window,
                  seed=7)
        jb = jstreaming.ShardedPairBatcher(store, 5, **kw)
        tb = ShardedPairBatcher(store, 5, **kw)
        pb = ShardedPairBatcher((images, labels), 5, **kw)
        assert len(tb) == len(jb)
        for _ in range(2):
            for want, got, got2 in zip(jb, tb, pb):
                for w, g, g2 in zip(want, got, got2):
                    np.testing.assert_array_equal(g, w)
                    np.testing.assert_array_equal(g2, w)


def test_image_store_writer_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    chunks = [(rng.integers(0, 256, (n, 6, 5, 1)).astype(np.uint8),
               rng.integers(0, 4, n)) for n in (3, 1, 4)]
    chunks.append((rng.random((2, 6, 5, 1)).astype(np.float32), [1, 2]))
    for name, cls in (("j", jrecords.ImageStoreWriter),
                      ("t", trecords.ImageStoreWriter)):
        with cls(str(tmp_path / name), (6, 5, 1)) as w:
            for imgs, labs in chunks:
                w.append(imgs, labs)
        assert w.count == 10
    for f in ("images.npy", "labels.npy"):
        assert ((tmp_path / "t" / f).read_bytes()
                == (tmp_path / "j" / f).read_bytes())
    images, labels = trecords.load_image_store_mmap(str(tmp_path / "t"))
    assert images.shape == (10, 6, 5, 1) and labels.shape == (10,)


def test_normalizations_match_jax():
    rng = np.random.default_rng(7)
    u8 = rng.integers(0, 256, (3, 6, 5, 2)).astype(np.uint8)
    f32 = rng.random((3, 6, 5, 2)).astype(np.float32)
    # the jitted JAX division by 255 is a product with float32(1/255)
    np.testing.assert_array_equal(
        trecords.normalize_uint8(T(u8)).numpy(),
        np.asarray(jax.jit(jrecords.normalize_uint8)(u8)))
    for x in (f32, f32[0]):
        np.testing.assert_allclose(trecords.prewhiten(T(x)).numpy(),
                                   np.asarray(jrecords.prewhiten(x)),
                                   rtol=1e-5, atol=1e-5)
    for x in (u8, f32):
        np.testing.assert_allclose(
            trecords.fixed_standardization(T(x)).numpy(),
            np.asarray(jax.jit(jrecords.fixed_standardization)(x)),
            rtol=1e-6, atol=1e-6)


def test_rotation_matches_jax():
    """``rotate_images`` with the angles JAX's ``rotate_batch`` draws from
    its key gives JAX's result (bilinear, zero outside)."""
    x = np.random.default_rng(8).random((3, 12, 10, 2)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jrecords.rotate_batch(key, jnp.asarray(x), 30.0))
    ang = np.asarray(jax.random.uniform(key, (3,), minval=-30.0,
                                        maxval=30.0) * (jnp.pi / 180.0))
    got = trecords.rotate_images(T(x), T(ang)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    gen = torch.Generator().manual_seed(0)
    assert trecords.rotate_batch(gen, T(x)).shape == x.shape


def test_augment_batch_is_valid():
    """Each row is itself or its mirror, and each crop is a window of that
    row inside the image (the draws are torch's, not JAX's, so only their
    validity is checked)."""
    x = T(np.random.default_rng(9).random((64, 10, 10, 1)).astype(
        np.float32))
    gen = torch.Generator().manual_seed(1)
    m = trecords.augment_batch(gen, x, mirror=True)
    same = (m == x).flatten(1).all(1)
    flipped = (m == torch.flip(x, dims=(2,))).flatten(1).all(1)
    assert bool((same | flipped).all()) and 10 < int(flipped.sum()) < 54
    c = trecords.augment_batch(gen, x, mirror=False, crop_size=7)
    assert c.shape == (64, 7, 7, 1)
    seen = set()
    for i in range(64):
        hits = [(y, z) for y in range(4) for z in range(4)
                if torch.equal(c[i], x[i, y:y + 7, z:z + 7])]
        assert hits, i
        seen.update(hits)
    assert len(seen) > 4   # offsets vary


def test_prefetch_on_cpu_yields_the_same_batches():
    rng = np.random.default_rng(10)
    batches = [(rng.integers(0, 256, (4, 3, 3, 1)).astype(np.uint8),
                rng.random((4, 3, 3, 1)).astype(np.float32),
                rng.integers(0, 5, 4)) for _ in range(5)]
    for size in (1, 2, 8):
        got = list(prefetch_to_device(iter(batches), size=size,
                                      device="cpu"))
        assert len(got) == 5
        for g, w in zip(got, batches):
            for gt, wt in zip(g, w):
                assert isinstance(gt, torch.Tensor) and not gt.is_pinned()
                np.testing.assert_array_equal(gt.numpy(), wt)


@pytest.mark.parametrize("shape,dtype", [
    ((6, 8, 10, 1), np.uint8), ((6, 8, 10, 3), np.uint8),
    ((5, 7, 9, 3), np.float32)], ids=["gray", "rgb", "rgb_f32"])
def test_host_mirror_matches_jax(shape, dtype):
    """``MirrorBatches`` mirrors the rows the JAX CLI's ``_MirrorBatches``
    mirrors, bit for bit, from the same draws, and leaves the batcher's
    arrays as they were."""
    rng = np.random.default_rng(0)
    batches = [(rng.integers(0, 256, size=shape).astype(dtype),
                rng.integers(0, 256, size=shape).astype(dtype),
                np.arange(shape[0])) for _ in range(4)]
    kept = [(a.copy(), p.copy()) for a, p, _ in batches]
    got = list(ttrain_backbone.MirrorBatches(batches, True, 7))
    want = list(jtrain_backbone._MirrorBatches(batches, True, 7))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    for (a, p, _), (ka, kp) in zip(batches, kept):
        assert np.array_equal(a, ka) and np.array_equal(p, kp)



def test_host_mirror_assembles_ahead_in_order():
    """The batch after the one handed on is assembled on a worker thread:
    unmirrored, the batcher's batches come through in order; the worker
    draws at most one batch ahead; closed early, the iterator stops its
    worker."""
    import threading

    drawn = []

    def batcher():
        for i in range(5):
            drawn.append(i)
            yield np.full((2, 3, 3, 1), i, np.uint8), np.zeros(
                (2, 3, 3, 1), np.uint8), np.array([i, i])

    class Batcher:
        def __iter__(self):
            return batcher()

    got = [int(a[0, 0, 0, 0])
           for a, _, _ in ttrain_backbone.MirrorBatches(Batcher(), False, 0)]
    assert got == [0, 1, 2, 3, 4]
    before = threading.active_count()
    drawn.clear()
    it = iter(ttrain_backbone.MirrorBatches(Batcher(), True, 0))
    next(it)
    it.close()
    # the next batch was under way, or cancelled before it began
    assert drawn in ([0], [0, 1])
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before
