"""The port's parallel CLIs, world-1 equalities and checkpoints, on gloo
ranks.

Spawned CPU processes (``_torch_ranks.run_ranks``, one torch thread each):

- ``train_head --data-parallel`` on 2 ranks equals the plain run of the
  same argv (a DP step equals one process running the global batch);
- a 1x2 class-parallel LightCNN29 step's gradients (``fc2``'s two blocks
  concatenated, every backbone leaf) equal the world-1 step's, which an
  all-reduce that also reduced the gradient (2x) would fail;
- a class-parallel state under Adam resumes bit-equal from rank 0's one
  checkpoint, which holds the whole ``fc2`` and its moments;
- ``train_backbone --class-parallel 2`` on 2 ranks resumes, and exports
  the whole ``fc2`` for the JAX package;
- the streaming batcher's two shards are ``shard_bounds``'.

Tolerances are stated at each check.
"""

import os

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
    load_exported_params as jload_exported_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    parallel,
    train as ttrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    train_head,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    PairBatcher,
    save_feature_store,
    shard_bounds,
    synthetic_faces,
    synthetic_features,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.records import (
    save_image_store_mmap,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    model_by_name,
)
from test_torch_parallel_train import C4, GRAD_RTOL, LR, NC, SIZE, _np, _rel
from test_torch_parallel_train import _tiny_setup


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _stream_store(tmp):
    n = 101
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (n, 8, 8, 1), dtype=np.uint8)
    path = str(tmp / "store")
    save_image_store_mmap(path, images, np.arange(n))
    return path, n


def _cp_argv(out, epochs, *extra):
    return ["--synthetic", "--synthetic-size", "16", "--model", "lightcnn9",
            "--class-parallel", "2", "--epochs", str(epochs),
            "--batch-size", "64", "--mining", "semi_hard", "--device", "cpu",
            "--out-dir", out, *extra]


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    store, _ = _stream_store(tmp)
    feats, labels = synthetic_features(num_ids=16, per_id=8, dim=24, seed=1)
    fstore = str(tmp / "feats.npz")
    save_feature_store(fstore, feats, labels)
    head_argv = ["--features", fstore, "--epochs", "2", "--batch-size",
                 "32", "--mining", "semi_hard_fused", "--device", "cpu",
                 "--data-parallel", "--out-dir", str(tmp / "head2")]
    state, batch, _ = _tiny_setup()
    cp = {"cli": "train_backbone", "argvs": [
        _cp_argv(str(tmp / "A"), 2), _cp_argv(str(tmp / "B"), 1),
        _cp_argv(str(tmp / "B"), 2, "--resume")]}
    payload = {
        "streaming_shards_job": {"store": store, "batch": 10, "window": 16},
        "cli_job": {"cli": "train_head", "argvs": [head_argv] + cp["argvs"],
                    "clis": ["train_head"] + ["train_backbone"] * 3},
        "cp_resume_job": {"params": _np(state.params), "classes": C4,
                          "batch": batch},
        "backbone_parallel_job": {
            "model": "lightcnn29", "classes": NC, "size": SIZE,
            "batches": _m_fold_setup(), "lr": LR, "mode": "semi_hard",
            "margin": 2.0, "model_size": 2},
    }
    return {"tmp": tmp, "ranks": run_ranks(list(payload), 2, payload),
            "head_argv": head_argv}


def test_streaming_shards_partition_the_store(two):
    """``train_backbone``'s mmap batcher on 2 data ranks: each rank reads
    the contiguous shard ``shard_bounds`` gives it, batch/2 rows at a time,
    and both take as many steps (the smaller shard's count)."""
    for r, out in enumerate(x["streaming_shards_job"] for x in two["ranks"]):
        start, stop = shard_bounds(101, r, 2)
        assert out["bounds"] == (start, stop)
        assert set(out["sizes"]) == {5} and out["steps"] == 50 // 5
        assert out["labels"].min() >= start and out["labels"].max() < stop
    a, b = (x["streaming_shards_job"]["bounds"] for x in two["ranks"])
    assert a[1] == b[0] and a[0] == 0 and b[1] == 101


def test_train_head_cli_data_parallel_equals_one_process(two):
    """``train_head --data-parallel`` on 2 ranks against the plain run of
    the same argv: per-step losses to 1e-5 relative, the cosine CSV (rank
    0's, the only one) to 1e-6, one log file."""
    tmp = two["tmp"]
    argv = [a for a in two["head_argv"] if a != "--data-parallel"]
    argv[argv.index("--out-dir") + 1] = str(tmp / "head1")
    _, hist = train_head.main(argv)
    got = two["ranks"][0]["cli_job"][0]
    assert [len(h["steps"]) for h in got] == [len(h.steps) for h in hist]
    for g, h in zip(got, hist):
        np.testing.assert_allclose(g["steps"], [s["loss"] for s in h.steps],
                                   rtol=1e-5)
    a = np.loadtxt(tmp / "head1" / "cosine_similarity.csv", ndmin=2)
    b = np.loadtxt(tmp / "head2" / "cosine_similarity.csv", ndmin=2)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, atol=1e-6)
    assert len(os.listdir(tmp / "head2" / "log")) == 1


def test_class_parallel_checkpoint_resumes_bit_equal(two):
    """A 1x2 class-parallel state under Adam (fc2 and both moments
    sharded) saved after two steps -- rank 0's one file holds the whole
    fc2 and moments -- and restored into a state built from zeros takes
    the next step bit-equal to the uninterrupted run, as
    tests/test_checkpoint_sharded.py pins for JAX."""
    for out in (r["cp_resume_job"] for r in two["ranks"]):
        assert out["step"] == 2 and out["local_fc2"] == (C4 // 2, 8)
        assert out["loss_equal"] and out["params_equal"]
        assert out["file_fc2"] == (C4, 8)
        assert out["file_moments"].count((C4, 8)) == 2


def test_train_backbone_cli_class_parallel_resume(two):
    """``train_backbone --class-parallel 2`` on 2 ranks, 1 epoch then
    ``--resume`` to 2: the resume starts at epoch 1 from the checkpoint
    (whole fc2 and Adam moments in rank 0's file), the second epoch's
    first steps equal the uninterrupted run's (the batcher restarts its
    order, as the JAX CLI's, so only the first epoch's order is shared:
    the resumed epoch is held to finite losses), and the export holds the
    whole fc2 in flax layout, which the JAX package loads."""
    tmp = two["tmp"]
    blob = torch.load(tmp / "B" / "ckpt" / "1" / "state.pt",
                      weights_only=True)
    assert blob["model"]["fc2.weight"].shape[0] == 16
    moments = [v for st in blob["optimizer"]["state"].values()
               for v in st.values() if getattr(v, "ndim", 0) == 2
               and v.shape[0] == 16]
    assert len(moments) == 2                # adam's two moments of fc2
    for run in ("A", "B"):
        params, _, manifest = jload_exported_params(str(tmp / run /
                                                        "export"))
        assert manifest["model"] == "lightcnn9"
        assert params["fc2"]["kernel"].shape == (256, 16)
    hist = two["ranks"][0]["cli_job"][1:]
    assert len(hist[0]) == 2 and len(hist[1]) == 1 and len(hist[2]) == 1
    assert hist[1][0]["steps"] == hist[0][0]["steps"]
    assert np.isfinite(hist[2][0]["steps"]).all()
    assert len(os.listdir(tmp / "B" / "log")) == 2    # rank 0's two runs


def _m_fold_setup():
    faces, labels = synthetic_faces(num_ids=NC, per_id=4, size=SIZE, seed=1)
    return list(PairBatcher(faces, labels, 8, seed=0))[:2]


def test_class_parallel_gradients_are_not_m_fold(two):
    """LightCNN29 at 32x32 with dropout on, class-parallel over a 1x2
    mesh, against the world-1 data-parallel step of this process (the
    same generator: data rank 0): in the first step every backbone
    leaf's gradient and the two fc2 blocks concatenated equal the world-1
    gradients to 1e-5 by relative norm, and the losses to 1e-5 (the
    second step, from weights that differ by rounding, to 1e-2 and 1e-4)
    -- a backward that summed the replicated loss's gradient over the
    model group would make them 2x."""
    batches = _m_fold_setup()
    model = model_by_name("lightcnn29", NC, input_hw=(SIZE, SIZE),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    with parallel.process_group("cpu"):
        mesh = parallel.make_mesh()
        state = ttrain.create_train_state(
            model, ttrain.backbone_optimizer("sgd", base_lr=LR,
                                             decay_every_steps=1000), 0)
        kept = []
        update = state.apply_update

        def apply_update():
            kept.append({n: q.grad.detach().numpy().copy()
                         for n, q in state.model.named_parameters()})
            update()

        state.apply_update = apply_update
        step = ttrain.shard_map_step(
            ttrain.make_backbone_train_step(mining_mode="semi_hard",
                                            margin=2.0, axis_name="data"),
            mesh, has_state_out=True)
        want = [step(state, *b)[1] for b in batches]
    for out in (r["backbone_parallel_job"] for r in two["ranks"]):
        for i, (got, w, g, k) in enumerate(zip(out["metrics"], want,
                                               out["grads"], kept)):
            # the first step starts from the same state; after it the
            # weights differ by rounding, which an EFM max/min near-tie
            # turns into a gradient gap (GRAD_RTOL, as against JAX)
            rtol, grad_rtol = (1e-5, 1e-5) if i == 0 else (1e-4, GRAD_RTOL)
            for key in ("loss", "id_loss", "tl_loss", "acc"):
                assert float(got[key]) == pytest.approx(float(w[key]),
                                                        rel=rtol), key
            assert set(g) == set(k)
            for name in k:
                assert _rel(g[name], k[name]) <= grad_rtol, name
