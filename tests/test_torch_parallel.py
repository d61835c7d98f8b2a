"""The port's ``parallel/`` and ``losses/sharded.py`` on gloo ranks.

Four spawned CPU processes (``_torch_ranks.run_ranks``, one torch thread
each) build a 2x2 ``DeviceMesh`` and run every collective of
``parallel/collectives.py`` on known inputs, and the class-parallel CE
and argmax over a 1x4 mesh, held to the JAX package's
``class_parallel_softmax_ce`` / ``class_parallel_argmax`` under
``shard_map`` on the conftest's CPU mesh (2 x 4 devices: the same four
class blocks). Tolerances: the CE to 1e-6 relative, its gradient to 1e-6
(atol 1e-7); indices and layouts exact. The world-1 tests run in this
process (a group of one over an in-process store).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from _torch_ranks import run_ranks
from improving_face_recognition_performance_using_triplet_loss_tpu.losses.sharded import (
    class_parallel_argmax as jargmax,
    class_parallel_softmax_ce as jce,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.parallel import (
    make_2d_mesh as jmake_2d_mesh,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    parallel,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.parallel import (
    distributed,
)

C = 12


def _ce_inputs():
    rng = np.random.default_rng(1)
    ce = {"logits": (rng.normal(size=(6, C)) * 3).astype(np.float32),
          "labels": rng.integers(0, C, 6).astype(np.int64)}
    logits = rng.normal(size=(16, C)).astype(np.float32)
    logits[0] = 0.0                      # all ties: class 0
    logits[1, [2, 5, 9]] = 10.0           # a tie across shards: class 2
    logits[2, [7, 8]] = 10.0              # a tie inside one shard: 7
    return ce, {"logits": logits, "labels": np.zeros(16, np.int64)}


@pytest.fixture(scope="module")
def ranks():
    ce, am = _ce_inputs()
    return run_ranks(["collectives_job", "sharded_ce_job"], 4,
                     {"sharded_ce_job": {"ce": ce, "argmax": am}})


def test_mesh_layout_and_backend(ranks):
    """Ranks fill the (data, model) mesh in row-major order over gloo;
    each data rank's block of 8 rows is rows [4d, 4d + 4)."""
    for r, out in enumerate(x["collectives_job"] for x in ranks):
        assert out["rank"] == r and out["backend"] == "gloo"
        assert out["info"] == (r, 4)
        assert out["data"] == (r // 2, 2) and out["model"] == (r % 2, 2)
        assert out["flat"] == (r, 4)
        np.testing.assert_array_equal(out["block"],
                                      np.arange(8)[4 * (r // 2):][:4])
        np.testing.assert_array_equal(out["model_block"],
                                      np.arange(8)[4 * (r % 2):][:4])
        assert out["split_error"] == ("3 rows do not split over the 2 "
                                      "ranks of mesh axis 'data'")


def test_all_gather_rows_forward_and_backward(ranks):
    """Forward: the data group's blocks in rank order. Backward: the
    gathered gradient summed over the group, then this rank's block (the
    transpose of JAX's tiled all_gather)."""
    for r, out in enumerate(x["collectives_job"] for x in ranks):
        peers = [r % 2, r % 2 + 2]   # the data group: one model index
        want = np.concatenate([np.full((2, 3), float(q)) for q in peers])
        np.testing.assert_array_equal(out["gathered"], want)
        w = np.arange(12, dtype=np.float32).reshape(4, 3)
        full = sum(w * (q + 1) for q in peers)
        i = peers.index(r)
        np.testing.assert_array_equal(out["gather_grad"],
                                      full[2 * i:2 * i + 2])


def test_copy_and_all_reduce_backward_rules(ranks):
    """``copy_to_model_group``: identity forward, gradient summed over the
    model group. ``all_reduce``: the sum forward, the gradient unchanged.
    ``torch.distributed.nn.functional.all_reduce`` (the trap) multiplies
    a replicated loss's gradient by the group size."""
    for r, out in enumerate(x["collectives_job"] for x in ranks):
        model_peers = [2 * (r // 2), 2 * (r // 2) + 1]
        np.testing.assert_array_equal(
            out["copy_grad"], np.full(3, sum(q + 1 for q in model_peers)))
        data_peers = [r % 2, r % 2 + 2]
        np.testing.assert_array_equal(
            out["sum"], np.full(3, sum(q + 1 for q in data_peers)))
        np.testing.assert_array_equal(out["sum_grad"], np.full(3, 2.0))
        np.testing.assert_array_equal(out["trap_grad"], np.full(3, 2.0))
        np.testing.assert_array_equal(out["max"], [max(data_peers),
                                                   -min(data_peers)])
        np.testing.assert_array_equal(out["min"], [min(model_peers),
                                                   -max(model_peers)])
        assert out["pmean"] == 1.5
        np.testing.assert_array_equal(out["bools"],
                                      [True, False, True, False])


def _jax_sharded(fn, out_spec):
    mesh = jmake_2d_mesh(model_size=4)
    return jax.jit(jax.shard_map(fn, mesh=mesh,
                                 in_specs=(P(None, "model"), P()),
                                 out_specs=out_spec, check_vma=True))


def test_sharded_ce_matches_jax(ranks):
    """The same loss on every rank, JAX's to 1e-6 relative, and each
    rank's gradient block JAX's to 1e-6 (the sum over ranks would be 4x
    with an all-reduce that reduces the gradient too)."""
    ce, _ = _ce_inputs()
    logits, labels = jnp.asarray(ce["logits"]), jnp.asarray(ce["labels"],
                                                            jnp.int32)
    loss = float(_jax_sharded(lambda lg, lb: jce(lg, lb, "model"),
                              P())(logits, labels))
    grad = np.asarray(_jax_sharded(jax.grad(
        lambda lg, lb: jce(lg, lb, "model")), P(None, "model"))(
            logits, labels))
    for r, out in enumerate(x["sharded_ce_job"]["ce"] for x in ranks):
        assert out["loss"] == pytest.approx(loss, rel=1e-6)
        np.testing.assert_allclose(out["grad"], grad[:, 3 * r:3 * r + 3],
                                   rtol=1e-6, atol=1e-7)


def test_sharded_argmax_matches_jax(ranks):
    """The global argmax over the shards equals JAX's and numpy's
    exactly; ties go to the smallest global class, within a shard and
    across shards."""
    _, am = _ce_inputs()
    want = np.asarray(_jax_sharded(lambda lg, _: jargmax(lg, "model"),
                                   P())(jnp.asarray(am["logits"]),
                                        jnp.zeros((16,), jnp.int32)))
    np.testing.assert_array_equal(want, am["logits"].argmax(-1))
    assert list(want[:3]) == [0, 2, 7]
    for out in (x["sharded_ce_job"]["argmax"] for x in ranks):
        np.testing.assert_array_equal(out["argmax"], want)


def test_no_group_is_world_one(monkeypatch):
    """Without a group or a launcher's environment: ``process_info`` is
    ``(0, 1)`` and ``initialize_distributed`` returns False, as the JAX
    twin; ``process_group`` makes a group of one (gloo on the CPU), over
    which every helper is the identity, and leaves it on exit."""
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    assert parallel.process_info() == (0, 1)
    assert parallel.initialize_distributed(device="cpu") is False
    with parallel.process_group("cpu") as info:
        assert info == (0, 1) and dist.get_backend() == "gloo"
        mesh = parallel.make_mesh()
        x = np.arange(6)
        np.testing.assert_array_equal(parallel.local_block(x, mesh), x)
        np.testing.assert_array_equal(parallel.data_sharding(mesh)(x), x)
        assert parallel.replicated_sharding(mesh)(x) is x
        mesh2 = parallel.make_2d_mesh(1)
        assert parallel.axis_size(mesh2, "model") == 1
        with pytest.raises(ValueError, match="1 devices do not split into "
                                             "model groups of 3"):
            parallel.make_2d_mesh(3)
        ms = parallel.make_multislice_mesh()
        assert ms.mesh_dim_names == ("dcn", "data")
    assert not dist.is_initialized()


def test_backend_and_device_rule(monkeypatch):
    """NCCL only when every rank of a host has a card of its own; gloo
    when ranks share one or run on the CPU. A rank's card is LOCAL_RANK
    modulo the card count."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    cuda = torch.device("cuda", 0)
    assert distributed.choose_backend(cuda, 1) == "nccl"
    assert distributed.choose_backend(cuda, 3) == "gloo"
    assert distributed.choose_backend(torch.device("cpu"), 1) == "gloo"
    assert parallel.rank_device("cpu").type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert parallel.rank_device() == torch.device("cuda", 1)
    assert parallel.rank_device("cuda:0") == torch.device("cuda", 0)
    assert os.environ["LOCAL_RANK"] == "3"
