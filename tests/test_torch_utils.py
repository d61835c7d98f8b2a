"""The port's utilities against the JAX package's, on the CPU: the
embedding-projector TSVs (byte-equal), ``compiled_flops`` (2*M*N*K for a
matmul in both: FLOPs counted by ``FlopCounterMode`` here, XLA's cost
analysis there), ``trace`` (a Chrome trace file) and
``enable_compilation_cache`` (a no-op)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.eval import (
    projector as jproj,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.utils import (
    profiling as jprof,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    utils as tutils,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    train_head as ttrain_head,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.eval import (
    projector as tproj,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.utils import (
    profiling as tprof,
)


@pytest.mark.parametrize("names", [None, ["a", "b", "c", "d", "e"]])
def test_projector_tsvs_byte_equal(tmp_path, names):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(5, 7)).astype(np.float32)
    labels = np.arange(5) % 2
    jd = jproj.export_projector(emb, labels, str(tmp_path / "j"), names)
    td = tproj.export_projector(emb, labels, str(tmp_path / "t"), names)
    files = sorted(os.listdir(jd))
    assert files == sorted(os.listdir(td)) and files
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    e, lab = tproj.load_projector(jd)
    je, jlab = jproj.load_projector(td)
    np.testing.assert_array_equal(e, je)
    assert list(map(str, lab)) == list(map(str, jlab))


@pytest.mark.parametrize("m,k,n", [(16, 32, 8), (64, 128, 96)])
def test_compiled_flops_of_a_matmul(m, k, n):
    a = np.ones((m, k), np.float32)
    b = np.ones((k, n), np.float32)
    want = jprof.compiled_flops(lambda x, y: x @ y, jnp.asarray(a),
                                jnp.asarray(b))
    got = tprof.compiled_flops(lambda x, y: x @ y, torch.from_numpy(a),
                               torch.from_numpy(b))
    assert got == want == 2 * m * n * k
    assert tutils.compiled_flops is tprof.compiled_flops
    assert tprof.compiled_flops(lambda x: x + 1, torch.ones(3)) is None
    assert tprof.compiled_flops(lambda: 1 / 0) is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_enable_compilation_cache_is_a_noop(tmp_path):
    before = {k: v for k, v in os.environ.items()}
    assert tutils.enable_compilation_cache() is None
    assert tutils.enable_compilation_cache(str(tmp_path / "c")) is None
    assert not (tmp_path / "c").exists() and dict(os.environ) == before


def test_train_head_export_projector_matches_jax_layout(tmp_path):
    """``train_head --export-projector`` writes the features' TSVs and the
    trained head's, as the JAX CLI does."""
    state, _ = ttrain_head.main([
        "--synthetic", "--epochs", "1", "--batch-size", "256",
        "--export-projector", "--device", "cpu", "--out-dir",
        str(tmp_path)])
    for d in ("projector_before", "projector_after"):
        emb, labels = tproj.load_projector(str(tmp_path / d))
        assert emb.shape[0] == len(labels) > 0
    after, _ = tproj.load_projector(str(tmp_path / "projector_after"))
    before, _ = tproj.load_projector(str(tmp_path / "projector_before"))
    assert after.shape[1] == 128 and before.shape[1] == 342
    with torch.no_grad():
        want = state.model(torch.from_numpy(before[:4])).numpy()
    np.testing.assert_allclose(after[:4], want, rtol=1e-5, atol=1e-6)
