"""The training CLI's host mirror in page-locked memory, on an NVIDIA card.

``MirrorBatches(..., pin=True)`` makes its mirrored copies in page-locked
memory, so that the step's upload is the card's own copy. These tests hold
its batches to the unpinned ones (the same rows, the same draws), check
that each batch's arrays are page-locked and its own, and that the
backbone step's upload of a pinned batch equals that of the unpinned one.
They skip without a card; run them on one with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_mirror_pin_cuda.py
"""

import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    train_backbone,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.records import (
    normalize_uint8,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: page-locked host memory exists "
                    "only with a CUDA device")
    return torch.device("cuda")


def _batches(shape, dtype, n=4):
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 256, size=shape).astype(dtype),
             rng.integers(0, 256, size=shape).astype(dtype),
             np.arange(shape[0])) for _ in range(n)]


@pytest.mark.parametrize("shape,dtype", [
    ((6, 8, 10, 1), np.uint8), ((6, 152, 152, 3), np.uint8),
    ((5, 7, 9, 3), np.float32)], ids=["gray", "rgb152", "rgb_f32"])
def test_pinned_mirror_equals_unpinned(cuda, shape, dtype):
    batches = _batches(shape, dtype)
    got = list(train_backbone.MirrorBatches(batches, True, 11, pin=True))
    want = list(train_backbone.MirrorBatches(batches, True, 11))
    assert len(got) == len(want) == 4
    seen = set()
    for g, w in zip(got, want):
        for a, b in zip(g[:2], w[:2]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
            assert a.flags.c_contiguous
            assert torch.from_numpy(a).is_pinned()
            assert not torch.from_numpy(b).is_pinned()
            # every batch kept alive keeps memory of its own
            assert a.ctypes.data not in seen
            seen.add(a.ctypes.data)
        assert np.array_equal(g[2], w[2])


def test_pinned_batch_uploads_as_the_unpinned(cuda):
    (anc, pos, lab), = _batches((8, 152, 152, 3), np.uint8, n=1)
    (a_pin, p_pin, _), = train_backbone.MirrorBatches(
        [(anc, pos, lab)], True, 5, pin=True)
    (a_ref, p_ref, _), = train_backbone.MirrorBatches(
        [(anc, pos, lab)], True, 5)
    for pinned, plain in ((a_pin, a_ref), (p_pin, p_ref)):
        got = normalize_uint8(torch.as_tensor(pinned, device=cuda))
        want = normalize_uint8(torch.from_numpy(plain)).to(cuda)
        assert torch.equal(got, want)
