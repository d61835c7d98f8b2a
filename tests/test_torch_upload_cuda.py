"""The serving pipeline's frame upload on an NVIDIA card.

Host uint8 frames cross to the card from a page-locked staging buffer that
every call of a shape reuses, and are widened to float32 there. These
tests hold that path to the host conversion (``torch.equal``) and show
that the event guarding the buffer's reuse keeps two dispatches enqueued
back to back, with no readback between them, apart: ``torch.cuda._sleep``
holds the stream first, so both copies are still pending when the host
has moved on. Threads sharing one uploader each get their own frames.
They skip without a card; run them on one with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_upload_cuda.py
"""

import sys
import threading

import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    serve_demo,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    pipeline as serve_pipeline,
)

pytestmark = pytest.mark.cuda

H, W, STREAMS = 48, 64, 4
# device cycles the stream is held for before a back-to-back pair: tens
# of milliseconds, far longer than the host takes to enqueue the pair
HOLD_CYCLES = 200_000_000


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: host uint8 frames are staged in "
                    "page-locked memory only for a CUDA device")
    return torch.device("cuda")


def _frames(seed, shape=(STREAMS, H, W, 3)):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


_SOURCES = {
    "uint8_numpy": lambda f, dev: f,
    "uint8_cpu_tensor": lambda f, dev: torch.from_numpy(f),
    "float32_numpy": lambda f, dev: f.astype(np.float32),
    "float32_device": lambda f, dev: torch.as_tensor(f, dtype=torch.float32,
                                                     device=dev),
}


@pytest.mark.parametrize("source", list(_SOURCES))
def test_uploaded_frames_equal_the_host_converted(cuda, source):
    upload = serve_pipeline._Uploader(cuda)
    for seed in (0, 1):
        frames = _SOURCES[source](_frames(seed), cuda)
        got = upload(frames)
        want = torch.as_tensor(frames, dtype=torch.float32, device=cuda)
        assert got.dtype == torch.float32 and got.device.type == "cuda"
        assert torch.equal(got, want)
    if source.startswith("uint8"):
        (host, _, _), = upload.staged.values()   # one buffer, reused
        assert host.is_pinned()
    else:
        assert not upload.staged


def test_back_to_back_uploads_keep_their_frames(cuda):
    upload = serve_pipeline._Uploader(cuda)
    f1, f2 = _frames(2), _frames(3)
    want1 = torch.as_tensor(f1, dtype=torch.float32)
    want2 = torch.as_tensor(f2, dtype=torch.float32)
    # make the buffers first: allocating them would wait for the stream
    upload(f2)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    a, b = upload(f1), upload(f2)
    f1[:] = 0                              # the caller's array is free again
    assert torch.equal(a.cpu(), want1)
    assert torch.equal(b.cpu(), want2)


def test_threads_sharing_an_uploader_get_their_own_frames(cuda):
    """More threads than cores call one uploader with frames of one
    shape, switching often: each gets its own frames back."""
    threads_n, calls = 16, 20
    upload = serve_pipeline._Uploader(cuda)
    frames = [_frames(10 + i, (8, 240, 320, 3)) for i in range(threads_n)]
    wants = [torch.as_tensor(f, dtype=torch.float32) for f in frames]
    done, wrong = [0] * threads_n, []

    def work(i):
        for _ in range(calls):
            if not torch.equal(upload(frames[i]).cpu(), wants[i]):
                wrong.append(i)
            done[i] += 1

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(threads_n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert done == [calls] * threads_n and wrong == []


@pytest.fixture(scope="module")
def pipe(cuda):
    args = serve_demo.parse_args([
        "--streams", str(STREAMS), "--frame-size", str(H), str(W),
        "--image-size", "32", "--num-classes", "10", "--identities", "50",
        "--det-thresholds", "0.3", "0.3", "0.3", "--device", "cuda"])
    gallery = np.random.default_rng(0).normal(size=(50, 342)).astype(
        np.float32)
    return serve_pipeline.make_multistream_pipeline(
        serve_demo._detector(args, cuda), serve_demo._embed_model(args, cuda),
        gallery, frame_h=H, frame_w=W, embed_size=32,
        thresholds=(0.3, 0.3, 0.3), device=cuda)


def _host(out):
    return {k: v.cpu() for k, v in out.items()}


def test_back_to_back_dispatches_equal_each_alone(pipe):
    """Two dispatches of different uint8 frames enqueued with no readback
    between them, the first caller's array overwritten after both calls,
    give what each gives alone, and what its float32 frames give."""
    f1, f2 = _frames(4), _frames(5)
    alone = [_host(pipe(f.copy())) for f in (f1, f2)]
    as_float = [_host(pipe(f.astype(np.float32))) for f in (f1, f2)]
    torch.cuda._sleep(HOLD_CYCLES)
    a, b = pipe(f1), pipe(f2)
    f1[:] = 0
    for got, want, flt in zip((_host(a), _host(b)), alone, as_float):
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), k
            assert torch.equal(got[k], flt[k]), k
    assert alone[0]["found"].any() and alone[1]["found"].any()
