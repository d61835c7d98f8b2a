"""The port's DeepFace on the paper's ladder (``deepface_cvpr14``), on the
CPU; the JAX package cannot build this ladder, so nothing here runs JAX.

The stride-2 ``LocallyConnected2D`` held to an explicit loop over its
output positions; the published ladder's sizes at 152x152 and its
parameter count, on the meta device (nothing is built at 152); the 72 px
floor; ``train_backbone`` / ``extract_features --model deepface_cvpr14``
at 72x72; a published-ladder export loaded again through
``serve/convert.py`` (the ladder and the side told from the tree); and
the LC layers' device span ``lc`` and counter ``lc.patch_bytes``,
recorded under a profiler session and absent without one.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    train,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    extract_features,
    train_backbone,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    DeepFace,
    LocallyConnected2D,
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.deepface import (
    deepface_ladder,
    deepface_side,
    deepface_sizes,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    export_model,
    from_jax_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.utils import (
    profiling,
)

NAME = "deepface_cvpr14"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("hw,k,stride", [((11, 10), 3, 2), ((9, 9), 4, 2),
                                         ((8, 7), 3, 1)])
def test_locally_connected_stride_matches_a_loop(hw, k, stride):
    gen = torch.Generator().manual_seed(0)
    layer = LocallyConnected2D(hw, 3, 5, k, stride=stride)
    with torch.no_grad():
        layer.kernel.normal_(generator=gen)
        layer.bias.normal_(generator=gen)
    x = torch.randn(2, *hw, 3, generator=gen)
    oh, ow = ((s - k) // stride + 1 for s in hw)
    assert layer.kernel.shape[:2] == (oh, ow)
    want = torch.empty(2, oh, ow, 5)
    for i in range(oh):
        for j in range(ow):
            win = x[:, i * stride:i * stride + k, j * stride:j * stride + k]
            # channel outermost, then the kernel's rows and columns
            patch = win.permute(0, 3, 1, 2).reshape(2, -1)
            want[:, i, j] = patch @ layer.kernel[i, j] + layer.bias[i, j]
    with torch.no_grad():
        got = layer(x)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_published_ladder_sizes_and_parameters():
    assert deepface_sizes((152, 152), NAME) == [
        (71, 71), (63, 63), (55, 55), (25, 25), (21, 21)]
    # the twin's ladder is as it was
    assert deepface_sizes((152, 152)) == [
        (70, 70), (62, 62), (54, 54), (48, 48), (44, 44)]
    with torch.device("meta"):
        net = DeepFace(4030, (152, 152), 3, ladder=NAME)
    assert net.model_name == NAME
    assert sum(p.numel() for p in net.parameters()) == 118_923_774
    assert net.f7.in_features == 21 * 21 * 16 == 7056
    assert tuple(net.l4.kernel.shape) == (55, 55, 1296, 16)
    assert tuple(net.l5.kernel.shape) == (25, 25, 784, 16)
    assert tuple(net.l6.kernel.shape) == (21, 21, 400, 16)
    assert net.l5.stride == 2 and net.l4.stride == net.l6.stride == 1


def test_published_ladder_floor_is_72():
    with pytest.raises(ValueError, match="72x72"):
        model_by_name(NAME, 4, input_hw=(71, 71), in_channels=3,
                      device="cpu")
    net = model_by_name(NAME, 4, input_hw=(72, 72), in_channels=3,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    assert deepface_sizes((72, 72), NAME)[-1] == (1, 1)
    with torch.no_grad():
        logits, feat = net(torch.rand(2, 72, 72, 3))
    assert logits.shape == (2, 4) and feat.shape == (2, 4096)
    with pytest.raises(ValueError, match="72x72"):
        net(torch.zeros(1, 71, 71, 3))


def test_published_export_loads_again(tmp_path):
    net = model_by_name(NAME, 7, input_hw=(80, 80), in_channels=3,
                        generator=torch.Generator().manual_seed(1),
                        device="cpu")
    tree = net.flax_params()
    assert deepface_ladder(tree) == NAME and deepface_side(tree) == 80
    export_model(str(tmp_path / "e"), net)
    x = torch.rand(3, 80, 80, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = net(x)
    for src in (str(tmp_path / "e"), tree):
        back = from_jax_params(src, device="cpu")
        assert isinstance(back, DeepFace) and back.model_name == NAME
        assert back.input_hw == (80, 80) and back.num_classes == 7
        with torch.no_grad():
            got = back(x)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    # the twin's tree is still told as the twin's, its side from L6
    twin = model_by_name("deepface", 7, input_hw=(80, 80), in_channels=3,
                         generator=torch.Generator().manual_seed(1),
                         device="cpu").flax_params()
    assert deepface_ladder(twin) == "deepface"
    assert deepface_side(twin) == 80


def test_published_clis_on_cpu(tmp_path):
    """``train_backbone --model deepface_cvpr14 --synthetic`` (3 channels
    at 72x72) trains with B1's plain version and exports;
    ``extract_features`` reads the export back at its size."""
    out = str(tmp_path / "df")
    state, history = train_backbone.main(
        ["--synthetic", "--model", NAME, "--epochs", "1", "--batch-size",
         "64", "--mining", "semi_hard_fused", "--device", "cpu",
         "--out-dir", out])
    assert isinstance(state.model, DeepFace)
    assert state.model.model_name == NAME
    assert state.model.input_hw == (72, 72) and state.model.in_channels == 3
    assert np.isfinite(history[0].train["loss"])
    res = extract_features.main(
        ["--synthetic", "--model", NAME, "--export-dir", out + "/export",
         "--out-dir", str(tmp_path / "ex"), "--batch-size", "16",
         "--device", "cpu"])
    feats = res["valid"].features
    assert feats.shape[1] == 4096 and np.isfinite(feats).all()


def _step(net):
    tx = train.backbone_optimizer("adam", base_lr=1e-4, decay_every_steps=10,
                                  factor=1.0)
    state = train.create_train_state(net, tx, 0)
    step = train.make_backbone_train_step(mining_mode="semi_hard_fused")
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(2, 2, 72, 72, 3), dtype=np.uint8)
    return lambda: step(state, images[0], images[1], np.array([0, 1]))


class _Event:
    """A stand-in timing event (the CPU has no CUDA events)."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_lc_span_and_patch_counter(monkeypatch):
    net = model_by_name(NAME, 4, input_hw=(72, 72), in_channels=3,
                        generator=torch.Generator().manual_seed(0),
                        device="cpu")
    step = _step(net)
    # off: nothing recorded, no hook left on the graph
    profiling._RECORDER.start_session()
    step()
    assert profiling.counters() == {} and profiling._RECORDER.spans == []
    # on, with stand-in CUDA events: each LC layer's forward and backward
    # give the device span ``lc``, and no host event of that name
    clock = iter(range(10_000))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(profiling._RECORDER, "event",
                        lambda device: _Event(next(clock)))
    monkeypatch.setattr(profiling._RECORDER, "start_session", lambda: (
        profiling._RECORDER.spans.clear(),
        profiling._RECORDER.counts.clear()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    spans = [s for s in profiling._RECORDER.spans if s[0] == "lc"]
    assert len(spans) == 6
    assert len(profiling.span_device_ms()["lc"]) == 6
    assert not any(ev.name == "lc" for ev in prof.events())
    # each layer builds its patch matrix in two layouts, and each gets a
    # gradient: four times [B, C*K*K, L] float32 a layer
    per_layer = [15 * 15 * 16 * 81, 5 * 5 * 16 * 49, 1 * 1 * 16 * 25]
    assert profiling.counters() == {
        "lc.patch_bytes": 4 * 4 * 4 * sum(per_layer)}
