"""The ``train-deepface-p64`` cell at a tiny size on the CPU: the plain
DeepFace reference against the program (forward, and one training
step's loss and gradients), the model FLOPs against FlopCounterMode over
the reference, the LC layers' least time, the near-tie rule, the
cell's readers, and whole runs: sound, correct; with the timed path
broken (half of each batch, an altered loss, a stale step, a step whose
update is undone), not."""

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core import cell
from perfbench.core.driver import port
from perfbench.core.trace import Trace
from perfbench.counts import deepface as counts
from perfbench.counts.kernels import F32_OPS_PER_S, MEM_BYTES_PER_S
from perfbench.reference import deepface, train, train_deepface, weights
from perfbench.traffic.train_deepface_steps import rgb_face_store

NAME = "train-deepface-p64"
SEED = 2 ** 31 + 11


def tiny():
    """The cell's configuration and traffic at 80x80, 40 classes, 4
    pairs a step over 12 images."""
    bench = cell.manifest()
    _, traffic, cfg = cell.cell_files(NAME, bench)
    cfg["input_hw"] = [80, 80]
    cfg["num_classes"] = 40
    traffic.update(pairs=4, identities=6, images_per_identity=2)
    return cfg, traffic


def _store(cfg, seed):
    return rgb_face_store(seed, 6, 2, tuple(cfg["input_hw"]),
                          cfg["num_classes"], "cpu")


def _program(cfg, p):
    net = port("models").model_by_name(
        cfg["model"], cfg["num_classes"], input_hw=tuple(cfg["input_hw"]),
        in_channels=3, device="cpu")
    weights.load_into(net, p)
    return net


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_reference_matches_the_program():
    cfg, _ = tiny()
    p = weights.make(deepface.specs(cfg), 3, "cpu", gain=cfg["init_gain"])
    net = _program(cfg, p)
    images, _ = _store(cfg, 4)
    x = torch.as_tensor(images[:3]).float() / 255.0
    with torch.no_grad():
        logits, feat = net(x)
        want = deepface.embed(p, x)
        torch.testing.assert_close(feat, want, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(logits, deepface.logits(p, want),
                                   rtol=1e-5, atol=1e-5)
    assert deepface.sizes(cfg["input_hw"])[-1] == (3, 3)


def test_training_step_matches_the_program():
    """One step of the program's backbone step (Adam, dropout from the
    step's generator, B1's plain version) against the reference's: the
    loss, and each parameter's gradient as Adam took it."""
    cfg, t = tiny()
    rec = {**cfg["train"], "pairs": t["pairs"]}
    p = weights.make(deepface.specs(cfg), 5, "cpu", gain=cfg["init_gain"])
    images, labels = _store(cfg, 6)
    tr = port("train")
    state = tr.create_train_state(_program(cfg, p), tr.backbone_optimizer(
        "adam", base_lr=rec["lr"], decay_every_steps=100, factor=1.0,
        weight_decay=rec["weight_decay"]), 7)
    step = tr.make_backbone_train_step(margin=rec["margin"],
                                       alpha=rec["alpha"],
                                       mining_mode=rec["mining"])
    (anc, pos, lab), = train.batches(labels, images, t["pairs"], 7, 1)
    state, metrics = step(state, anc, pos, lab)
    losses, first, _, _, ties = train_deepface.run(p, images, labels, 7,
                                                   rec, 1, "cpu")
    assert ties == [0.0]
    assert float(metrics["loss"]) == pytest.approx(losses[0], rel=1e-6)
    opt = state.optimizer
    for k, param in state.model.named_parameters():
        got = opt.state[param]["exp_avg"] / 0.1
        torch.testing.assert_close(got, first[k], rtol=1e-4, atol=1e-7,
                                   msg=k)


def test_flops_forward_and_training():
    cfg, _ = tiny()
    p = weights.make(deepface.specs(cfg), 1, "cpu")
    x = torch.rand(4, 80, 80, 3)
    assert _flops(lambda: deepface.logits(p, deepface.embed(p, x))) == \
        counts.forward(4, cfg)
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}

    def step():
        deepface.logits(leaves, deepface.embed(leaves, x)).sum().backward()
    assert _flops(step) == counts.train(4, cfg)


def test_published_counts():
    """At the cell's shapes: 132.51 GFLOP forward, 337.57 a step (three
    forwards less C1's input gradient), the LC layers' least time 0.84
    ms, every product bound by its operations."""
    _, _, cfg = cell.cell_files(NAME, cell.manifest())
    assert counts.forward(128, cfg) == 132_511_858_688
    assert counts.train(128, cfg) == 3 * 132_511_858_688 - 59_961_606_144
    layers = counts.ladder(cfg)["lc"]
    assert layers == [(63, 63, 16, 55, 55, 9, 16),
                      (55, 55, 16, 25, 25, 7, 16),
                      (25, 25, 16, 21, 21, 5, 16)]
    ops = [2 * 128 * oh * ow * c * k * k * f
           for _, _, c, oh, ow, k, f in layers]
    assert sum(ops) == 18_787_532_800
    # L4's forward moves its 251 MB kernel and 57 MB of maps: 0.09 ms at
    # 3.35 TB/s, under its 0.24 ms of operations at 67 TFLOP/s
    h, w, c, oh, ow, k, f = layers[0]
    nbytes = 4 * (128 * h * w * c + oh * ow * (c * k * k + 1) * f
                  + 128 * oh * ow * f)
    assert nbytes / MEM_BYTES_PER_S < ops[0] / F32_OPS_PER_S
    assert counts.lc_least_s(128, cfg) == pytest.approx(
        3 * sum(ops) / F32_OPS_PER_S, rel=1e-12)
    assert counts.lc_least_s(128, cfg) == pytest.approx(8.412e-4, rel=1e-3)


def test_tie_gap():
    # pool of 4; anchor 0 (label 0): candidates 1 and 3 are negatives
    d = torch.tensor([[0.0, 0.50, 0.1, 0.5000004]], dtype=torch.float64)
    neg = torch.tensor([[False, True, False, True]])
    own = torch.tensor([1])
    pos_sq = torch.tensor([0.2], dtype=torch.float64)
    gap = train_deepface.tie_gap
    assert float(gap(d, pos_sq, neg, own, torch.tensor([1]))) == 0.0
    # the other semi-hard candidate, 4e-7 farther: a near-tie
    assert float(gap(d, pos_sq, neg, own, torch.tensor([3]))) == \
        pytest.approx(4e-7, abs=1e-8)
    # not a negative
    assert float(gap(d, pos_sq, neg, own, torch.tensor([2]))) == float("inf")
    # no semi-hard candidate: the farthest negative, or one near the
    # positive's distance
    far = torch.tensor([0.55], dtype=torch.float64)
    assert float(gap(d, far, neg, torch.tensor([3]), torch.tensor([1]))) == \
        pytest.approx(4e-7, abs=1e-8)


class _Driver:
    def __init__(self, least=None):
        if least is not None:
            self.lc_least_s = lambda: least

    def batches_per_step(self):
        return 1


def _run(driver):
    t = Trace(device=[("k", 0.0, 10.0)], host=[], wall_s=1e-5, steps=2)
    return SimpleNamespace(trace=t, window={"steps": 1, "seconds": 1.0},
                           launches={}, driver=driver)


def test_lc_readers(monkeypatch):
    profiling = port("utils.profiling")
    # two steps: six LC spans of 0.5 ms each a step, 1.2e9 patch bytes
    monkeypatch.setattr(profiling, "span_device_ms",
                        lambda: {"train.forward": [9.0, 9.0],
                                 "lc": [0.5] * 12})
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"lc.patch_bytes": 2_400_000_000})
    run = _run(_Driver(least=0.6e-3))
    assert cell.metric_reader("lc_ms.train")(run) == pytest.approx(3.0)
    assert cell.metric_reader("lc_roofline.train")(run) == \
        pytest.approx(20.0)
    assert cell.metric_reader("lc_patch_mb.train")(run) == \
        pytest.approx(1200.0)
    # a program that records no such span or counter: nothing to read
    monkeypatch.setattr(profiling, "span_device_ms",
                        lambda: {"train.forward": [9.0]})
    monkeypatch.setattr(profiling, "counters", lambda: {})
    for name in ("lc_ms.train", "lc_roofline.train", "lc_patch_mb.train"):
        assert cell.metric_reader(name)(run) is None


@pytest.mark.parametrize("fault", [None, "half", "alter", "stale",
                                   "unchanged"])
def test_run_is_correct_only_when_sound(fault):
    cfg, traffic = tiny()
    out = cell.run_cell(NAME, traffic, cfg, seed=SEED, seconds=0.2,
                        trace=False, device="cpu",
                        t_start=time.perf_counter(), bench=cell.manifest(),
                        fault=fault)
    assert out["correct"] is (fault is None), out["checks"]
    assert list(out)[-1] == "checks" and "tie_gap" in out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {"setup_s", "train_images_per_s"} <= set(out["metrics"])


_SETUP = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from perfbench.core import cell
from perfbench.tests.test_perfbench_deepface import tiny
cfg, traffic = tiny()
drv = cell.driver(traffic["kind"])(cfg, traffic, 3, "cpu")
drv.setup()
drv.step()
print(json.dumps(cell.loaded_forbidden(sys.modules)))
"""


def test_driver_loads_no_jax():
    res = subprocess.run(
        [sys.executable, "-c", _SETUP.format(root=cell.ROOT)],
        capture_output=True, text=True, timeout=600, check=True)
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


@pytest.mark.gpu
@pytest.mark.parametrize("fault", [None, "control"])
def test_control_fails_on_the_card(cuda, fault):
    cfg, traffic = tiny()
    drv = cell.driver(traffic["kind"])(cfg, traffic, SEED, "cuda",
                                       fault=fault)
    drv.setup()
    for _ in range(drv.check_steps()):
        drv.step()
    drv.close()
    checks = drv.check()
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    assert ok is (fault is None), checks
    assert np.isfinite(checks["loss_gap"]["value"])
