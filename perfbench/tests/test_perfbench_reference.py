"""The plain reference against the program's plain CPU path at tiny sizes,
and the model FLOP counts against FlopCounterMode over the reference."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core.driver import port
from perfbench.core.synthetic import face_store, frames
from perfbench.counts import models
from perfbench.reference import efmnet342, lightcnn29, mtcnn, weights
from perfbench.tests import tiny


def _flops(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_efmnet342_matches_the_program():
    cfg = tiny.serve()[0]["embed"]
    p = weights.make(efmnet342.specs(cfg), 3, "cpu")
    net = port("models").model_by_name("efmnet342", cfg["num_classes"],
                                       input_hw=(32, 32), device="cpu")
    weights.load_into(net, p)
    x = torch.rand(3, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        torch.testing.assert_close(efmnet342.embed(p, x), net.embed(x),
                                   rtol=1e-5, atol=1e-5)


def test_lightcnn29_matches_the_program():
    cfg = tiny.lightcnn29()
    p = weights.make(lightcnn29.specs(cfg), 4, "cpu", gain=cfg["init_gain"])
    net = port("models").model_by_name("lightcnn29", cfg["num_classes"],
                                       input_hw=(32, 32), device="cpu")
    weights.load_into(net, p)
    images, _ = face_store(5, 4, 1, (32, 32), cfg["num_classes"], "cpu")
    x = torch.as_tensor(images).float() / 255.0
    with torch.no_grad():
        logits, feat = net(x)
        raw = lightcnn29.embed(p, x)
        torch.testing.assert_close(lightcnn29.logits(p, raw), logits,
                                   rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lightcnn29.batch_norm(p, raw, False),
                                   feat, rtol=1e-5, atol=1e-5)


def test_cascade_matches_the_program():
    cfg, t = tiny.serve()
    p = weights.make(mtcnn.specs(cfg), 6, "cpu")
    det = port("detect.pipeline").MTCNNDetector(device="cpu")
    for net in ("pnet", "rnet", "onet"):
        weights.load_into(getattr(det, net), p, net + ".")
    h, w = cfg["frame_hw"]
    c = cfg["cascade"]
    cascade = port("detect.device_cascade").make_device_cascade(
        det.pnet, det.rnet, det.onet, h, w, minsize=c["minsize"],
        factor=c["factor"], thresholds=tuple(c["thresholds"]), device="cpu")
    fr = frames(7, 3, h, w, "cpu").float()
    with torch.no_grad():
        got = cascade(fr)[0]
        want = mtcnn.cascade(p, fr, c)
    assert torch.equal(torch.isfinite(got[..., 4]), torch.isfinite(want[..., 4]))
    ok = torch.isfinite(want[..., 4])
    torch.testing.assert_close(got[ok], want[ok], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("net,shape,count", [
    ("pnet", (2, 30, 40, 3), lambda: models.pnet(2, 30, 40)),
    ("rnet", (5, 24, 24, 3), lambda: models.rnet(5)),
    ("onet", (3, 48, 48, 3), lambda: models.onet(3))])
def test_cascade_net_flops(net, shape, count):
    p = weights.make(mtcnn.specs(tiny.serve()[0]), 1, "cpu")
    x = torch.rand(shape)
    assert _flops(lambda: mtcnn._net(p, net, x)) == count()


def test_efmnet342_flops():
    cfg = tiny.serve()[0]["embed"]
    p = weights.make(efmnet342.specs(cfg), 1, "cpu")
    x = torch.rand(2, 32, 32, 1)
    want = models.efmnet342(2, 32, cfg["stem_filters"], cfg["fc1"])
    assert _flops(lambda: efmnet342.embed(p, x)) == want


def test_lightcnn29_flops_forward_and_training():
    cfg = tiny.lightcnn29()
    p = weights.make(lightcnn29.specs(cfg), 1, "cpu")
    x = torch.rand(4, 32, 32, 1)
    want = models.lightcnn29(4, (32, 32), cfg["num_classes"])
    assert _flops(lambda: lightcnn29.logits(p, lightcnn29.embed(p, x))) == want

    leaves = {k: v.clone().requires_grad_("running" not in k)
              for k, v in p.items()}

    def step():
        raw = lightcnn29.embed(leaves, x)
        out = (lightcnn29.logits(leaves, raw).sum()
               + lightcnn29.batch_norm(leaves, raw, True).sum())
        out.backward()
    assert _flops(step) == models.lightcnn29_train(4, (32, 32),
                                                   cfg["num_classes"])
