"""The port's im2col filter gradient (``ops/conv_backward.py``) against the
JAX package's, and the backbone step's ``bwd_im2col`` route against its
default route, on the CPU.

- ``filter_grad_im2col`` and ``input_grad`` against JAX's on the same
  float32 inputs: rtol 1e-5 (one product summed in another order);
- ``conv2d_fg_im2col``'s gradients against the usual conv's autograd and
  JAX's ``custom_vjp`` one: rtol 1e-5;
- a LightCNN29 and an EFMNet342 train step from one state, the
  ``bwd_im2col`` route against the default: every parameter's gradient
  within 1e-4 by relative norm (``BACKBONE_GRAD_RTOL`` of chip_smoke.py),
  every conv but the stem rerouted.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.ops import (
    conv_backward as jcb,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.synthetic import (
    synthetic_faces,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.mtcnn import (
    conv_nhwc,
    conv_route,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
    conv_backward as tcb,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
    TrainState,
    backbone_optimizer,
    create_train_state,
    make_backbone_train_step,
)

GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _xw(k, cin=5, cout=7, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, 8, 6, cin)).astype(np.float32)
    w = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(
        np.float32)
    return x, w


@pytest.mark.parametrize("k,padding", [(3, "SAME"), (1, "SAME"),
                                       (3, "VALID"), (5, "SAME")])
def test_filter_grad_im2col_matches_jax(k, padding):
    x, _ = _xw(k)
    ho, wo = (8, 6) if padding == "SAME" else (8 - k + 1, 6 - k + 1)
    dy = np.random.default_rng(1).normal(size=(3, ho, wo, 7)).astype(
        np.float32)
    want = np.asarray(jcb.filter_grad_im2col(jnp.asarray(x), jnp.asarray(dy),
                                             k, padding))
    got = tcb.filter_grad_im2col(torch.from_numpy(x), torch.from_numpy(dy),
                                 k, padding).numpy()
    assert got.shape == want.shape == (k, k, 5, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_conv2d_fg_im2col_gradients(k):
    """Forward and both gradients against the usual conv's autograd and
    against JAX's custom_vjp; even kernels are refused."""
    x, w = _xw(k, seed=k)
    g = np.random.default_rng(2).normal(size=(3, 8, 6, 7)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tcb.conv2d_fg_im2col(xt, wt)
    y.backward(torch.from_numpy(g))
    xr = torch.from_numpy(x).requires_grad_()
    wr = torch.from_numpy(w).requires_grad_()
    yr = torch.nn.functional.conv2d(xr.permute(0, 3, 1, 2),
                                    wr.permute(3, 2, 0, 1),
                                    padding=k // 2).permute(0, 2, 3, 1)
    yr.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), yr.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for got, ref in ((xt.grad, xr.grad), (wt.grad, wr.grad)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-5)
    _, vjp = jax.vjp(jcb.conv2d_fg_im2col, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = (np.asarray(a) for a in vjp(jnp.asarray(g)))
    np.testing.assert_allclose(xt.grad.numpy(), jdx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tcb.input_grad(torch.from_numpy(g), torch.from_numpy(w)).numpy(),
        np.asarray(jcb.input_grad(jnp.asarray(g), jnp.asarray(w))),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="odd"):
        tcb.input_grad(torch.from_numpy(g), torch.zeros(2, 2, 5, 7))


def _grads_of_step(state, step, batch):
    """Run one train step; return each parameter's gradient as the
    optimizer receives it."""
    kept, update = [], state.apply_update

    def apply_update():
        kept[:] = [p.grad.detach().clone() for p in state.model.parameters()]
        update()

    state.apply_update = apply_update
    step(state, *batch)
    return kept


@pytest.mark.parametrize("name", ["lightcnn29", "efmnet342"])
def test_bwd_im2col_step_matches_default_route(name):
    model = model_by_name(name, 6, input_hw=(32, 32),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    spec = backbone_optimizer("sgd", base_lr=1e-5)
    state = create_train_state(model, spec, 0)
    twin_model = copy.deepcopy(model)
    twin = TrainState(model=twin_model, seed=0, spec=spec,
                      optimizer=spec.build(twin_model.parameters()))
    faces, labels = synthetic_faces(num_ids=3, per_id=4, size=32)
    batch = (faces[0::2], faces[1::2], labels[0::2])
    kw = dict(mining_mode="semi_hard", margin=2.0)
    route_seen = []
    real = tcb.Im2colBwdRoute.__call__

    def spy(self, x, conv):
        route_seen.append(conv)
        return real(self, x, conv)

    tcb.Im2colBwdRoute.__call__ = spy
    try:
        got = _grads_of_step(state, make_backbone_train_step(
            bwd_im2col=True, **kw), batch)
    finally:
        tcb.Im2colBwdRoute.__call__ = real
    want = _grads_of_step(twin, make_backbone_train_step(**kw), batch)
    stem = (model.group1.conv if name == "lightcnn29" else model.conv1.conv)
    convs = {m for m in model.modules() if isinstance(m, torch.nn.Conv2d)}
    assert set(route_seen) == convs - {stem}
    assert all(tcb.Im2colBwdRoute().reroutes(c) for c in route_seen)
    for g, w in zip(got, want):
        assert bool(w.abs().max() > 0)
        rel = float(torch.linalg.vector_norm((g - w).double())
                    / torch.linalg.vector_norm(w.double()))
        assert rel <= GRAD_RTOL


def test_im2col_route_leaves_other_convs_alone():
    """A conv the route cannot take (stride 2, even kernel) runs as it
    is."""
    route = tcb.Im2colBwdRoute()
    x = torch.randn(2, 8, 8, 3)
    for conv in (torch.nn.Conv2d(3, 4, 3, stride=2, padding=1),
                 torch.nn.Conv2d(3, 4, 2)):
        assert not route.reroutes(conv)
        with conv_route(route):
            y = conv_nhwc(x, conv)
        ref = conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        assert torch.equal(y, ref)
