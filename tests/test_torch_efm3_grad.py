"""The gradient of the EFM3 activation (kernel B2's backward, ``efm3_bwd``)
against the JAX package's and the plain version's, on the CPU.

The port's ``efm3`` goes through the autograd Function ``EFM3Rows`` where a
gradient is needed; on the CPU its backward is the plain version's
autograd. Its gradient equals ``jax.vjp`` of the JAX ``efm3`` and torch
autograd of ``efm3_plain`` exactly in float32 (ties split 1/4, 1/4, 1/2
and 1/2, 1/2 by both frameworks). A model of the CUDA kernel's
per-element arithmetic (``csrc/efm3.cu``: ``pick_bwd`` / ``add_bwd``, each
intermediate rounded to the element type) is held bit for bit to the plain
autograd in f32, bf16, f16 and f64, with NaN inputs, ties and -0.0
gradients. The kernel itself runs on the card (``chip_smoke.py efm3``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.ops.mfm import (
    efm3 as jefm3,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
    mfm,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    efm3 as kefm3,
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


def _input(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "ties":   # small integers: two- and three-way ties abound
        return rng.integers(-2, 3, shape).astype(np.float32)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["ties", "random"])
@pytest.mark.parametrize("shape", [(7, 9), (2, 3, 5, 12), (4, 99)])
def test_efm3_grad_equals_jax_vjp_and_plain_autograd(kind, shape):
    x = _input(kind, shape, 0)
    out_shape = shape[:-1] + (shape[-1] * 2 // 3,)
    g = np.random.default_rng(1).normal(size=out_shape).astype(np.float32)
    _, vjp = jax.vjp(jefm3, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mfm.efm3(xt)
    assert y.grad_fn is not None   # not cut from the graph
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    xp = torch.from_numpy(x).requires_grad_(True)
    mfm.efm3_plain(xp).backward(torch.from_numpy(g))
    assert torch.equal(xt.grad, xp.grad)


def test_tie_shares():
    """A three-way tie sends the max half's gradient 1/4, 1/4, 1/2 (the
    nested ``max(max(s0, s1), s2)``), a two-way tie 1/2, 1/2; the min half
    the same, and the two are added."""
    x = torch.tensor([[1.0, 1.0, 1.0], [2.0, 2.0, 0.0]], requires_grad=True)
    mfm.efm3(x).backward(torch.tensor([[1.0, 0.0], [1.0, 1.0]]))
    assert x.grad.tolist() == [[0.25, 0.25, 0.5], [0.5, 0.5, 1.0]]


def test_efm3_rows_grad_through_function_on_other_axis():
    """A channel axis that is not last moves last, runs the Function and
    moves back; the gradient is still the JAX one."""
    x = _input("ties", (3, 9, 4), 2)
    g = np.random.default_rng(3).normal(size=(3, 6, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jefm3(v, axis=1), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    mfm.efm3(xt, axis=1).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_no_grad_path_saves_nothing():
    """Without a gradient the call does not enter the Function (the
    forward-only path of inference)."""
    x = torch.randn(4, 6, requires_grad=True)
    with torch.no_grad():
        assert mfm.efm3(x).grad_fn is None
    assert kefm3.efm3_rows(torch.randn(4, 6)).grad_fn is None
    assert type(kefm3.efm3_rows(x).grad_fn).__name__ == "EFM3RowsBackward"


# ------------------------------------------- a model of the kernel's rule


def _rnd(v: torch.Tensor, dtype) -> torch.Tensor:
    return v.to(dtype)


def _val(t: torch.Tensor) -> torch.Tensor:
    return t.double() if t.dtype == torch.float64 else t.float()


def _pick_bwd(a, b, g, is_max):
    """``pick_bwd`` of csrc/efm3.cu: where(a == b, g / 2, g), zeroed for
    the operand that lost; comparisons in the compute type."""
    fa, fb = _val(a), _val(b)
    half = _rnd(_val(g) * 0.5, g.dtype)
    gh = torch.where(fa == fb, half, g)
    zero = torch.zeros_like(g)
    a_lost = fa < fb if is_max else fa > fb
    b_lost = fa > fb if is_max else fa < fb
    return torch.where(a_lost, zero, gh), torch.where(b_lost, zero, gh)


def _add_bwd(a, b):
    s = _rnd(_val(a) + _val(b), a.dtype)
    return torch.where(_val(s) == 0, torch.zeros_like(s), s)


def kernel_model(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``efm3_bwd_kernel``'s arithmetic, element by element, in torch."""
    t = x.shape[1] // 3
    a, b, e = x[:, :t], x[:, t:2 * t], x[:, 2 * t:]
    gmx, gmn = g[:, :t], g[:, t:]
    g01, ge_mx = _pick_bwd(torch.maximum(a, b), e, gmx, True)
    ga_mx, gb_mx = _pick_bwd(a, b, g01, True)
    h01, ge_mn = _pick_bwd(torch.minimum(a, b), e, gmn, False)
    ga_mn, gb_mn = _pick_bwd(a, b, h01, False)
    return torch.cat([_add_bwd(ga_mx, ga_mn), _add_bwd(gb_mx, gb_mn),
                      _add_bwd(ge_mx, ge_mn)], dim=1)


def _bits(t: torch.Tensor) -> torch.Tensor:
    view = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.bfloat16: torch.int16, torch.float16: torch.int16}
    return t.contiguous().view(view[t.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64])
def test_kernel_rule_is_bit_equal_to_plain_autograd(dtype):
    """Ties (small integers), NaN inputs, +-inf, -0.0 and tiny gradients
    (f16 subnormals, where a halving rounds): the kernel's rule and the
    plain version's autograd agree bit for bit, sign of zero included."""
    rng = np.random.default_rng(4)
    rows, t = 256, 33
    x = rng.integers(-2, 3, (rows, 3 * t)).astype(np.float64)
    x[rng.random(x.shape) < 0.03] = np.nan
    x[rng.random(x.shape) < 0.02] = np.inf
    x[rng.random(x.shape) < 0.02] = -np.inf
    g = rng.normal(size=(rows, 2 * t))
    g[rng.random(g.shape) < 0.1] = -0.0
    g[rng.random(g.shape) < 0.1] = 0.0
    g[rng.random(g.shape) < 0.1] *= 2.0 ** -23   # f16 subnormals
    xt = torch.from_numpy(x).to(dtype)
    gt = torch.from_numpy(g).to(dtype)
    want = kefm3.efm3_rows_bwd_plain(xt, gt)
    got = kernel_model(xt, gt)
    assert torch.equal(_bits(got), _bits(want))
    # and the wrapper's CPU route is that plain version
    assert torch.equal(_bits(kefm3.efm3_rows_bwd(xt, gt)), _bits(want))
