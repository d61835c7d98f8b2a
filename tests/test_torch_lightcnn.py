"""LightCNN9 / LightCNN29 and kernels B6 / B4 of the port against the JAX
package, on the CPU.

The same seeded numpy inputs and weights go through the JAX function (the
Pallas kernels in interpret mode) and the port's, which on CPU tensors runs
each kernel's plain PyTorch version. f32 outputs agree to 1e-5 for the
kernels and 1e-4 for the deep nets (sums in another order); bf16 kernel
outputs to 2e-2 (one bf16 rounding of a stage output may land the other
way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    LightCNN9 as JLightCNN9,
    LightCNN29 as JLightCNN29,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.mfm import (
    mfm2 as jmfm2,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.pallas.front_kernel import (
    front9_chain_pallas,
    front9_reference,
    pack_front9_weights as jpack_front9,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.pallas.stem_kernel import (
    stem2_conv_pallas,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.s2d_stem import (
    reference_stem as jreference_stem,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    LightCNN9,
    LightCNN29,
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.lightcnn import (
    lightcnn9_front_route,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    front9 as tfront9,
    stem as tstem,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)

from _torch_weights import flax_params

T = torch.from_numpy


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _front9_params(seed=0, c1=96, c2a=96, c2=192):
    """tests/test_pallas_kernels.py::_front9_params, as numpy."""
    rng = np.random.default_rng(seed)

    def t(shape, s):
        return rng.normal(size=shape).astype(np.float32) * s

    return {
        "conv1": {"kernel": t((5, 5, 1, c1), 0.1), "bias": t((c1,), 0.1)},
        "conv2a": {"kernel": t((1, 1, c1 // 2, c2a), 0.1),
                   "bias": t((c2a,), 0.1)},
        "conv2": {"kernel": t((3, 3, c2a // 2, c2), 0.05),
                  "bias": t((c2,), 0.1)},
    }


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# ------------------------------------------------------------- B6 front9


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_front9_plain_matches_pallas_and_reference(dtype):
    """(a) front9_plain and the wrapper on CPU tensors against the Pallas
    kernel (interpret) and front9_reference, LightCNN9 widths at 2x32x32."""
    params = _front9_params()
    x = np.random.default_rng(3).normal(size=(2, 32, 32, 1)).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    tol = 1e-5 if dtype == "f32" else 2e-2
    jx = jnp.asarray(x, jd)
    want = [np.asarray(front9_chain_pallas(
        jx, jpack_front9(params, dtype=jd), interpret=True), np.float32)]
    if dtype == "f32":
        want.append(np.asarray(front9_reference(jx, params)))
    tparams = _tree(T, params)
    tx = T(x).to(td)
    got = [_np(tfront9.front9_plain(tx, tparams)),
           _np(tfront9.front9_chain(tx, tparams))]
    assert got[0].shape == (2, 8, 8, 96)
    np.testing.assert_array_equal(got[0], got[1])
    for g in got[:1]:
        for w in want:
            np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def test_pack_front9_weights_layout():
    """The kernel's layout holds every weight where csrc/front9.cu reads it:
    w2[chunk, (di*3 + dj)*C2a/2 + cin, pair, half] = conv2[di, dj, cin,
    chunk*16 + pair + half*C2/2]; w2a[k, j, half] = conv2a[k, j + half*
    C2a/2]; taps rounded to the packing dtype."""
    params = _tree(T, _front9_params(seed=1, c1=8, c2a=24, c2=64))
    packed = tfront9.pack_front9_weights(params, torch.float32)
    w2, k2 = packed["w2"], params["conv2"]["kernel"]
    assert tuple(w2.shape) == (2, 9 * 12, 16, 2)
    c, row, p, h = np.meshgrid(*[np.arange(n) for n in w2.shape],
                               indexing="ij")
    di, dj, ci = row // 36, (row // 12) % 3, row % 12
    np.testing.assert_array_equal(
        w2.numpy(), k2.numpy()[di, dj, ci, c * 16 + p + h * 32])
    w2a, k2a = packed["w2a"], params["conv2a"]["kernel"][0, 0]
    assert tuple(w2a.shape) == (4, 12, 2)
    np.testing.assert_array_equal(w2a[:, :, 0], k2a[:, :12])
    np.testing.assert_array_equal(w2a[:, :, 1], k2a[:, 12:])
    np.testing.assert_array_equal(packed["w1"],
                                  params["conv1"]["kernel"].reshape(25, 8))
    # bf16 goes to the tensor-core kernel: its layout, taps rounded to bf16
    # (tests/test_torch_front9_tc.py unpacks all of it)
    bf = tfront9.pack_front9_weights(params, torch.bfloat16)
    assert bf["w1"].dtype == torch.bfloat16 and tuple(bf["w1"].shape) == (
        2, 1, 32, 8)
    np.testing.assert_array_equal(
        bf["w1"][0, 0, 0, 0].float(),
        params["conv1"]["kernel"][0, 0, 0, 0].to(torch.bfloat16).float())
    with pytest.raises(ValueError, match="divisible"):
        tfront9.pack_front9_weights(_tree(T, _front9_params(c2=40)),
                                    torch.float32)


def test_front9_refuses_what_the_tpu_kernel_refuses():
    params = _tree(T, _front9_params(c1=8, c2a=8, c2=32))
    for shape in ((1, 32, 28, 1), (1, 30, 30, 1), (1, 32, 32, 3)):
        with pytest.raises(ValueError):
            tfront9.front9_chain(torch.zeros(shape), params)


# -------------------------------------------------------------- B4 stem2


@pytest.mark.parametrize("shape,c,c2", [((2, 16, 16, 1), 8, 12),
                                        ((2, 28, 24, 1), 8, 16),
                                        ((1, 112, 96, 1), 96, 96)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stem2_conv_plain_matches_pallas(shape, c, c2, dtype):
    """(b) stem2_conv_plain and the wrapper on CPU tensors against
    stem2_conv_pallas (interpret) and the unfused JAX prefix of
    tests/test_s2d_stem.py (f32), at its shapes, a 112x96-like rectangle
    and LightCNN9's 112x96 at full width."""
    rng = np.random.default_rng(sum(shape) + c)
    x = rng.random(shape).astype(np.float32)
    w = (rng.normal(size=(5, 5, 1, c)) * 0.3).astype(np.float32)
    b = rng.normal(size=(c,)).astype(np.float32)
    w2 = (rng.normal(size=(1, 1, c // 2, c2)) * 0.3).astype(np.float32)
    b2 = rng.normal(size=(c2,)).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    tol = 1e-5 if dtype == "f32" else 2e-2
    jx, jw, jb, jw2, jb2 = (jnp.asarray(a, jd) for a in (x, w, b, w2, b2))
    want = [np.asarray(stem2_conv_pallas(jx, jw, jb, jw2, jb2,
                                         interpret=True), np.float32)]
    if dtype == "f32":
        stem = jreference_stem(jx, jw, jb)
        want.append(np.asarray(jmfm2(jax.lax.conv_general_dilated(
            stem, jw2, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC")) + jb2)))
    args = [T(a).to(td) for a in (x, w, b, w2, b2)]
    got = _np(tstem.stem2_conv_plain(*args))
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, c2 // 2)
    np.testing.assert_array_equal(got, _np(tstem.stem2_conv(*args)))
    for wnt in want:
        scale = max(1.0, float(np.abs(wnt).max()))
        np.testing.assert_allclose(got, wnt, rtol=tol, atol=tol * scale)


# ------------------------------------------------- (c) the nets vs flax


def _bn_stats(model, x, seed):
    """Random running statistics for every BatchNorm of ``model``."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["batch_stats"]
    rng = np.random.default_rng(seed)
    return {"fc1_bn": {
        "mean": rng.normal(size=shapes["fc1_bn"]["mean"].shape).astype(
            np.float32) * 0.1,
        "var": rng.uniform(0.5, 2.0, shapes["fc1_bn"]["var"].shape).astype(
            np.float32)}}


def _flax_params(model, shape, seed):
    """_torch_weights.flax_params for a non-square or RGB input, BatchNorm
    scale and bias drawn too."""
    x = jnp.zeros((1,) + shape[1:], jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]
    rng = np.random.default_rng(seed)

    def fill(s):
        if len(s.shape) == 1:
            return (rng.normal(size=s.shape) * 0.01).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(size=s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map(fill, shapes)


NETS = {
    "lightcnn9_16": (JLightCNN9, {}, (2, 16, 16, 1)),
    "lightcnn9_rect_rgb": (JLightCNN9, {}, (2, 16, 32, 3)),
    "lightcnn29_32": (JLightCNN29, {}, (2, 32, 32, 1)),
    "lightcnn29_rgb": (JLightCNN29, {}, (2, 32, 32, 3)),
    "lightcnn29_gluon_shared": (JLightCNN29, {"gluon_shared_res": True},
                                (2, 32, 32, 1)),
}


@pytest.mark.parametrize("case", list(NETS))
def test_lightcnn_matches_flax(case):
    """(c) logits and features of the flax net and the port with the same
    params (and random BatchNorm statistics for LightCNN29, so its eval
    BatchNorm is exercised), at rtol/atol 1e-4: a deep f32 conv stack
    summed in another order on each side."""
    cls, kw, shape = NETS[case]
    model = cls(num_classes=5, **kw)
    params = _flax_params(model, shape, seed=len(case))
    x = np.random.default_rng(7).random(shape).astype(np.float32)
    variables = {"params": params}
    if cls is JLightCNN29:
        variables["batch_stats"] = _bn_stats(model, x[:1], seed=3)
    want = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, x)
    net = from_jax_params(variables, device="cpu", input_hw=shape[1:3])
    assert isinstance(net, LightCNN9 if cls is JLightCNN9 else LightCNN29)
    assert net.in_channels == shape[3] and net.num_classes == 5
    if cls is JLightCNN29:
        assert net.share_weights == bool(kw)
    with torch.no_grad():
        got = net(T(x))
    assert got[1].shape == (2, net.feature_dim)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
    # the flax tree comes back unchanged, BatchNorm statistics included
    back = jax.tree_util.tree_map(np.asarray, params)
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           net.flax_params(), back)
    if cls is JLightCNN29:
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               net.flax_batch_stats(),
                               variables["batch_stats"])


def test_lightcnn9_bf16_stays_near_f32():
    """The bf16 bound chip_smoke.py holds the card's --bf16 extraction to:
    the JAX package's own bf16 LightCNN9 stays within it of its f32
    embeddings on the CPU (min cosine 0.99995 at 32-128 px), and so does
    the port's."""
    from chip_smoke import BF16_COS_MIN

    model, model16 = JLightCNN9(num_classes=10), JLightCNN9(
        num_classes=10, dtype=jnp.bfloat16)
    params = flax_params(model, 32, seed=0)
    x = np.random.default_rng(1).random((4, 32, 32, 1)).astype(np.float32)

    def cos(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(
            b, axis=1)

    j32, j16 = (jax.jit(lambda p, x, m=m: m.apply({"params": p}, x)[1])(
        params, x) for m in (model, model16))
    assert cos(j32, j16).min() >= BF16_COS_MIN
    t32 = from_jax_params(params, device="cpu")
    t16 = from_jax_params(params, device="cpu", dtype=torch.bfloat16)
    with torch.no_grad():
        f32, f16 = t32(T(x))[1], t16(T(x))[1]
    assert f16.dtype == torch.float32
    assert cos(f32, f16).min() >= BF16_COS_MIN


# ----------------------------------------------------- (d) front routing


@pytest.mark.parametrize("hw,route", [((128, 128), "front9"),
                                      ((112, 96), "stem2"),
                                      ((68, 68), "front9"),
                                      ((30, 30), "stem2"),
                                      ((31, 31), "plain")])
def test_lightcnn9_front_route(hw, route):
    """(d) B6 where front9_chain_pallas takes the input (H == W, H % 4 ==
    0), else B4 where stem2_conv_pallas takes it (H, W even), else the
    plain layers; the CPU, training, autograd and RGB input are plain."""
    assert lightcnn9_front_route(*hw, cuda=True, inference=True) == route
    assert lightcnn9_front_route(*hw, cuda=False, inference=True) == "plain"
    assert lightcnn9_front_route(*hw, cuda=True, inference=False) == "plain"
    assert lightcnn9_front_route(*hw, 3, cuda=True, inference=True) == "plain"


def test_lightcnn9_front_paths_agree_on_cpu():
    """The three routes compute one function: the model's plain front, B4's
    plain version + conv2, and B6's plain version, on one input."""
    net = model_by_name("lightcnn9", 3, input_hw=(32, 32), device="cpu",
                        generator=torch.Generator().manual_seed(4))
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        plain = net._front(x)
        p = net.front_params()
        via_b6 = tfront9.front9_plain(x, p)
        via_b4 = tstem.stem2_conv_plain(
            x, p["conv1"]["kernel"], p["conv1"]["bias"],
            p["conv2a"]["kernel"], p["conv2a"]["bias"])
        via_b4 = torch.nn.functional.max_pool2d(
            torch.maximum(*torch.chunk(
                net.conv2(via_b4.permute(0, 3, 1, 2)), 2, 1)), 2, 2)
    np.testing.assert_allclose(via_b6.numpy(), plain.numpy(), atol=1e-5)
    np.testing.assert_allclose(via_b4.permute(0, 2, 3, 1).numpy(),
                               plain.numpy(), atol=1e-5)


def test_model_by_name_refuses_deepface():
    with pytest.raises(SystemExit, match="A, item 12"):
        model_by_name("deepface", 4, device="cpu")
