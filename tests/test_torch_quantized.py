"""The port's int8 inference (``ops/quantized.py``) against the JAX
package's, on the CPU.

Weights are made from seeds with numpy in the flax layouts and carried
into the port. Tolerances:

- the host-side LightCNN9 weight quantization: int8 weights, scales and
  passed-through float32 tensors bit-equal (after HWIO -> OIHW);
- an int8 conv's int32 sums: equal to JAX's ``conv_general_dilated(...,
  preferred_element_type=int32)`` on identical int8 operands;
- the dynamic activation quantization: int8 values and scales equal;
- one rerouted conv (the generic route against JAX's interceptor, float32
  and bfloat16, one scale for the batch or one a frame): bit-equal, the
  dequantization's multiply-add rounded once as XLA fuses it;
- embeddings (hard-coded LightCNN9 ladder, generic route of LightCNN9,
  LightCNN29 and EFMNet342, the extraction CLI): cosine >= 0.9995 to
  JAX's int8 forward on the same whole batch, and >= 0.999 to the float32
  forward (JAX's contract). The int8 forward is not continuous: the float
  convs before an int8 one (the stems, LightCNN9's conv2a) sum in another
  order on each side, an activation within an ulp of a rounding boundary
  then rounds to the other int8, and the difference grows through the
  ladder. One ulp added to the input moves JAX's own EFMNet342 bf16
  embeddings by 1.8e-4 in cosine and the port's LightCNN29 f32 ones by
  2.0e-4, so 1e-4 is below the reference's own noise, and 5e-4 is the
  bound held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu import (
    utils as jutils,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.cli import (
    extract_features as jcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.data import (
    records as jrecords,
    synthetic as jsynthetic,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.extract import (
    extract_features as j_extract_features,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    LightCNN9 as JLightCNN9,
    LightCNN29 as JLightCNN29,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops import (
    quantized as jq,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve.export import (
    export_params,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    extract_features as tcli,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
    extract_features,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.lightcnn import (
    build_lightcnn9,
    lightcnn9_front_route,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
    quantized as tq,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    from_jax_params,
)

from _torch_weights import flax_params

SIDE = 32
MODELS = {"lightcnn9": JLightCNN9, "lightcnn29": JLightCNN29,
          "efmnet342": JEFMNet342}
COS_JAX, COS_F32 = 0.9995, 0.999


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _variables(name, seed=0):
    model = MODELS[name](num_classes=6)
    variables = {"params": flax_params(model, SIDE, seed)}
    if name == "lightcnn29":
        rng = np.random.default_rng(seed + 1)
        variables["batch_stats"] = {"fc1_bn": {
            "mean": (rng.normal(size=684) * 0.1).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 684).astype(np.float32)}}
    return model, variables


@pytest.fixture(scope="module")
def nets():
    out = {}
    for name in MODELS:
        model, variables = _variables(name)
        out[name] = (model, variables, from_jax_params(
            variables, input_hw=(SIDE, SIDE), device="cpu"))
    return out


def _images(n=4, seed=3):
    return np.random.default_rng(seed).random(
        (n, SIDE, SIDE, 1)).astype(np.float32)


def _cos(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def _f32_embeddings(model, variables, x):
    _, feat = model.apply(variables, jnp.asarray(x), train=False)
    return np.asarray(feat)


def test_lightcnn9_weight_quantization_bit_equal(nets):
    _, variables, _ = nets["lightcnn9"]
    want = jq.quantize_lightcnn9_params(variables["params"])
    got = tq.quantize_lightcnn9_params(variables["params"], device="cpu")
    assert set(got) == set(want)
    for name, layer in want.items():
        for key, arr in layer.items():
            arr = np.asarray(arr)
            g = got[name][key].numpy()
            if key == "w8":
                assert g.dtype == np.int8
                g = g.transpose(2, 3, 1, 0)          # OIHW -> HWIO
            assert g.dtype == arr.dtype and g.shape == arr.shape, (name, key)
            assert g.tobytes() == arr.tobytes(), (name, key)


@pytest.mark.parametrize("k,padding,stride", [
    (3, "SAME", 1), (1, "SAME", 1), (3, "VALID", 1), (2, "VALID", 1),
    (3, "VALID", 2)])
def test_int8_conv_sums_equal_jax(k, padding, stride):
    """int32 sums on identical int8 operands, including extreme values
    (every product +-127^2)."""
    rng = np.random.default_rng(k * 10 + stride)
    x8 = rng.integers(-127, 128, (2, 9, 7, 19), dtype=np.int8)
    w8 = rng.integers(-127, 128, (k, k, 19, 12), dtype=np.int8)
    x8[0, :3] = 127
    w8[..., 0] = -127
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(w8), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    pad = (k // 2, k // 2) if padding == "SAME" else (0, 0)
    got = tq.int8_conv_nhwc(torch.from_numpy(x8),
                            torch.from_numpy(w8.transpose(3, 2, 0, 1).copy()),
                            (stride, stride), pad).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_activation_quantization_equals_jax():
    """One scale for the tensor, and (the JAX pipelines' ``vmap``) one a
    frame: int8 values and scales equal to the jitted JAX quantizer's."""
    x = np.random.default_rng(0).normal(size=(6, 5, 4, 3)).astype(np.float32)
    x[2] *= 10.0
    jfn = jax.jit(jq._quantize_activations)
    want_q, want_s = (np.asarray(a) for a in jfn(jnp.asarray(x)))
    got_q, got_s = tq.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    assert got_s.numpy().tobytes() == want_s.reshape(1).tobytes()
    vq, vs = (np.asarray(a) for a in jax.jit(jax.vmap(
        jq._quantize_activations))(jnp.asarray(x.reshape(3, 2, 5, 4, 3))))
    got_q, got_s = tq.quantize_activations(torch.from_numpy(x), groups=3)
    np.testing.assert_array_equal(got_q.numpy(), vq.reshape(x.shape))
    assert got_s.numpy().tobytes() == vs.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,cin,cout", [(3, 66, 198), (1, 99, 64)])
def test_rerouted_conv_bit_equal_to_jax(k, cin, cout, dtype):
    """One eligible conv under the generic route, its float32 weights and
    input identical on both sides, computing in ``dtype`` (the flax conv's
    ``dtype``, the route's ``compute_dtype``): the output equals JAX's
    interceptor's bit for bit, with one activation scale for the batch
    (the extraction) and one a frame (``groups``; JAX's pipelines ``vmap``
    over frames)."""
    import flax.linen as fnn

    rng = np.random.default_rng(k + cin)
    x = rng.normal(size=(4, 6, 5, cin)).astype(np.float32)
    x[1] *= 4.0
    kernel = (rng.normal(size=(k, k, cin, cout))
              / np.sqrt(k * k * cin)).astype(np.float32)
    kernel[..., 0] = 0.0                         # a zero scale maps to 1
    bias = (rng.normal(size=cout) * 0.1).astype(np.float32)
    jconv = fnn.Conv(cout, (k, k), padding="SAME", dtype=getattr(jnp, dtype))
    params = {"params": {"kernel": kernel, "bias": bias}}

    def run(p, x):
        with fnn.intercept_methods(jq.int8_conv_interceptor()):
            return jconv.apply(p, x)

    conv = torch.nn.Conv2d(cin, cout, k, padding=k // 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(bias))
    out_dtype = getattr(torch, dtype)
    for groups in (1, 2):
        want = jax.jit(run if groups == 1 else jax.vmap(run, (None, 0)))(
            params, jnp.asarray(x if groups == 1 else x.reshape(
                2, 2, *x.shape[1:])))
        want = np.asarray(want.astype(jnp.float32)).reshape(4, 6, 5, cout)
        route = tq.Int8ConvRoute(compute_dtype=out_dtype, groups=groups)
        with torch.no_grad():
            got = route(torch.from_numpy(x), conv)
        assert route.rerouted == {conv} and got.dtype == out_dtype
        assert got.float().numpy().tobytes() == want.tobytes(), groups


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hardcoded_lightcnn9_ladder_matches_jax(nets, dtype):
    model, variables, _ = nets["lightcnn9"]
    x = _images()
    want = np.asarray(jq.make_int8_lightcnn9_extract(
        jq.quantize_lightcnn9_params(variables["params"]),
        compute_dtype=getattr(jnp, dtype))(jnp.asarray(x)))
    got = tq.make_int8_lightcnn9_extract(
        tq.quantize_lightcnn9_params(variables["params"], device="cpu"),
        compute_dtype=getattr(torch, dtype))(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    assert _cos(got, want).min() >= COS_JAX
    assert _cos(got, _f32_embeddings(model, variables, x)).min() >= COS_F32


@pytest.mark.parametrize("name", list(MODELS))
def test_generic_int8_matches_jax(nets, name):
    """``make_int8_extract`` (float32; LightCNN9 also bfloat16) against the
    JAX generic forward, and the route sees every conv of the net but the
    stem, rerouting exactly those with ``kh*kw*cin >= 64``."""
    model, variables, net = nets[name]
    x = _images()
    dtypes = ("float32", "bfloat16") if name == "lightcnn9" else ("float32",)
    for dtype in dtypes:
        want = np.asarray(jq.make_int8_extract(
            model, variables, compute_dtype=getattr(jnp, dtype))(
                jnp.asarray(x)))
        got = tq.make_int8_extract(net, compute_dtype=getattr(torch, dtype))(
            torch.from_numpy(x)).numpy()
        assert _cos(got, want).min() >= COS_JAX, dtype
        assert _cos(got, _f32_embeddings(model, variables, x)).min() \
            >= COS_F32, dtype
    with torch.no_grad(), tq.int8_conv_interceptor() as route:
        net(torch.from_numpy(x))
    stem = net.group1.conv if name == "lightcnn29" else net.conv1.conv
    convs = {m for m in net.modules() if isinstance(m, torch.nn.Conv2d)}
    assert route.rerouted | route.passed == convs - {stem}
    assert not route.rerouted & route.passed
    assert route.rerouted == {c for c in convs if c.kernel_size[0]
                              * c.kernel_size[1] * c.in_channels >= 64}


def test_int8_lightcnn9_front_never_takes_front9():
    """Under the int8 route conv2 (K = 432) is quantized, so on the card
    LightCNN9's front takes B4 (conv1..conv2a) for every even size, B6
    never; with conv2a rerouted too (``min_k`` <= 48) the plain layers."""
    net = build_lightcnn9(4, device="cpu")

    def route_of(hw, conv_rt):
        rerouted = [n for n in ("conv2a", "conv2")
                    if conv_rt.reroutes(getattr(net, n))]
        return lightcnn9_front_route(*hw, cuda=True, inference=True,
                                     rerouted=rerouted)

    assert lightcnn9_front_route(128, 128, cuda=True, inference=True) \
        == "front9"
    for hw in ((128, 128), (112, 96), (64, 64)):
        assert route_of(hw, tq.Int8ConvRoute()) == "stem2"
        assert route_of(hw, tq.Int8ConvRoute(min_k=48)) == "plain"


def test_extract_features_int8_whole_batches_match_jax(nets):
    """``extract_features(int8=True)``: one activation scale a batch on both
    sides, padded last batch included."""
    model, variables, net = nets["lightcnn9"]
    x = _images(6, seed=4)
    want, _, _ = j_extract_features(model, variables, x, batch_size=4,
                                    int8=True)
    got, _, _, _ = extract_features(net, x, batch_size=4, int8=True)
    assert got.shape == want.shape == (6, 256)
    assert _cos(got, want).min() >= COS_JAX
    f32, _, _, _ = extract_features(net, x, batch_size=4)
    assert _cos(got, f32).min() >= COS_F32


def test_extract_features_cli_int8_matches_jax(nets, tmp_path, monkeypatch):
    model, variables, _ = nets["lightcnn29"]
    export = str(tmp_path / "export")
    export_params(export, variables["params"], model_name="lightcnn29",
                  feature_dim=684, input_hw=(SIDE, SIDE), input_channels=1,
                  batch_stats=variables["batch_stats"])
    imgs, labels = jsynthetic.synthetic_faces(num_ids=3, per_id=4, size=SIDE)
    store = str(tmp_path / "faces.npz")
    jrecords.save_image_store(store, imgs, labels)
    argv = ["--valid-images", store, "--export-dir", export,
            "--batch-size", "8", "--int8"]
    # the JAX CLI's persistent compile cache would be process-wide state
    monkeypatch.setattr(jutils, "enable_compilation_cache", lambda *a: None)
    want = jcli.main(argv + ["--out-dir", str(tmp_path / "jax")])
    got = tcli.main(argv + ["--out-dir", str(tmp_path / "port"),
                            "--device", "cpu"])
    assert got["valid"].features.shape == want["valid"][0].shape == (12, 684)
    assert _cos(got["valid"].features, want["valid"][0]).min() >= COS_JAX
