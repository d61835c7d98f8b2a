"""Port models against the JAX package's, on the CPU, with carried weights.

Weights and inputs are numpy arrays made from a seed (in the JAX layouts,
with the JAX package's init distributions); the flax / JAX nets run them
as they are and the port loads them through its converters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    mtcnn as jmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models.lightcnn import (
    EFMResBlock as JEFMResBlock,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    export as jexport,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    mtcnn as tmtcnn,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.lightcnn import (
    EFMResBlock,
    load_kernel_,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
    export_model,
    from_jax_params,
)

from _torch_weights import flax_params, mtcnn_params


@pytest.mark.parametrize("name,shape", [("pnet", (2, 20, 26, 3)),
                                        ("rnet", (3, 24, 24, 3)),
                                        ("onet", (3, 48, 48, 3))])
def test_mtcnn_nets_match_jax(name, shape):
    spec = {"pnet": jmtcnn._PNET_SPEC, "rnet": jmtcnn._RNET_SPEC,
            "onet": jmtcnn._ONET_SPEC}[name]
    fwd = {"pnet": jmtcnn.pnet_forward, "rnet": jmtcnn.rnet_forward,
           "onet": jmtcnn.onet_forward}[name]
    params = mtcnn_params(spec, seed=len(name) + shape[0])
    x = np.random.default_rng(1).uniform(-1, 1, shape).astype(np.float32)
    want = jax.jit(fwd)(jmtcnn.load_npy_params(params), jnp.asarray(x))
    net = from_jax_params(params, device="cpu")
    assert isinstance(net, {"pnet": tmtcnn.PNet, "rnet": tmtcnn.RNet,
                            "onet": tmtcnn.ONet}[name])
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    back = net.params()
    for layer, entries in params.items():
        for k, v in entries.items():
            np.testing.assert_array_equal(back[layer][k], v)


@pytest.fixture(scope="module")
def efm_pair():
    model = JEFMNet342(num_classes=4)
    params = flax_params(model, 32, seed=0)
    apply = jax.jit(lambda p, x: model.apply({"params": p}, x, train=False))
    x = np.random.default_rng(2).uniform(0, 1, (3, 32, 32, 1)).astype(
        np.float32)
    return model, params, apply, x, [np.asarray(a) for a in apply(params, x)]


def _port_outputs(net, x):
    with torch.no_grad():
        return [t.numpy() for t in net(torch.from_numpy(x))]


def test_efmnet342_matches_flax(efm_pair):
    """Both outputs at rtol/atol 1e-4: a deep f32 conv stack summed in
    another order on each side."""
    _, params, _, x, want = efm_pair
    net = from_jax_params(params, device="cpu")
    assert net.image_size == 32 and net.num_classes == 4
    got = _port_outputs(net, x)
    assert got[1].shape == (3, 342)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_jax_export_loads_in_port_and_back(efm_pair, tmp_path):
    """JAX export_params -> the port's loader gives the same features; the
    port's export -> the JAX loader gives them again."""
    _, params, apply, x, want = efm_pair
    jexport.export_params(str(tmp_path / "jax"), params,
                          model_name="efmnet342", feature_dim=342,
                          input_hw=(32, 32))
    net = from_jax_params(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_allclose(_port_outputs(net, x)[1], want[1], rtol=1e-4,
                               atol=1e-4)
    export_model(str(tmp_path / "port"), net)
    back, _, manifest = jexport.load_exported_params(str(tmp_path / "port"))
    assert manifest["model"] == "efmnet342"
    assert manifest["input"]["height"] == 32
    np.testing.assert_array_equal(np.asarray(apply(back, x)[1]), want[1])


def test_efm_res_block_shared_weights_match_flax():
    """The gluon original's weight reuse (``share_weights=True``)."""
    block = JEFMResBlock(num_blocks=3, filters=9, share_weights=True)
    x = np.random.default_rng(4).normal(size=(2, 5, 5, 6)).astype(np.float32)
    shapes = jax.eval_shape(block.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    assert set(shapes) == {"conv_a", "conv_b"}
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(
        lambda s: (rng.normal(size=s.shape) * 0.3).astype(np.float32), shapes)
    want = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    port = EFMResBlock(3, 9, share_weights=True)
    assert [n for n, _ in port.flax_names()] == ["conv_a", "conv_b"]
    for name, conv in port.flax_names():
        load_kernel_(conv, params[name])
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
