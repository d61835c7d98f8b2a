"""The port's BEGAN-CS (``models/began_cs.py``, ``losses/began.py``,
``train/gan.py``, ``cli/train_began.py``) against the JAX package's, on
the CPU.

The loss pieces on seeded arrays (float32 rounding: 1e-6 relative); the
Decoder, Encoder, Generator and autoencoder-discriminator at size 16 with
``n = 8`` from flax's init, held to flax's ``apply`` at 1e-5 relative; one
BEGAN-CS step from the same weights with the same ``z`` (JAX's draw, fed
to the port's step) and ``semi_hard`` mining: both losses and every
metric at 1e-5 relative, and each player's per-leaf gradient by relative
norm at 1e-4 (triplet margin 2, so the triplet term is live; the JAX
optimizers are chained behind a transform that keeps the raw gradient);
``k_t`` following ``k_update`` over steps; and the ``train_began`` CLI end
to end.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.losses import (
    began as jbegan,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models.began_cs import (
    AutoencoderDiscriminator as JAE,
    Decoder as JDecoder,
    Encoder as JEncoder,
    Generator as JGenerator,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.train.gan import (
    create_gan_state as jcreate_gan_state,
    make_began_cs_train_step as jmake_step,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    train_began,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.losses import (
    began,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    AutoencoderDiscriminator,
    Decoder,
    Encoder,
    Generator,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
    OptimizerSpec,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train.gan import (
    GAN_METRIC_KEYS,
    create_gan_state,
    make_began_cs_train_step,
)

SIZE, N, H_DIM, B = 16, 8, 6, 4
LR = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, np.asarray(tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


_rng = np.random.default_rng(0)
_A = _rng.normal(size=(3, 5, 5, 2)).astype(np.float32)
_B = _rng.normal(size=(3, 5, 5, 2)).astype(np.float32)
LOSS_CASES = {
    "recon_l1": lambda m, t: m.recon_l1(t(_A), t(_B)),
    "cs_constraint": lambda m, t: m.cs_constraint(t(_A[:, 0, 0]),
                                                   t(_B[:, 0, 0])),
    "k_update": lambda m, t: m.k_update(t(np.float32(0.3)),
                                        t(np.float32(0.8)),
                                        t(np.float32(0.1)), 0.5, 0.2),
    "k_update_clipped": lambda m, t: m.k_update(t(np.float32(0.99)),
                                                t(np.float32(5.0)),
                                                t(np.float32(0.1)), 0.5, 1.0),
    "convergence_measure": lambda m, t: m.convergence_measure(
        t(np.float32(0.8)), t(np.float32(0.7)), 0.5),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_loss_piece_matches_jax(name):
    want = float(LOSS_CASES[name](jbegan, jnp.asarray))
    got = float(LOSS_CASES[name](began,
                                 lambda a: torch.from_numpy(np.asarray(a))))
    assert _rel(got, want) <= 1e-6


def _apply_pair(kind):
    """(flax module, its variables, the port module, input)."""
    rng = np.random.default_rng(1)
    z = rng.uniform(-1, 1, (3, H_DIM)).astype(np.float32)
    img = rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    jm, port, x = {
        "decoder": (JDecoder(size=SIZE, channels=3, n=N),
                    Decoder(SIZE, 3, N, H_DIM), z),
        "generator": (JGenerator(size=SIZE, channels=3, n=N, h_dim=H_DIM),
                      Generator(SIZE, 3, N, H_DIM), z),
        "encoder": (JEncoder(h_dim=H_DIM, n=N), Encoder(SIZE, 3, N, H_DIM),
                    img),
        "autoencoder": (JAE(size=SIZE, channels=3, n=N, h_dim=H_DIM),
                        AutoencoderDiscriminator(SIZE, 3, N, H_DIM), img),
    }[kind]
    v = jm.init(jax.random.PRNGKey(2), x)
    port.load_flax_params(_np(v["params"]))
    return jm, v, port, x


@pytest.mark.parametrize("kind", ["decoder", "generator", "encoder",
                                  "autoencoder"])
def test_model_matches_flax(kind):
    jm, v, port, x = _apply_pair(kind)
    want = jm.apply(v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel(g.numpy(), w) <= 1e-5
    for path, w in _leaves(_np(v["params"])):
        assert np.array_equal(_get(port.flax_params(), path), w), path
    if kind == "autoencoder":
        with torch.no_grad():
            enc = port.encode(torch.from_numpy(x)).numpy()
        assert np.array_equal(enc, got[1].numpy())


def _recording(tx):
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    anc = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    pos = np.clip(anc + rng.normal(0, 0.1, anc.shape), -1, 1).astype(
        np.float32)
    return anc, pos, np.arange(B) % 2


def _port_state(jstate, lr=LR):
    gen = Generator(SIZE, 3, N, H_DIM).load_flax_params(
        _np(jstate.gen_params))
    disc = AutoencoderDiscriminator(SIZE, 3, N, H_DIM).load_flax_params(
        _np(jstate.disc_params))
    sgd = OptimizerSpec(lr=lr, weight_decay=0.0)
    return create_gan_state(gen, disc, sgd, sgd, 0)


def _check_grads(model, want_grads):
    """Each parameter's ``.grad`` against JAX's raw gradient tree, by
    relative norm."""
    twin = type(model)(SIZE, 3, N, H_DIM)
    with torch.no_grad():
        for p, q in zip(model.parameters(), twin.parameters()):
            assert p.grad is not None
            q.copy_(p.grad)
    got = twin.flax_params()
    for path, want in _leaves(_np(want_grads)):
        g = _get(got, path).astype(np.float64)
        assert np.linalg.norm(want) > 0 and np.linalg.norm(g) > 0, path
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel <= 1e-4, (path, rel)


def test_began_step_matches_jax():
    """One step from the same weights and ``z``: the JAX step's
    ``value_and_grad`` of both players against the port's."""
    anc, pos, labels = _batch()
    g, d = (JGenerator(size=SIZE, channels=3, n=N, h_dim=H_DIM),
            JAE(size=SIZE, channels=3, n=N, h_dim=H_DIM))
    gtx, dtx = _recording(optax.sgd(LR)), _recording(optax.sgd(LR))
    jstate = jcreate_gan_state(g, d, gtx, dtx, jax.random.PRNGKey(0),
                               jnp.asarray(anc), H_DIM)
    tstate = _port_state(jstate)
    jstep = jax.jit(jmake_step(g, d, gtx, dtx, h_dim=H_DIM,
                               mining_mode="semi_hard", triplet_margin=2.0))
    tstep = make_began_cs_train_step(h_dim=H_DIM, mining_mode="semi_hard",
                                     triplet_margin=2.0)
    # the JAX step's z (fold_in(base_key, step), split, uniform [-1, 1))
    key = jax.random.fold_in(jstate.base_key, jstate.step)
    k_z, _ = jax.random.split(key)
    z = np.asarray(jax.random.uniform(k_z, (2 * B, H_DIM), jnp.float32,
                                      -1.0, 1.0))
    jstate, jm = jstep(jstate, anc, pos, labels)
    tstate, tm = tstep(tstate, anc, pos, labels, z=z)
    assert set(tm) == set(GAN_METRIC_KEYS)
    for k in GAN_METRIC_KEYS:
        if k in ("pos_cos", "neg_cos"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       atol=1e-5, err_msg=k)
        else:
            assert _rel(float(tm[k]), float(jm[k])) <= 1e-5, k
    assert float(jm["loss_triplet"]) > 0     # the triplet term is live
    _check_grads(tstate.discriminator, jstate.disc_opt[0])
    _check_grads(tstate.generator, jstate.gen_opt[0])
    assert tstate.step == int(jstate.step) == 1


def test_k_t_moves_with_the_balance():
    """Over steps, ``k_t`` follows ``k_update`` of each step's own losses,
    and moves off 0 while gamma L(x) exceeds L(G(z))."""
    anc, pos, labels = _batch(4)
    gen = Generator(SIZE, 3, N, H_DIM).init_weights(
        torch.Generator().manual_seed(0))
    disc = AutoencoderDiscriminator(SIZE, 3, N, H_DIM).init_weights(
        torch.Generator().manual_seed(1))
    adam = OptimizerSpec(lr=1e-3, weight_decay=0.0, family="adam", b1=0.5)
    state = create_gan_state(gen, disc, adam, adam, 0)
    step = make_began_cs_train_step(h_dim=H_DIM, lambda_k=0.05,
                                    mining_mode="random")
    ks = [0.0]
    for _ in range(4):
        state, m = step(state, anc, pos, labels)
        want = float(began.k_update(torch.tensor(ks[-1]), m["loss_real"],
                                    m["loss_fake"], 0.5, 0.05))
        assert float(m["k_t"]) == pytest.approx(want, abs=1e-7)
        ks.append(float(state.k_t))
    assert ks[-1] > 0.0 and len(set(ks)) > 2


def test_train_began_cli_end_to_end(tmp_path):
    out = str(tmp_path / "began")
    state, convergence = train_began.main([
        "--synthetic", "--synthetic-size", "32", "--epochs", "2",
        "--batch-size", "8", "--h-dim", "16", "--filters", "8",
        "--mining", "semi_hard_fused", "--sample-every", "1",
        "--device", "cpu", "--out-dir", out])
    assert len(convergence) == 2 and np.isfinite(convergence).all()
    assert state.step == 2 * (256 // 8)
    assert os.path.exists(os.path.join(out, "samples_0001.jpg"))
    for name in ("export_gen", "export_disc"):
        assert os.path.exists(os.path.join(out, name, "manifest.json"))
    # --data-parallel run plainly is a group of one: each step folds data
    # rank 0 into its generator, so z and the picks differ from the
    # plain run's; it trains and writes the same files
    dp = str(tmp_path / "dp")
    state, conv_dp = train_began.main([
        "--synthetic", "--synthetic-size", "32", "--epochs", "1",
        "--batch-size", "64", "--h-dim", "16", "--filters", "8",
        "--mining", "semi_hard_fused", "--data-parallel", "--device", "cpu",
        "--out-dir", dp])
    assert state.step == 256 // 64 and np.isfinite(conv_dp).all()
    for name in ("export_gen", "export_disc"):
        assert os.path.exists(os.path.join(dp, name, "manifest.json"))
