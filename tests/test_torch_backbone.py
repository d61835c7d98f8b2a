"""The port's backbone train and eval steps against the JAX package's, on
the CPU.

The same flax init (carried into the port with ``model_by_name(params=,
batch_stats=)``) and the same numpy batches of synthetic faces go through
the jitted JAX step and the port's, three steps each, with dropout off on
both sides (a ``flax.linen.intercept_methods`` interceptor that makes
``nn.Dropout`` the identity; ``p = 0`` in the port). Models at the sizes
of ``tests/test_train_steps.py``: EFMNet342 and LightCNN29 at 32x32,
LightCNN9 at 16x16, 5 identities, 8 pairs a step, the ``sgd`` family on
the factor schedule (halving every 2 steps) at 1e-5. The JAX optimizer is
chained behind a transform that keeps the step's raw gradient in its
state, so each train step's per-leaf gradients are held to the port's
``.grad`` (an update of lr x |grad| is too small to check through the
weights). The train steps use a triplet margin of 2: at the default 0.2
LightCNN29's hinge is inactive on these batches, and the triplet term is
the only path into its ``fc1_bn``.

Tolerances. The first step's forward agrees to ~1e-6. The gradients of an
EFM net route through max/min and pools, so a value that sits within
float32 rounding of a tie can route the other way in the two frameworks
(XLA's and PyTorch's convolutions sum in other orders); such a flip moves
one element's gradient by its size, so after an update the weights agree
to lr x |grad| (~1e-6 here) and the later steps' losses to ~1e-4
relative. LightCNN29's training BatchNorm divides by the batch's small
spread of features, which magnifies the cosines' differences to ~1e-4.

Gradients, by each leaf's relative norm ||g_port - g_jax|| / ||g_jax||
over the three steps (measured): LightCNN9 ~1e-6; LightCNN29 2e-3 (its
``fc1_bn``); EFMNet342 5e-2, as three values of stage 4's EFM lie within
the port's float32 rounding of a tie and route the other way (JAX's
gradient agrees with a float64 run of the port to 6e-7). A missing
gradient reads 1 and a gradient of the wrong sign 2.
"""

import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu import (
    train as jtrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.models import (
    EFMNet342 as JEFMNet342,
    LightCNN9 as JLightCNN9,
    LightCNN29 as JLightCNN29,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    train as ttrain,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    PairBatcher,
    synthetic_faces,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
    model_by_name,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.lightcnn import (
    Dropout,
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


NC, B, LR = 5, 8, 1e-5
MODELS = {"efmnet342": (JEFMNet342, 32), "lightcnn9": (JLightCNN9, 16),
          "lightcnn29": (JLightCNN29, 32)}
MODES = ["semi_hard", "hard", "semi_hard_fused"]
# per-step metrics: losses rtol, cosines atol, acc atol (one row of 2B)
LOSS_RTOL, COS_ATOL, ACC_ATOL = 1e-3, 5e-4, 1.0 / (2 * B) + 1e-6
PARAM_ATOL, BN_RTOL = 2e-5, 1e-3
# per-leaf relative norm of a step's gradient (see the module's note)
GRAD_RTOL = {"efmnet342": 1e-1, "lightcnn9": 1e-4, "lightcnn29": 1e-2}
MARGIN = 2.0


def _no_dropout(next_fun, args, kwargs, context):
    if isinstance(context.module, fnn.Dropout):
        return args[0]
    return next_fun(*args, **kwargs)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _recording(tx):
    """``tx`` behind a transform whose state is the last raw gradient."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


@functools.cache
def _net(name):
    """A model's JAX init and three batches of faces at its size."""
    cls, size = MODELS[name]
    faces, labels = synthetic_faces(num_ids=NC, per_id=6, size=size, seed=0)
    batches = list(PairBatcher(faces, labels, B, seed=0))[:3]
    model = cls(num_classes=NC)
    tx = _recording(jtrain.backbone_optimizer("sgd", base_lr=LR,
                                              decay_every_steps=2,
                                              factor=0.5))
    # create_train_state with the init jitted (an eager flax init of these
    # nets takes seconds)
    init_rng, base_key = jax.random.split(jax.random.PRNGKey(0))
    variables = jax.jit(model.init)(init_rng, jnp.asarray(faces[:1]))
    state = jtrain.TrainState(
        params=variables["params"], opt_state=tx.init(variables["params"]),
        batch_stats=variables.get("batch_stats", {}),
        step=jnp.zeros((), jnp.int32), base_key=base_key)
    return name, size, model, tx, state, batches


@pytest.fixture(scope="module", params=list(MODELS))
def net(request):
    return _net(request.param)


def _port_state(name, size, state, *, center=False):
    module = model_by_name(name, NC, input_hw=(size, size),
                           params=_np(state.params),
                           batch_stats=_np(state.batch_stats) or None,
                           device="cpu")
    for m in module.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    tx = ttrain.backbone_optimizer("sgd", base_lr=LR, decay_every_steps=2,
                                   factor=0.5)
    aux = torch.zeros(NC, module.feature_dim) if center else None
    return ttrain.create_train_state(module, tx, 0, aux=aux)


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


def _check_metrics(tm, jm):
    for k in ("loss", "id_loss", "tl_loss"):
        np.testing.assert_allclose(tm[k].numpy(), jm[k], rtol=LOSS_RTOL,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(tm["acc"].numpy(), jm["acc"], atol=ACC_ATOL)
    for k in ("pos_cos", "neg_cos"):
        assert tm[k].shape == (B,)
        np.testing.assert_allclose(tm[k].numpy(), jm[k], atol=COS_ATOL,
                                   err_msg=k)


def _check_params(tstate, jstate):
    got = tstate.model.flax_params()
    for path, want in _leaves(_np(jstate.params)):
        np.testing.assert_allclose(_get(got, path), want, rtol=0,
                                   atol=PARAM_ATOL, err_msg=str(path))
    if jstate.batch_stats:
        # the statistics average features of magnitude ~10, so an entry
        # near 0 carries their rounding: atol scales with the largest
        stats = tstate.model.flax_batch_stats()
        for path, want in _leaves(_np(jstate.batch_stats)):
            np.testing.assert_allclose(_get(stats, path), want,
                                       rtol=BN_RTOL,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=str(path))


def _check_grads(name, model, want_grads):
    """Every parameter of the port got a nonzero gradient this step, and
    each leaf's is within ``GRAD_RTOL`` of JAX's by relative norm."""
    twin = copy.deepcopy(model)   # the gradients in the weights' places
    with torch.no_grad():
        for p, q in zip(model.parameters(), twin.parameters()):
            assert p.grad is not None
            q.copy_(p.grad)
    got = twin.flax_params()
    for path, want in _leaves(want_grads):
        g, want = _get(got, path).astype(np.float64), want.astype(np.float64)
        assert np.linalg.norm(want) > 0 and np.linalg.norm(g) > 0, path
        rel = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel <= GRAD_RTOL[name], (path, rel)


def _run_jax(step, state, batches):
    """Per step: the metrics and the raw gradient (``_recording``)."""
    out = []
    for a, p, l in batches:
        with fnn.intercept_methods(_no_dropout):
            state, m = step(state, a, p, l)
        out.append((_np(m), _np(state.opt_state[0])))
    return state, out


@pytest.mark.parametrize("mode", MODES)
def test_backbone_train_step_matches_jax(net, mode):
    """Three train steps: every metric and every leaf's gradient step for
    step, then the weights and (LightCNN29) the BatchNorm running
    statistics, which move with the biased batch variance at flax's
    momentum 0.9."""
    name, size, model, tx, jstate, batches = net
    jstep = jax.jit(jtrain.make_backbone_train_step(
        model, tx, mining_mode=mode, margin=MARGIN))
    tstate = _port_state(name, size, jstate)
    tstep = ttrain.make_backbone_train_step(mining_mode=mode, margin=MARGIN)
    jstate, jout = _run_jax(jstep, jstate, batches)
    for (a, p, l), (jm, jg) in zip(batches, jout):
        tstate, tm = tstep(tstate, a, p, l)
        assert set(tm) == set(ttrain.BACKBONE_METRIC_KEYS)
        _check_metrics(tm, jm)
        _check_grads(name, tstate.model, jg)
    assert tstate.step == int(jstate.step) == 3
    _check_params(tstate, jstate)
    if name == "lightcnn29":   # the statistics did move
        assert not np.allclose(tstate.model.fc1_bn.running_var.numpy(), 1.0)


@pytest.mark.parametrize("mode", MODES)
def test_backbone_eval_step_matches_jax(net, mode):
    name, size, model, _, jstate, batches = net
    jstep = jax.jit(jtrain.make_backbone_eval_step(model, mining_mode=mode))
    tstate = _port_state(name, size, jstate)
    tstep = ttrain.make_backbone_eval_step(mining_mode=mode)
    for a, p, l in batches[:2]:
        jm = _np(jstep(jstate, a, p, l))
        _check_metrics(tstep(tstate, a, p, l), jm)
    assert tstate.step == 0


def test_backbone_center_loss_matches_jax():
    """``center_weight > 0``: the loss includes the center term, and the
    centers table the state keeps matches the JAX ``aux`` (``index_add``:
    duplicate labels accumulate)."""
    name, size, model, tx, jstate, batches = _net("efmnet342")
    jstate = jstate.replace(aux=jnp.zeros((NC, model.feature_dim)))
    jstep = jax.jit(jtrain.make_backbone_train_step(
        model, tx, mining_mode="semi_hard", center_weight=0.5,
        center_alfa=0.9))
    tstate = _port_state(name, size, jstate, center=True)
    tstep = ttrain.make_backbone_train_step(
        mining_mode="semi_hard", center_weight=0.5, center_alfa=0.9)
    jstate, jout = _run_jax(jstep, jstate, batches)
    for (a, p, l), (jm, jg) in zip(batches, jout):
        tstate, tm = tstep(tstate, a, p, l)
        _check_metrics(tm, jm)
        _check_grads(name, tstate.model, jg)
    # the table sums (1 - alfa) x the features of three steps, which agree
    # to ~1e-4 relative (see the module's note)
    want = np.asarray(jstate.aux)
    np.testing.assert_allclose(tstate.aux.numpy(), want, rtol=0,
                               atol=5e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0
    _check_params(tstate, jstate)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_policy_is_exact(policy):
    """Recomputing the net's layers in the backward changes nothing: the
    metrics, weights and BatchNorm statistics equal those of no remat bit
    for bit (the recomputation redraws no dropout and moves no statistics:
    both run after ``embed``). LightCNN29: its BatchNorm must move once."""
    name, size, _, _, jstate, batches = _net("lightcnn29")
    runs = []
    for remat in (None, policy):
        tstate = _port_state(name, size, jstate)
        for m in tstate.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.5   # dropout on: the remat must not redraw it
        step = ttrain.make_backbone_train_step(mining_mode="semi_hard",
                                               remat_policy=remat)
        ms = [step(tstate, a, p, l)[1] for a, p, l in batches[:2]]
        runs.append((tstate, ms))
    (s0, m0), (s1, m1) = runs
    for a, b in zip(m0, m1):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for (k, v), w in zip(s0.model.state_dict().items(),
                         s1.model.state_dict().values()):
        assert torch.equal(v, w), k


def test_scanned_step_equals_single_steps():
    """A chunk of K=2 stacked batches equals two single steps: the same
    metrics (stacked ``[K]`` / ``[K, B]``) and the same weights."""
    name, size, _, _, jstate, batches = _net("lightcnn9")
    step = ttrain.make_backbone_train_step(mining_mode="random")
    single = _port_state(name, size, jstate)
    ms = [step(single, a, p, l)[1] for a, p, l in batches[:2]]
    chunked = _port_state(name, size, jstate)
    stacked = tuple(np.stack(x) for x in zip(*batches[:2]))
    chunked, sm = ttrain.make_scanned_step(step)(chunked, *stacked)
    assert chunked.step == single.step == 2
    assert sm["loss"].shape == (2,) and sm["pos_cos"].shape == (2, B)
    for i, m in enumerate(ms):
        for k in m:
            assert torch.equal(sm[k][i], m[k]), k
    for v, w in zip(single.model.parameters(), chunked.model.parameters()):
        assert torch.equal(v, w)


def test_train_loop_scan_chunk_drops_the_partial_chunk():
    """Five batches an epoch at ``scan_chunk=2``: two chunks, four steps,
    the fifth batch dropped (the JAX loop's drop-last), both epochs."""
    name, size, _, _, jstate, batches = _net("lightcnn9")
    five = (batches * 2)[:5]
    jsteps = []
    jax_loop_state, jhist = jtrain.train_loop(
        jstate, lambda s, a, p, l: (jsteps.append(1) or s, {
            "loss": jnp.zeros(2), "pos_cos": jnp.zeros((2, B)),
            "neg_cos": jnp.zeros((2, B))}),
        lambda: iter(five), epochs=2, scan_chunk=2)
    tstate = _port_state(name, size, jstate)
    step = ttrain.make_scanned_step(
        ttrain.make_backbone_train_step(mining_mode="semi_hard"))
    tstate, hist = ttrain.train_loop(tstate, step, lambda: iter(five),
                                     epochs=2, scan_chunk=2)
    assert len(jsteps) == 4   # JAX: two chunk calls an epoch
    assert tstate.step == 8 and [len(h.steps) for h in hist] == [4, 4]
    assert all(np.isfinite(s["loss"]) for h in hist for s in h.steps)


def test_unported_options_name_their_item():
    """(Named when data and class parallelism refused.) A step built with
    an axis runs inside its ``shard_map_*`` wrapper, which binds the
    mesh, and raises outside it; center loss does not combine with class
    parallelism (the JAX step's text). The parallel steps themselves are
    held to JAX in tests/test_torch_parallel_train.py."""
    for step in (ttrain.make_backbone_train_step(axis_name="data"),
                 ttrain.make_backbone_eval_step(class_axis_name="model")):
        with pytest.raises(RuntimeError, match="shard_map_"):
            step(None, None, None, None)
    with pytest.raises(ValueError, match="center loss is not supported "
                                         "with class-parallel softmax"):
        ttrain.make_backbone_train_step(class_axis_name="model",
                                        center_weight=0.1)
    # bwd_im2col is ported (tests/test_torch_conv_backward.py)
    assert callable(ttrain.make_backbone_train_step(bwd_im2col=True))


def test_eval_center_crop_and_uint8_batches_match_jax():
    """uint8 batches scale on the device as the jitted JAX step scales
    them (``x * float32(1/255)``), and ``crop_size`` takes each row's
    center crop: EFMNet342 at 32x32 evaluated on 40x40 uint8 faces."""
    name, size, model, _, jstate, _ = _net("efmnet342")
    faces, labels = synthetic_faces(num_ids=NC, per_id=4, size=40, seed=1)
    u8 = (faces * 255).astype(np.uint8)
    batches = list(PairBatcher(u8, labels, B, seed=1))[:2]
    jstep = jax.jit(jtrain.make_backbone_eval_step(
        model, mining_mode="semi_hard", crop_size=size))
    tstep = ttrain.make_backbone_eval_step(mining_mode="semi_hard",
                                           crop_size=size)
    tstate = _port_state(name, size, jstate)
    for a, p, l in batches:
        assert a.dtype == np.uint8
        _check_metrics(tstep(tstate, a, p, l), _np(jstep(jstate, a, p, l)))


def test_anchor_half_only_draws_random_negatives_from_anchors():
    """``mine_anchor_half_only``: ``random`` negatives come from the pool's
    first B rows (the anchors), as the JAX ``num_candidates`` does."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
        steps,
    )

    gen = torch.Generator().manual_seed(0)
    anc, pos = torch.randn(16, 4), torch.randn(16, 4) + 10.0
    labels = torch.arange(16) % 5
    pool, pool_labels = torch.cat([anc, pos]), torch.cat([labels, labels])
    for _ in range(5):
        neg = steps._mine("random", gen, anc, pos, pool, labels,
                          pool_labels, num_candidates=16)
        assert bool((neg.abs() < 9.0).all())   # no row of the + 10 half
