"""Port distances, miners and kernel B1 against their JAX twins, on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and
the port's. Kernel B1's JAX side is the Pallas kernel in interpret mode;
the port's wrapper, given CPU tensors, runs its plain version. Every index
comparison is exact; float outputs agree to 1e-6. The miners take the same
distances on both sides, so only their own rules decide; B1 computes its
distances from rows, so every float case first asserts that no pick lies
within ``PICK_EPS`` of a near-tie (``_torch_ties.semi_hard_margins``), and
the integer cases are exact arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.ops import (
    distances as jdist,
    mining as jmining,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.pallas.triplet_kernel import (
    semi_hard_mining_pallas,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
    distances as tdist,
    mining as tmining,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    mining as tkernel,
)

from _torch_ties import PICK_EPS, semi_hard_margins, sq_distances

T = torch.from_numpy


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------- distances


@pytest.mark.parametrize("fn", ["pairwise_sq_l2", "pairwise_cosine",
                                "rowwise_cosine"])
def test_distances_match_jax(fn):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(24, 40)).astype(np.float32)
    b = rng.normal(size=(24 if fn == "rowwise_cosine" else 56, 40)).astype(
        np.float32)
    want = _np(getattr(jdist, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tdist, fn)(T(a), T(b)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # the pairwise products sum 40 terms in another order than XLA's
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * max(
        1.0, float(np.abs(want).max())))


# ------------------------------------------------------------------ miners


def _sq_case(seed, b=48, n=96, ids=7, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        sq = rng.integers(0, 6, (b, n)).astype(np.float32)
        pos = rng.integers(0, 6, b).astype(np.float32)
    else:
        sq = rng.uniform(0, 4, (b, n)).astype(np.float32)
        pos = rng.uniform(0.5, 2.5, b).astype(np.float32)
    return sq, pos, rng.integers(0, ids, b), rng.integers(0, ids, n)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_semi_hard_and_hard_miners_match_jax(seed, integer):
    sq, pos, al, pl = _sq_case(seed, integer=integer)
    want_semi = _np(jmining.mine_semi_hard_negative(
        jnp.asarray(sq), jnp.asarray(pos), jnp.asarray(al), jnp.asarray(pl)))
    got_semi = tmining.mine_semi_hard_negative(T(sq), T(pos), T(al), T(pl))
    np.testing.assert_array_equal(got_semi.numpy(), want_semi)
    want_hard = _np(jmining.mine_hard_negative(
        jnp.asarray(sq), jnp.asarray(al), jnp.asarray(pl)))
    got_hard = tmining.mine_hard_negative(T(sq), T(al), T(pl))
    np.testing.assert_array_equal(got_hard.numpy(), want_hard)
    assert got_semi.dtype == got_hard.dtype == torch.int32


def test_miners_with_no_negative_return_zero():
    sq, pos, _, _ = _sq_case(2, b=8, n=12)
    same = np.zeros(8, np.int64), np.zeros(12, np.int64)
    for got in (tmining.mine_semi_hard_negative(T(sq), T(pos), T(same[0]),
                                                T(same[1])),
                tmining.mine_hard_negative(T(sq), T(same[0]), T(same[1]))):
        assert (got.numpy() == 0).all()


def test_gather_rows_matches_jax_and_carries_gradient():
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(10, 4)).astype(np.float32)
    idx = rng.integers(0, 10, 6).astype(np.int32)
    want = _np(jmining.gather_rows(jnp.asarray(pool), jnp.asarray(idx)))
    p = T(pool).requires_grad_()
    got = tmining.gather_rows(p, T(idx))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    got.sum().backward()
    np.testing.assert_array_equal(p.grad.numpy()[:, 0],
                                  np.bincount(idx, minlength=10))


def test_random_negative_labels_always_differ():
    labels = T(np.repeat(np.arange(8), 4))
    gen = torch.Generator().manual_seed(0)
    idx = tmining.mine_random_negative(gen, labels, labels)
    assert idx.dtype == torch.int32
    assert (labels[idx.long()] != labels).all()


def test_random_negative_respects_candidate_limit():
    labels = T(np.arange(16) % 4)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        idx = tmining.mine_random_negative(gen, labels[:8], labels,
                                           num_candidates=8)
        assert (idx < 8).all()
        assert (labels[idx.long()] != labels[:8]).all()


def test_random_negative_is_uniform():
    """Anchors of label 0 over a pool with one same-label row and five
    negatives: the picks spread evenly over the five (chi-square, 4 degrees
    of freedom, below its 0.1% quantile 18.47)."""
    pool = T(np.array([0, 1, 2, 2, 3, 4]))
    anchors = T(np.zeros(3000, np.int64))
    gen = torch.Generator().manual_seed(2)
    counts = np.bincount(tmining.mine_random_negative(gen, anchors,
                                                      pool).numpy(),
                         minlength=6)
    assert counts[0] == 0
    chi2 = float(((counts[1:] - 600.0) ** 2 / 600.0).sum())
    assert chi2 < 18.47, counts


# ------------------------------------------------------------- kernel B1


def _b1_case(seed, b=64, n=128, d=32, ids=10, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        # every product and sum is exact in float32, so ties are common
        anc = rng.integers(-1, 2, (b, d)).astype(np.float32)
        pool = rng.integers(-1, 2, (n, d)).astype(np.float32)
        pos_sq = rng.integers(0, 2 * d, b).astype(np.float32)
    else:
        anc = rng.normal(size=(b, d)).astype(np.float32)
        pool = rng.normal(size=(n, d)).astype(np.float32)
        anc /= np.linalg.norm(anc, axis=1, keepdims=True)
        pool /= np.linalg.norm(pool, axis=1, keepdims=True)
        pos_sq = rng.uniform(0.5, 2.5, b).astype(np.float32)
    return anc, pos_sq, rng.integers(0, ids, b), pool, rng.integers(0, ids, n)


def _b1_margins(case):
    anc, pos_sq, al, pool, pl = case
    return semi_hard_margins(sq_distances(anc, pool), pos_sq, al, pl)


def _b1_both(case, tile_b, tile_n):
    anc, pos_sq, al, pool, pl = case
    want = _np(semi_hard_mining_pallas(
        jnp.asarray(anc), jnp.asarray(pos_sq), jnp.asarray(al),
        jnp.asarray(pool), jnp.asarray(pl), tile_b=tile_b, tile_n=tile_n,
        interpret=True))
    got = tkernel.semi_hard_mining(T(anc), T(pos_sq), T(al), T(pool), T(pl))
    assert got.dtype == torch.int32 and got.shape == (anc.shape[0],)
    return got.numpy(), want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b1_matches_pallas(seed):
    case = _b1_case(seed)
    assert _b1_margins(case).min() > PICK_EPS
    got, want = _b1_both(case, 32, 32)
    np.testing.assert_array_equal(got, want)


def test_b1_single_tile():
    case = _b1_case(3, b=16, n=16)
    assert _b1_margins(case).min() > PICK_EPS
    got, want = _b1_both(case, 16, 16)
    np.testing.assert_array_equal(got, want)


def test_b1_fallback_to_farthest():
    """Positives farther than every negative: every anchor takes the
    farthest negative."""
    anc, _, al, pool, pl = _b1_case(4, b=32, n=64)
    pos_sq = np.full(32, 100.0, np.float32)
    assert _b1_margins((anc, pos_sq, al, pool, pl)).min() > PICK_EPS
    got, want = _b1_both((anc, pos_sq, al, pool, pl), 32, 32)
    np.testing.assert_array_equal(got, want)
    sq = tdist.pairwise_sq_l2(T(anc), T(pool)).numpy()
    far = np.where(al[:, None] != pl[None, :], sq, -np.inf).argmax(1)
    np.testing.assert_array_equal(got, far)


def test_b1_all_one_label_returns_zero():
    anc, pos_sq, _, pool, _ = _b1_case(5, b=32, n=64)
    got, want = _b1_both((anc, pos_sq, np.zeros(32, np.int64), pool,
                          np.zeros(64, np.int64)), 32, 32)
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()


def test_b1_exact_arithmetic_ties():
    """Small-integer rows: every distance is exact, so the first-index tie
    breaking and the strict ``sq > pos_sq`` decide many anchors."""
    case = _b1_case(6, integer=True)
    got, want = _b1_both(case, 32, 32)
    np.testing.assert_array_equal(got, want)
    anc, pos_sq, al, pool, pl = case
    sq = tdist.pairwise_sq_l2(T(anc), T(pool)).numpy()
    neg = al[:, None] != pl[None, :]
    semi = np.where(neg & (sq > pos_sq[:, None]), sq, np.inf)
    tied = (semi == semi.min(1, keepdims=True)) & np.isfinite(semi)
    assert (tied.sum(1) > 1).sum() > 10          # ties at the minimum
    assert (neg & (sq == pos_sq[:, None])).any()  # sq == pos_sq excluded


def test_b1_plain_is_the_oracle_on_ragged_shapes():
    """Shapes no tile divides: the wrapper's plain version equals the JAX
    oracle (the Pallas kernel itself refuses such shapes)."""
    anc, pos_sq, al, pool, pl = _b1_case(7, b=30, n=50, d=20)
    assert _b1_margins((anc, pos_sq, al, pool, pl)).min() > PICK_EPS
    want = _np(jmining.mine_semi_hard_negative(
        jdist.pairwise_sq_l2(jnp.asarray(anc), jnp.asarray(pool)),
        jnp.asarray(pos_sq), jnp.asarray(al), jnp.asarray(pl)))
    got = tkernel.semi_hard_mining(T(anc), T(pos_sq), T(al), T(pool), T(pl))
    np.testing.assert_array_equal(got.numpy(), want)


def test_b1_wrapper_checks_shapes_and_counts_no_cpu_launch():
    anc, pos_sq, al, pool, pl = _b1_case(8, b=8, n=16)
    with pytest.raises(ValueError):
        tkernel.semi_hard_mining(T(anc), T(pos_sq), T(al), T(pool[:, :5]),
                                 T(pl))
    with pytest.raises(ValueError):
        tkernel.semi_hard_mining(T(anc), T(pos_sq[:4]), T(al), T(pool), T(pl))
    with pytest.raises(ValueError):
        tkernel.semi_hard_mining(T(anc), T(pos_sq), T(al), T(pool[:0]),
                                 T(pl[:0]))
    before = tkernel.launches.count
    tkernel.semi_hard_mining(T(anc), T(pos_sq), T(al), T(pool), T(pl))
    assert tkernel.launches.count == before


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
