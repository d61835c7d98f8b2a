"""The near-tie rule of ``tests/_torch_ties.py`` on constructed inputs: a
near-tie is accepted, a real difference is rejected."""

import numpy as np
import pytest

from _torch_ties import (
    PICK_EPS,
    argmax_margins,
    assert_cascade_margins,
    assert_face_rank_margins,
    assert_host_nms_margins,
    assert_match_margins,
    assert_picks_explained,
    hard_margins,
    int8_margins,
    overlap_margins,
    rounding_ties,
    semi_hard_margins,
    semi_hard_terms,
    step_pick_margins,
    unexplained_picks,
)


def _pool():
    """Two anchors and their positives, then four candidates: row 4 lies
    4e-7 farther from anchor 0 than its positive (semi-hard by a hair),
    row 5 a clear 0.1 farther, row 6 2e-6 past row 5; anchor 1's
    negatives are far apart."""
    rng = np.random.default_rng(0)
    d = 8
    a0, a1 = np.eye(d)[0], np.eye(d)[1]

    def at(anchor, sq, axis):
        # a unit row at squared distance ``sq`` from ``anchor``
        c = 1.0 - sq / 2.0
        return c * anchor + np.sqrt(1.0 - c * c) * np.eye(d)[axis]

    pos_sq = 0.05
    rows = [a0, a1, at(a0, pos_sq, 2), at(a1, 0.3, 3),
            at(a0, pos_sq + 4e-7, 4), at(a0, 0.15, 5),
            at(a0, 0.15 + 2e-6, 6), at(a1, 0.9, 7)]
    scale = rng.uniform(0.5, 2.0, size=(len(rows), 1))
    return np.asarray(rows) * scale


def test_semi_hard_terms_are_scale_free():
    pool = _pool()
    dist, pos_sq = semi_hard_terms(pool, 2)
    assert dist.shape == (2, 8) and pos_sq.shape == (2,)
    np.testing.assert_allclose(pos_sq, [0.05, 0.3], atol=1e-12)
    np.testing.assert_allclose(dist[0, [4, 5, 6]],
                               [0.05 + 4e-7, 0.15, 0.15 + 2e-6], atol=1e-12)
    assert dist[0, 0] == pytest.approx(0.0, abs=1e-12)


@pytest.mark.parametrize("got, want, differing", [
    ([4, 7], [4, 7], []),    # the same picks
    ([4, 7], [5, 7], [0]),   # row 4 sits 4e-7 past pos_sq: rounding may
                             # count it semi-hard or not
    ([5, 7], [6, 7], [0]),   # rows 5 and 6 are 2e-6 apart
])
def test_near_ties_are_accepted(got, want, differing):
    pool = _pool()
    assert assert_picks_explained({"jax": pool, "port": pool * 1.5}, got,
                                  want) == differing


def test_real_differences_are_rejected_naming_the_anchor():
    pool = _pool()
    # anchor 0: rows 5 and 3 lie far apart and far from its pos_sq
    with pytest.raises(AssertionError, match=r"\('port', 0, 5, 3,"):
        assert_picks_explained({"port": pool}, [5, 7], [3, 7])
    # anchor 1: rows 7 and 5 are far apart and far from its pos_sq
    with pytest.raises(AssertionError, match=r"\('jax', 1, 7, 5,"):
        assert_picks_explained({"jax": pool}, [4, 7], [4, 5])
    # two picks twice the rule's epsilon apart, both clear of pos_sq
    dist = np.array([[0.0, 0.2, 0.2 + 2 * PICK_EPS]])
    assert unexplained_picks(dist, np.array([0.1]), [1], [2]) == [
        (0, 1, 2, 0.2, 0.2 + 2 * PICK_EPS, 0.1)]
    assert unexplained_picks(dist, np.array([0.1]), [1], [1]) == []


def test_rounding_ties():
    scores = np.array([0.5, 0.5 + 3e-7, 0.7, 0.7, 0.9])
    other = scores + np.array([2e-7, -2e-7, 0.0, 0.0, 1e-7])
    boxes = np.array([[0, 0, 9, 9], [1, 1, 10, 10], [5, 5, 20, 20],
                      [5, 5, 20, 20], [0, 0, 4, 4]])
    # 0 and 1 lie 3e-7 apart with 4e-7 of rounding between them; 2 and 3
    # tie exactly but hold the same box
    assert rounding_ties(scores, other, boxes) == [(0, 1)]
    assert rounding_ties(scores, other) == [(0, 1), (2, 3)]
    # with less rounding than the gap, the order is safe
    assert rounding_ties(scores, scores + 1e-7, boxes) == []
    # a frame whose scores all tie within rounding
    flat = np.full(6, 0.489847) + np.arange(6) * 1e-8
    assert len(rounding_ties(flat, flat[::-1], np.arange(24).reshape(6, 4))
               ) == 15


def test_argmax_margins():
    sims = np.array([[0.9, 0.2, 0.1], [0.5, 0.5 + 1e-7, 0.0],
                     [0.3, 0.1, 0.8]])
    m = argmax_margins(sims, 1e-6)
    assert m[0] > 0 and m[2] > 0 and m[1] < 0
    # masked entries never win and never count as the runner-up
    valid = np.array([True, False, True])
    m = argmax_margins(sims, 1e-6, valid=valid)
    assert np.all(m > 0)
    assert argmax_margins([0.4], 1e-6)[0] == np.inf


def test_semi_hard_and_hard_margins():
    pool = _pool()
    dist, pos_sq = semi_hard_terms(pool, 2)
    labels = np.array([0, 1])
    pool_labels = np.array([0, 1, 0, 1, 2, 2, 2, 3])
    m = semi_hard_margins(dist, pos_sq, labels, pool_labels)
    # anchor 0: row 4 sits 4e-7 past pos_sq, the room rounding has
    assert m[0] == pytest.approx(4e-7, abs=1e-12)
    assert m[1] > 0.05
    # without row 4, anchor 0's pick (row 5) leads row 6 by 2e-6
    keep = np.arange(8) != 4
    m = semi_hard_margins(dist[:, keep], pos_sq, labels, pool_labels[keep])
    assert m[0] == pytest.approx(2e-6, abs=1e-12)
    # hard mining: anchor 0's nearest negatives are rows 4 and 5
    h = hard_margins(dist, labels, pool_labels)
    assert h[0] == pytest.approx(0.1 - 4e-7, abs=1e-9)
    # no negative at all: nothing to decide
    assert np.isinf(hard_margins(dist[:1], labels[:1],
                                 np.zeros(8, int))).all()
    assert np.isinf(semi_hard_margins(dist[:1], pos_sq[:1], labels[:1],
                                      np.zeros(8, int))).all()


def test_step_pick_margins_count_equal_rows_once():
    rng = np.random.default_rng(1)
    anc = rng.normal(size=(4, 6)).astype(np.float32)
    pos = anc + 0.1 * rng.normal(size=(4, 6)).astype(np.float32)
    pool = np.concatenate([anc, pos])
    labels = np.arange(4)
    pool_labels = np.concatenate([labels, labels])
    base = step_pick_margins("semi_hard", anc, pos, pool, labels,
                             pool_labels)
    assert base > 0
    # a repeated image: an exact tie the first-row rule decides
    twice = np.concatenate([pool, pool[:1]])
    assert step_pick_margins("hard", anc, pos, twice, labels,
                             np.concatenate([pool_labels, [0]])) > 0
    assert step_pick_margins("semi_hard", anc, pos, twice, labels,
                             np.concatenate([pool_labels, [0]])) == base


def test_overlap_margins():
    boxes = np.array([[0, 0, 9, 9, 0.9], [5, 0, 14, 9, 0.8],
                      [100, 100, 109, 109, 0.7]], np.float32)
    # boxes 0 and 1: intersection 5 x 10 over a union of 150
    assert overlap_margins(boxes, 0.5) == pytest.approx(0.5 - 50 / 150)
    assert overlap_margins(boxes, 50 / 150) == pytest.approx(0.0, abs=1e-9)
    # Min: 50 over the smaller area, 100
    assert overlap_margins(boxes, 0.5, "Min") == pytest.approx(0.0, abs=1e-9)
    nan = boxes.copy()
    nan[2, 0] = np.nan
    assert np.isfinite(overlap_margins(nan, 0.4))
    assert overlap_margins(boxes[:1], 0.5) == np.inf


def test_argmax_margins_take_each_entrys_rounding():
    sims = np.array([[0.50, 0.49, 0.1]])
    assert argmax_margins(sims, np.array([[0.004, 0.004, 0.0]]))[0] > 0
    assert argmax_margins(sims, np.array([[0.006, 0.005, 0.0]]))[0] < 0


def test_int8_margins():
    x = np.array([[0.5 / 127 + 1e-4, 3.2 / 127]])
    # 127 x = 0.5127: 0.0127 from the rounding edge at 0.5
    assert int8_margins(x, x) == pytest.approx(0.0127, abs=1e-9)
    assert int8_margins(x, x + 2e-4) < 0


def test_match_margins():
    rows = np.eye(4)
    probes = np.array([[1.0, 0.2, 0.0, 0.0], [0.0, 0.0, 0.1, 0.3]])
    assert_match_margins(probes, rows, 0.5, 1e-6)
    # one owner holds rows 0 and 1: close similarities of one owner are fine
    close = np.array([[1.0, 1.0 - 1e-7, 0.0, 0.0]])
    with pytest.raises(AssertionError):
        assert_match_margins(close, rows, 0.5, 1e-6)
    assert_match_margins(close, rows, 0.5, 1e-6, owners=[0, 0, 1, 2])
    # any subset may be held: rows 1 and 2 tie for a probe near row 0
    sub = np.array([[1.0, 0.8, 0.8 + 1e-7, 0.0]])
    assert_match_margins(sub, rows, 0.5, 1e-6)
    with pytest.raises(AssertionError):
        assert_match_margins(sub, rows, 0.5, 1e-6, subsets=True)
    # a similarity within rounding of the threshold
    with pytest.raises(AssertionError):
        assert_match_margins(np.array([[1.0, 1.0, 0.0, 0.0]]), rows,
                             np.sqrt(0.5), 1e-6)


def test_face_rank_margins():
    boxes = np.array([[10, 10, 40, 40], [20, 20, 30, 30]], np.float64)
    assert_face_rank_margins(boxes, boxes + 1e-4, 64, 64)
    twins = np.array([[10, 10, 40, 40], [24, 24, 54, 54]], np.float64)
    with pytest.raises(AssertionError, match="within rounding"):
        assert_face_rank_margins(twins, twins + 1e-4, 64, 64)


def _nms_set(scores, n=4):
    b = np.zeros((n, 5))
    b[:, 0] = np.arange(n) * 20
    b[:, 2] = b[:, 0] + 10
    b[:, 3] = 10
    b[:, 4] = scores
    return b


def test_cascade_margins_name_what_rounding_decides():
    keep = np.ones((1, 4), bool)
    port = [(0.5, "Union", _nms_set([0.9, 0.8, 0.7, -np.inf])[None], keep)]
    ok = [(0.5, "Union", _nms_set([0.9, 0.8 + 1e-7, 0.7, -np.inf]), keep[0])]
    assert assert_cascade_margins(port, ok, 1, [0.3]) == 1
    tie = [(0.5, "Union", _nms_set([0.9, 0.7 + 1e-7, 0.8, -np.inf]),
            keep[0])]
    with pytest.raises(AssertionError):
        assert_cascade_margins(port, tie, 1, [0.3])
    one_side = [(0.5, "Union", _nms_set([0.9, 0.8, 0.7, 0.6]), keep[0])]
    with pytest.raises(AssertionError, match="valid on one side only"):
        assert_cascade_margins(port, one_side, 1, [0.3])
    # a score within its own rounding of the threshold that let it in
    near = [(0.5, "Union", _nms_set([0.9, 0.8, 0.7 + 0.01, -np.inf]),
             keep[0])]
    with pytest.raises(AssertionError, match="threshold"):
        assert_cascade_margins(port, near, 1, [0.705])


def test_host_nms_margins():
    b = _nms_set([0.9, 0.8, 0.7, 0.6])
    assert_host_nms_margins([(0.5, "Union", b)], [(0.5, "Union", b + 0)])
    other = b.copy()
    other[1, 4], other[2, 4] = 0.7 + 1e-6, 0.8
    with pytest.raises(AssertionError, match="rounding ties"):
        assert_host_nms_margins([(0.5, "Union", b)],
                                [(0.5, "Union", other)])
    with pytest.raises(AssertionError):
        assert_host_nms_margins([(0.5, "Union", b)],
                                [(0.5, "Union", b[:3])])
