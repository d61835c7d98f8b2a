"""The port's LFW protocol (``eval/lfw.py``) and pairs input
(``data/lfw.py``) against the JAX package's, on the same seeded numpy
inputs. Both are numpy, so every result must be EQUAL: no tolerance.

Covered: both distance metrics, ``subtract_mean``, a pair count that the
fold count does not divide, distances lying exactly on the grid's
thresholds, the unreachable-FAR warning (raised on both sides, with the
same text), and pairs files with missing images and malformed lines.
"""

import warnings

import numpy as np
import pytest

from improving_face_recognition_performance_using_triplet_loss_tpu.data import (
    lfw as jdata,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.eval import (
    lfw as jlfw,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
    lfw as tdata,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.eval import (
    lfw as tlfw,
)


def _pairs(n, dim=16, sep=1.0, seed=0, normalize=True):
    rng = np.random.default_rng(seed)
    issame = rng.random(n) < 0.5
    e1 = rng.normal(size=(n, dim))
    e2 = np.where(issame[:, None], e1 + 0.4 * rng.normal(size=(n, dim)),
                  e1 + sep * rng.normal(size=(n, dim)))
    if normalize:
        e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
        e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    return e1.astype(np.float32), e2.astype(np.float32), issame


def _assert_same(got, want):
    assert type(got) is type(want)
    if isinstance(got, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want or (np.isnan(got) and np.isnan(want))


@pytest.mark.parametrize("metric", [0, 1])
@pytest.mark.parametrize("subtract_mean", [False, True])
@pytest.mark.parametrize("n,folds", [(300, 10), (203, 10), (97, 7)])
def test_evaluate_equals_jax(metric, subtract_mean, n, folds):
    e1, e2, issame = _pairs(n, seed=n + metric)
    kw = dict(nrof_folds=folds, distance_metric=metric,
              subtract_mean=subtract_mean, far_target=1e-2)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jlfw.evaluate(e1, e2, issame, **kw)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tlfw.evaluate(e1, e2, issame, **kw)
    _assert_same(got, want)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


@pytest.mark.parametrize("metric", [0, 1])
def test_parts_equal_jax(metric):
    """distance, kfold_indices, calculate_accuracy / val_far / roc / val."""
    e1, e2, issame = _pairs(150, seed=3)
    _assert_same(tlfw.distance(e1, e2, metric), jlfw.distance(e1, e2, metric))
    for n, k in ((150, 10), (11, 4), (10, 10)):
        got = list(tlfw.kfold_indices(n, k))
        want = list(jlfw.kfold_indices(n, k))
        assert len(got) == len(want) == k
        for (ga, gb), (wa, wb) in zip(got, want):
            _assert_same(ga, wa)
            _assert_same(gb, wb)
    dist = jlfw.distance(e1, e2, metric)
    for th in (0.0, 0.3, float(np.median(dist)), 10.0):
        _assert_same(tlfw.calculate_accuracy(th, dist, issame),
                     jlfw.calculate_accuracy(th, dist, issame))
        _assert_same(tlfw.calculate_val_far(th, dist, issame),
                     jlfw.calculate_val_far(th, dist, issame))
    thr = np.arange(0, 4, 0.05)
    _assert_same(tlfw.calculate_roc(thr, e1, e2, issame, 5, metric, True),
                 jlfw.calculate_roc(thr, e1, e2, issame, 5, metric, True))
    _assert_same(tlfw.calculate_val(thr, e1, e2, issame, 0.05, 5, metric),
                 jlfw.calculate_val(thr, e1, e2, issame, 0.05, 5, metric))
    with pytest.raises(ValueError, match="Undefined distance metric"):
        tlfw.distance(e1, e2, 2)


def test_distances_on_grid_thresholds():
    """Pair distances that equal grid thresholds exactly: ``np.less`` puts
    them on the far side on both sides, and the ROC argmax ties resolve
    alike. Integer offsets make the squared distances 0, 1, 2 and 3, each
    a threshold of the ROC grid."""
    rng = np.random.default_rng(5)
    n = 120
    issame = rng.random(n) < 0.5
    steps = np.where(issame, rng.integers(0, 3, n), rng.integers(1, 4, n))
    e1 = rng.integers(-3, 4, (n, 3)).astype(np.float64)
    e2 = e1 + (np.arange(3)[None] < steps[:, None])
    thr_roc = np.arange(0, 4, 0.01)
    dist = jlfw.distance(e1, e2, 0)
    assert np.isin(dist, thr_roc).all() and len(set(dist)) == 4
    _assert_same(tlfw.evaluate(e1, e2, issame, nrof_folds=10),
                 jlfw.evaluate(e1, e2, issame, nrof_folds=10))
    _assert_same(tlfw.calculate_roc(thr_roc, e1, e2, issame),
                 jlfw.calculate_roc(thr_roc, e1, e2, issame))


def test_unreachable_far_warns_on_both_sides():
    e1, e2, issame = _pairs(60, sep=50.0, seed=9, normalize=False)
    thresholds = np.arange(0, 0.5, 0.01)
    results = []
    for mod in (jlfw, tlfw):
        with pytest.warns(UserWarning, match="FAR never reached") as rec:
            results.append(mod.calculate_val(
                thresholds, e1, e2, issame, far_target=1e-3, nrof_folds=3))
        results.append([str(w.message) for w in rec])
    _assert_same(results[2], results[0])
    assert results[3] == results[1] and len(results[1]) == 3
    assert results[2][0] == 0.0


def _tree(root, files):
    for name, nums in files.items():
        d = root / name
        d.mkdir(parents=True)
        for i in nums:
            (d / f"{name}_{i:04d}.jpg").write_bytes(b"x")


def test_pairs_input_equals_jax(tmp_path, capsys):
    """read_pairs skips the header and blank lines; get_paths resolves
    same / different pairs, skips malformed lines, and counts the pairs
    with a missing image, printing the same line."""
    lfw_dir = tmp_path / "lfw"
    _tree(lfw_dir, {"Alice_A": (1, 2, 3), "Bob_B": (1,), "Carol_C": (2,)})
    pairs_txt = tmp_path / "pairs.txt"
    pairs_txt.write_text(
        "10\t300\n"
        "Alice_A\t1\t2\n"
        "\n"
        "Alice_A\t1\tBob_B\t1\n"
        "Alice_A\t1\t9\n"              # missing -> skipped
        "Bob_B\t1\tCarol_C\t1\n"       # missing -> skipped
        "Carol_C\t2\n"                 # malformed -> ignored
        "Alice_A\t2\t3\n"
        "Carol_C\t2\tAlice_A\t3\n")
    want_pairs = jdata.read_pairs(str(pairs_txt))
    got_pairs = tdata.read_pairs(str(pairs_txt))
    assert got_pairs == want_pairs and len(got_pairs) == 7
    for ext in ("jpg", "png"):
        want = jdata.get_paths(str(lfw_dir), want_pairs, file_ext=ext)
        want_out = capsys.readouterr().out
        got = tdata.get_paths(str(lfw_dir), got_pairs, file_ext=ext)
        got_out = capsys.readouterr().out
        assert got[0] == want[0]
        _assert_same(got[1], want[1])
        assert got_out == want_out
    paths, issame = tdata.get_paths(str(lfw_dir), got_pairs)
    assert len(paths) == 8
    np.testing.assert_array_equal(issame, [True, False, True, False])
    assert "Skipped 2 image pairs (missing files)" in capsys.readouterr().out
