"""When float32 rounding may decide what a port parity test compares.

A cross-framework test asserts a decision exactly -- a mining pick, a
gallery index, an NMS keep set, a box count -- only where no near-tie
decides it. The two frameworks sum in other orders, so their float32
results differ in the last bits, and a decision that sits on a near-tie
may fall either way on a given machine. Where one may, the test

(a) finds each decision that differs between the JAX package and the port,
(b) shows, in float64 from each side's own inputs, that each difference is
    a near-tie (:func:`assert_picks_explained`); any other difference fails,
    naming the anchor or the candidate,
(c) then compares everything downstream with the decision shared (the
    port run with the JAX package's decision), at the test's tolerances.

:func:`share_picks` does all three for the mining picks of train and eval
steps; the bulk detector's test does them for a blank frame.

Where a test asserts a decision outright, it first asserts the margin that
keeps rounding from deciding it, measured where it can be as the two
sides' own difference: picks (:func:`semi_hard_margins`,
:func:`step_pick_margins`), NMS orders and thresholds
(:func:`rounding_ties`, :func:`record_cascade_nms` with
:func:`assert_cascade_margins`, :func:`record_host_nms` with
:func:`assert_host_nms_margins`), NMS overlaps (:func:`overlap_margins`),
the face a pipeline picks (:func:`assert_face_rank_margins`), argmaxes and
gallery matches (:func:`argmax_margins`, :func:`assert_gallery_margins`,
:func:`assert_match_margins`) and int8 codes (:func:`int8_margins`).
"""

import numpy as np

# chip_smoke.py's rule for kernel B1's picks against its plain version: a
# differing pick is a near-tie when the two picks' squared distances are
# within PICK_EPS of each other, or either is within PICK_EPS of pos_sq
PICK_EPS = 1e-5
# the most float32 rounding moves an NMS overlap (a ratio of sums of box
# sides, at most 1: a few ulps, under 1e-6)
OVERLAP_EPS = 1e-6


def semi_hard_terms(pool, b: int):
    """float64 terms of semi-hard mining from one side's mining pool.

    ``pool`` is the ``[2B, D]`` pool ``[anchors | positives]`` of a step
    (or a gathered pool whose first ``b`` rows are the anchors and rows
    ``b..2b`` their positives). Returns ``(dist, pos_sq)``: the ``[b, N]``
    squared distances of the L2-normalized anchors to every normalized
    pool row, and each anchor's to its positive."""
    x = np.asarray(pool, np.float64)
    x = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    return sq_distances(x[:b], x), np.sum(np.square(x[:b] - x[b:2 * b]), 1)


def sq_distances(anc, pool):
    """float64 ``[B, N]`` squared distances between the rows as given."""
    a, p = np.asarray(anc, np.float64), np.asarray(pool, np.float64)
    return np.maximum(np.sum(a * a, 1)[:, None] + np.sum(p * p, 1)[None]
                      - 2.0 * a @ p.T, 0.0)


def semi_hard_margins(dist, pos_sq, anchor_labels, pool_labels):
    """Per anchor, the room rounding has before it changes the semi-hard
    pick: the least distance of any negative from ``pos_sq`` (which decides
    the semi-hard set, ``d > pos_sq``), or the gap between the pick and the
    runner-up of the set it is picked from (the nearest semi-hard negative,
    else the farthest negative), whichever is less; +inf for an anchor
    without a negative. A pick is safe where this exceeds twice the most
    rounding may move one distance."""
    neg = (np.asarray(anchor_labels)[:, None]
           != np.asarray(pool_labels)[None])
    pos_sq = np.asarray(pos_sq, np.float64)[:, None]
    out = np.full(len(dist), np.inf)
    for a in np.flatnonzero(neg.any(1)):
        d = dist[a, neg[a]]
        semi = np.sort(d[d > pos_sq[a]])
        pool = semi if semi.size else -np.sort(-d)
        gap = abs(pool[1] - pool[0]) if pool.size > 1 else np.inf
        out[a] = min(np.abs(d - pos_sq[a]).min(), gap)
    return out


def hard_margins(dist, anchor_labels, pool_labels):
    """Per anchor, the gap between its nearest negative and the next: the
    room rounding has before it changes a ``hard`` pick (+inf for an anchor
    with fewer than two negatives)."""
    neg = (np.asarray(anchor_labels)[:, None]
           != np.asarray(pool_labels)[None])
    out = np.full(len(dist), np.inf)
    for a in np.flatnonzero(neg.sum(1) > 1):
        d = np.sort(dist[a, neg[a]])
        out[a] = d[1] - d[0]
    return out


def step_pick_margins(mode, anc, pos, pool, anchor_labels, pool_labels):
    """The least margin of one step's picks, from its float features
    (anchors ``[B, D]``, their positives, the pool ``[N, D]``) as the steps
    mine them: rows L2-normalized, then :func:`semi_hard_margins` or
    :func:`hard_margins`. Equal pool rows count once: they are one image's
    features, a tie that the first-row rule decides without rounding."""
    def unit(x):
        x = np.asarray(x, np.float64)
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

    raw = np.asarray(pool, np.float32)
    first = np.sort(np.unique(raw, axis=0, return_index=True)[1])
    a, x = unit(anc), unit(raw[first])
    pool_labels = np.asarray(pool_labels)[first]
    dist = sq_distances(a, x)
    if mode == "hard":
        return float(hard_margins(dist, anchor_labels, pool_labels).min())
    pos_sq = np.sum(np.square(a - unit(pos)), 1)
    return float(semi_hard_margins(dist, pos_sq, anchor_labels,
                                   pool_labels).min())


def unexplained_picks(dist, pos_sq, got, want, eps: float = PICK_EPS):
    """The anchors where picks ``got`` and ``want`` differ and no
    near-tie explains it on these terms (:func:`semi_hard_terms`):
    ``[(anchor, got, want, d_got, d_want, pos_sq)]``."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(
        np.int64)
    out = []
    for a in np.flatnonzero(got != want):
        dg, dw, ps = dist[a, got[a]], dist[a, want[a]], pos_sq[a]
        if not (abs(dg - dw) <= eps or abs(dg - ps) <= eps
                or abs(dw - ps) <= eps):
            out.append((int(a), int(got[a]), int(want[a]), float(dg),
                        float(dw), float(ps)))
    return out


def assert_picks_explained(sides, got, want, b: int | None = None,
                           eps: float = PICK_EPS):
    """(a) and (b) for mining picks: ``sides`` maps a side's name to its
    own pool of features (see :func:`semi_hard_terms`); every anchor where
    ``got`` and ``want`` differ must be a near-tie on every side. Raises
    naming each anchor that is not; returns the differing anchors."""
    got, want = np.asarray(got), np.asarray(want)
    b = len(got) if b is None else b
    bad = []
    for name, pool in sides.items():
        dist, pos_sq = semi_hard_terms(pool, b)
        bad += [(name,) + u for u in unexplained_picks(dist, pos_sq, got,
                                                       want, eps)]
    assert not bad, "picks differ beyond rounding (side, anchor, got, want, " \
        "d_got, d_want, pos_sq): " + "; ".join(map(str, bad))
    return [int(a) for a in np.flatnonzero(got != want)]


def share_picks(monkeypatch):
    """(a)-(c) for the mining picks of steps compared across the packages.

    Patches both packages' ``ops.mining.gather_rows``, the one call that
    takes a step's picks. A JAX step reports its pool and picks through a
    debug callback compiled into the very step that is compared (ordered,
    so a loop's steps report in order). A port step then takes the JAX
    report of the same step: its own picks must differ from the JAX ones
    only at near-ties on both pools (:func:`assert_picks_explained`), and
    it gathers the JAX picks, so that everything downstream is compared
    with the decision shared. The port's k-th mining call takes the k-th
    JAX report: run each JAX step before its port twin. Returns the list
    that receives one ``{"jax", "port", "differing"}`` per port step."""
    import jax
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu.ops import (
        mining as jmining,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
        mining as tmining,
    )

    reports, log = [], []
    jgather, tgather = jmining.gather_rows, tmining.gather_rows

    def jax_gather(pool_feat, idx):
        jax.debug.callback(
            lambda pool, picks: reports.append((np.asarray(pool),
                                                np.asarray(picks))),
            pool_feat, idx, ordered=True)
        return jgather(pool_feat, idx)

    def port_gather(pool_feat, idx):
        jax.effects_barrier()
        assert reports, "a port step mined before its JAX twin"
        jpool, jidx = reports.pop(0)
        got = idx.cpu().numpy()
        differing = assert_picks_explained(
            {"jax": jpool, "port": pool_feat.detach().float().cpu().numpy()},
            got, jidx)
        log.append({"jax": jidx, "port": got, "differing": differing})
        return tgather(pool_feat, torch.as_tensor(jidx).to(idx))

    monkeypatch.setattr(jmining, "gather_rows", jax_gather)
    monkeypatch.setattr(tmining, "gather_rows", port_gather)
    return log


def record_cascade_nms(monkeypatch):
    """Record the boxes that enter every NMS of both packages' device
    cascades (stage 1's per-scale and cross-scale passes, stages 2 and 3)
    with the keep masks that come out: returns ``(port, jax)`` lists of
    ``(threshold, method, boxes [..., N, 5], keep [..., N])``. The port's
    calls carry a leading frame axis; the JAX cascade runs one frame a
    call and reports through ordered debug callbacks compiled into it, so
    patch before the JAX cascade is first traced."""
    import jax

    from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
        device_cascade as jcascade,
        device_pnet as jpnet,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        device_cascade as tcascade,
        device_pnet as tpnet,
    )

    port, jax_calls = [], []

    def on_port(real):
        def nms(boxes, threshold, method="Union"):
            keep = real(boxes, threshold, method)
            port.append((threshold, method,
                         boxes.detach().cpu().numpy().copy(),
                         keep.cpu().numpy().copy()))
            return keep
        return nms

    def on_jax(real):
        def nms(boxes, threshold, method="Union", **kwargs):
            keep = real(boxes, threshold, method, **kwargs)
            jax.debug.callback(
                lambda b, k: jax_calls.append((threshold, method,
                                               np.asarray(b), np.asarray(k))),
                boxes, keep, ordered=True)
            return keep
        return nms

    for module in (tpnet, tcascade):
        monkeypatch.setattr(module, "nms_mask_batched",
                            on_port(module.nms_mask_batched))
    monkeypatch.setattr(jpnet, "nms_mask_batched",
                        on_jax(jpnet.nms_mask_batched))
    for module in (jpnet, jcascade):
        monkeypatch.setattr(module, "nms_mask", on_jax(module.nms_mask))
    return port, jax_calls


def assert_cascade_margins(port, jax_calls, frames: int, thresholds):
    """Hold the NMS inputs :func:`record_cascade_nms` recorded for
    ``frames`` frames (one port call of the batch, then the JAX cascade's
    calls frame by frame) to the margins that keep rounding from deciding
    the cascade. Each box set must hold the same valid candidates on both
    sides, their boxes within 1e-3; no two valid candidates with different
    boxes may tie within their own rounding (:func:`rounding_ties`, which
    covers the NMS order and the order the later capacities sort by); and
    each valid score must clear the score threshold that let it in
    (``thresholds[c]`` for the c-th NMS of a frame) by more than its own
    rounding. Returns the number of box sets checked."""
    calls = len(port)
    assert calls == len(thresholds) and len(jax_calls) == frames * calls, (
        calls, len(jax_calls))
    checked = 0
    for c, (th, method, boxes, _) in enumerate(port):
        boxes = np.asarray(boxes, np.float64).reshape(
            frames, -1, boxes.shape[-2], boxes.shape[-1])
        for f in range(frames):
            jth, jmethod, jboxes, _ = jax_calls[f * calls + c]
            jboxes = np.asarray(jboxes, np.float64).reshape(boxes.shape[1:])
            assert (th, method) == (jth, jmethod), (c, f)
            for g, (b, jb) in enumerate(zip(boxes[f], jboxes)):
                where = f"NMS {c} of frame {f}, set {g}"
                valid = np.isfinite(b[:, 4])
                assert np.array_equal(valid, np.isfinite(jb[:, 4])), (
                    f"{where}: rows valid on one side only: "
                    f"{np.flatnonzero(valid != np.isfinite(jb[:, 4]))}")
                b, jb = b[valid], jb[valid]
                np.testing.assert_allclose(b[:, :4], jb[:, :4], atol=1e-3,
                                           err_msg=where)
                ties = rounding_ties(b[:, 4], jb[:, 4], b[:, :4])
                assert not ties, f"{where}: rounding ties {ties[:5]}"
                e = np.abs(b[:, 4] - jb[:, 4])
                near = np.abs(b[:, 4] - thresholds[c]) <= e
                assert not near.any(), (
                    f"{where}: scores within rounding of the threshold "
                    f"{b[near, 4]}")
                checked += 1
    return checked


def record_host_nms(monkeypatch):
    """Record the boxes that enter every host NMS of both packages' host
    cascades (``detect/pipeline.py``): returns ``(port, jax)`` lists of
    ``(threshold, method, boxes [N, 5+])``, one entry a call in call
    order."""
    from improving_face_recognition_performance_using_triplet_loss_tpu.detect import (
        pipeline as jpipeline,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        pipeline as tpipeline,
    )

    sides = ([], [])
    for module, calls in zip((tpipeline, jpipeline), sides):
        def nms(boxes, threshold, method="Union", real=module.nms,
                calls=calls):
            calls.append((threshold, method, np.array(boxes, np.float64)))
            return real(boxes, threshold, method)
        monkeypatch.setattr(module, "nms", nms)
    return sides


def assert_host_nms_margins(port, jax_calls):
    """Hold the host NMS inputs :func:`record_host_nms` recorded (the same
    images through both cascades) to the margins that keep rounding from
    deciding them: the same calls, each over the same candidates (boxes
    within 1e-3), and no two candidates with different boxes within their
    own rounding of each other (:func:`rounding_ties`). A threshold that
    rounding decides shows as candidate sets that differ, named."""
    assert len(port) == len(jax_calls), (len(port), len(jax_calls))
    for k, ((th, m, b), (jth, jm, jb)) in enumerate(zip(port, jax_calls)):
        assert (th, m) == (jth, jm), k
        assert b.shape == jb.shape, f"NMS {k}: {b.shape} != {jb.shape}"
        np.testing.assert_allclose(b[:, :4], jb[:, :4], atol=1e-3,
                                   err_msg=f"NMS {k}")
        ties = rounding_ties(b[:, 4], jb[:, 4], b[:, :4])
        assert not ties, f"NMS {k}: rounding ties {ties[:5]}"


def assert_face_rank_margins(boxes, other, frame_h: int, frame_w: int):
    """The largest-centered face (``area - 2 * center offset^2``, the pick
    of ``select_main_face`` and of the single-face pipelines) among
    ``boxes`` ``[N, >=4]`` leads the runner-up by more than the two sides'
    box rounding (``other``: the same boxes from the other side) can move
    the two ranks."""
    b = np.asarray(boxes, np.float64)
    if len(b) < 2:
        return
    err = np.abs(b[:, :4] - np.asarray(other, np.float64)[:, :4]).max(1)
    w, h = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
    cx = (b[:, 0] + b[:, 2]) / 2 - frame_w / 2
    cy = (b[:, 1] + b[:, 3]) / 2 - frame_h / 2
    rank = w * h - 2 * (cx * cx + cy * cy)
    # |d rank| <= (|w| + |h| + 2 |cx| + 2 |cy|) * 2 err for each box
    room = (np.abs(w) + np.abs(h) + 2 * np.abs(cx) + 2 * np.abs(cy)) \
        * 2 * err
    top = np.argsort(-rank)[:2]
    assert rank[top[0]] - rank[top[1]] > room[top].sum(), (
        f"the largest-centered face within rounding of the next: ranks "
        f"{rank[top]}")


def assert_largest_face_margins(port, jax_calls, frames: int, frame_h: int,
                                frame_w: int):
    """The pick of the single-face pipelines, the largest-centered face
    (``area - 2 * center offset^2`` over the kept final detections), leads
    the runner-up in every frame by more than the rounding of their boxes
    (the two sides' difference) can move the two ranks. ``port`` and
    ``jax_calls`` are :func:`record_cascade_nms`'s lists of one cascade run
    of ``frames`` frames on each side; the last NMS of a frame is the
    final one."""
    calls = len(port)
    _, _, boxes, keep = port[-1]
    for f in range(frames):
        jb = np.asarray(jax_calls[(f + 1) * calls - 1][2])
        kept = keep[f] & np.isfinite(boxes[f, :, 4])
        assert_face_rank_margins(boxes[f][kept], jb[kept], frame_h, frame_w)


def assert_gallery_margins(emb, other, rows_n, rows=None):
    """Rounding cannot change the gallery match of embeddings ``emb``
    ``[N, D]`` (one side's) against ``other`` (the other side's). An int8
    gallery (``rows_n`` int8): both sides narrow the embeddings to the same
    codes (:func:`int8_margins`), so their integer products are equal.
    Other stored rows: each best row leads the next by more than the two
    sides' similarities differ (:func:`argmax_margins`), over the first
    ``rows`` rows when given."""
    emb, other = np.asarray(emb, np.float64), np.asarray(other, np.float64)
    rows_n = np.asarray(rows_n)
    if rows_n.dtype == np.int8:
        assert int8_margins(emb, other) > 0
        return
    g = rows_n.astype(np.float64)
    sims, osims = emb @ g.T, other @ g.T
    valid = None if rows is None else np.arange(len(g)) < rows
    assert np.all(argmax_margins(sims, sims - osims, valid=valid) > 0)


def unit_rows(x):
    """float64 L2-normalized rows."""
    x = np.asarray(x, np.float64)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def assert_match_margins(probes, rows, sim_th: float, err: float,
                         owners=None, subsets: bool = False):
    """A rounding of up to ``err`` in a similarity cannot change whom each
    of ``probes`` matches among the stored ``rows``, nor whether it clears
    ``sim_th``. Every similarity (float64) lies more than ``err`` from
    ``sim_th``, and of those above ``sim_th - err``, grouped by ``owners``
    (one owner a row unless given, as when a match reports the row), the
    best owner leads the next by more than ``2 err``. ``subsets``: the
    gallery holds any subset of ``rows`` over time, so any two such
    similarities of different owners lie more than ``2 err`` apart (a
    subset's top two are always such a pair, or one owner's)."""
    sims = unit_rows(probes) @ np.asarray(rows, np.float64).T
    assert np.abs(sims - sim_th).min() > err
    owners = np.arange(sims.shape[1]) if owners is None else np.asarray(
        owners)
    other = owners[:, None] != owners[None]
    for s in sims:
        live = s > sim_th - err
        if subsets:
            gap = np.abs(s[live][:, None] - s[live][None])
            assert not (other[live][:, live] & (gap <= 2 * err)).any(), \
                s[live]
            continue
        best = np.sort([s[live & (owners == o)].max()
                        for o in np.unique(owners[live])])[::-1]
        assert len(best) < 2 or best[0] - best[1] > 2 * err, best[:2]


def rounding_ties(scores, other, boxes=None):
    """The pairs of candidates whose order float rounding may decide.

    ``scores`` and ``other`` are the two sides' float scores of the same
    candidates (the same boxes in the same order). A candidate's rounding
    is its own difference between the sides, so a pair may swap when its
    gap is no more than the sum of the two: ``|s_i - s_j| <= |e_i| +
    |e_j|`` (an exact tie counts). Pairs with equal ``boxes`` rows are
    skipped: whichever comes first, the same box is kept. Returns
    ``[(i, j)]`` with ``i < j``."""
    s = np.asarray(scores, np.float64)
    e = np.abs(s - np.asarray(other, np.float64))
    gap = np.abs(s[:, None] - s[None])
    tie = gap <= e[:, None] + e[None]
    if boxes is not None:
        bx = np.asarray(boxes)
        tie &= ~np.all(bx[:, None] == bx[None], axis=-1)
    i, j = np.nonzero(np.triu(tie, 1))
    return list(zip(i.tolist(), j.tolist()))


def overlap_margins(boxes, threshold: float, method: str = "Union"):
    """The least distance from ``threshold`` of the overlap of any two of
    the ``[N, >=4]`` boxes ``x1 y1 x2 y2`` (the invalid rows too), in
    float64 with the NMS's ``+ 1`` pixel convention: ``Union`` is IoU,
    ``Min`` the intersection over the smaller area. A greedy NMS whose
    overlaps all clear the threshold by more than rounding keeps the same
    boxes whatever the rounding of its overlap."""
    b = np.asarray(boxes, np.float64)
    with np.errstate(invalid="ignore"):
        return _overlap_margin(b, threshold, method)


def _overlap_margin(b, threshold, method):
    if len(b) < 2:
        return np.inf
    x1, y1, x2, y2 = (b[:, k] for k in range(4))
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    w = np.maximum(0.0, np.minimum(x2[:, None], x2[None])
                   - np.maximum(x1[:, None], x1[None]) + 1)
    h = np.maximum(0.0, np.minimum(y2[:, None], y2[None])
                   - np.maximum(y1[:, None], y1[None]) + 1)
    inter = w * h
    if method == "Min":
        o = inter / np.minimum(area[:, None], area[None])
    else:
        o = inter / (area[:, None] + area[None] - inter)
    i, j = np.triu_indices(len(b), 1)
    gap = np.abs(o[i, j] - threshold)
    # a NaN overlap (a NaN coordinate) compares false on every side
    gap = gap[np.isfinite(gap)]
    return float(gap.min()) if gap.size else np.inf


def argmax_margins(values, err, valid=None):
    """Per row of ``values`` ``[R, C]`` (or of a ``[C]`` vector), the gap
    between the largest entry and the runner-up, less the most rounding
    may move the two: ``err`` is one bound for every entry, or each
    entry's own (the two sides' difference, ``[R, C]``). A row whose
    argmax rounding cannot decide has a positive margin. ``valid`` masks
    out entries the decision never sees (as ``rows`` masks a gallery's
    padding); a row with one valid entry gets +inf."""
    v = np.atleast_2d(np.asarray(values, np.float64))
    e = np.broadcast_to(np.abs(np.asarray(err, np.float64)), v.shape)
    if valid is not None:
        v = np.where(np.broadcast_to(valid, v.shape), v, -np.inf)
    if v.shape[1] < 2:
        return np.full(len(v), np.inf)
    top = np.argsort(-v, axis=1, kind="stable")[:, :2]
    rows = np.arange(len(v))[:, None]
    first, second = v[rows, top].T
    room = e[rows, top].sum(1)
    with np.errstate(invalid="ignore"):
        return np.where(np.isinf(second), np.inf, first - second - room)


def int8_margins(emb, other):
    """The least distance, over the entries of ``emb``, of ``127 x`` from
    the nearest half-integer (where the int8 narrowing of a probe rounds
    the other way), less the entry's own rounding (its difference from
    ``other`` times 127). Positive: both sides narrow the probes to the
    same int8 codes, and an int8 gallery's integer products are then
    exact and equal."""
    x = np.asarray(emb, np.float64) * 127.0
    edge = np.abs(x - np.floor(x) - 0.5)
    room = np.abs(x - np.asarray(other, np.float64) * 127.0)
    return float((edge - room).min()) if x.size else np.inf
