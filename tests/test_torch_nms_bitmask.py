"""A numpy model of kernel B5 (``csrc/nms.cu``), held to the JAX package.

The model does what the kernel does, step by step: the 64-bit sort keys
(scores with -0.0 made +0.0, non-finite scores last, ties to the highest
original row) through the kernel's bitonic network, the all-pairs
suppression bitmask in 64-bit words built only where the kernel builds it,
and the one-warp sweep with the words spread over 32 lanes, per 64-row
block (the owner lane's serial pass, then every lane's OR of the kept
rows' words). Words the kernel never writes or stages hold all-ones
garbage, so a read of one would change the mask. Above the shared-memory
size the sweep reads the mask through the two staging buffers of the
global-scratch mode. The masks must equal ``nms_mask_plain``, the JAX
``nms_mask_jax`` and ``nms_mask_pallas_batched(interpret=True)`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import improving_face_recognition_performance_using_triplet_loss_tpu.ops.boxes as jboxes
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.pallas.nms_kernel import (
    nms_mask_pallas_batched,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
    boxes as tboxes,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    nms as tnms,
)
from _torch_ties import OVERLAP_EPS, overlap_margins
from test_torch_ops import _nms_cases, _soup

ALL = (1 << 64) - 1
SMEM_LIMIT = 232448   # csrc/nms.cu
THREADS = 1024


def _pow2(n):
    p = 1
    while p < n:
        p <<= 1
    return p


def _a16(b):
    return (b + 15) & ~15


def _layout(n):
    """csrc/nms.cu::layout_of: (P, W, WS, global mode, threads)."""
    p, w = _pow2(n), (n + 63) // 64
    ws = (w + 1) & ~1
    smem_mode = n * ws * 8 + _a16(p * 8) + n * 16 + _a16(n * 4) + 2 * w * 8
    glob = smem_mode > SMEM_LIMIT
    return p, w, ws, glob, THREADS


def _keys(scores, n, p):
    """sort_key: (~ordered(score)) << 32 | (n - 1 - row); non-finite high
    word all ones; padding all ones."""
    s = scores.astype(np.float32).copy()
    fin = np.isfinite(s)
    s[fin & (s == 0)] = np.float32(0.0)
    u = s.view(np.uint32).astype(np.uint64)
    u = np.where(u & np.uint64(0x80000000), ~u & np.uint64(0xFFFFFFFF),
                 u | np.uint64(0x80000000))
    hi = np.where(fin, ~u & np.uint64(0xFFFFFFFF), np.uint64(0xFFFFFFFF))
    keys = np.full(p, np.uint64(ALL), np.uint64)
    keys[:n] = (hi << np.uint64(32)) | (n - 1 - np.arange(n)).astype(
        np.uint64)
    return keys


def _smem_step(keys, k, j):
    """A shared-memory step: pair q -> (i, i + j), swapped unless in the
    run's order."""
    q = np.arange(keys.size // 2)
    i = ((q & ~(j - 1)) << 1) | (q & (j - 1))
    x, y = keys[i], keys[i + j]
    swap = (x > y) == ((i & k) == 0)
    keys[i], keys[i + j] = np.where(swap, y, x), np.where(swap, x, y)


def _lane_step(keys, k, j):
    """A register step (cmpx): element i takes the min of itself and its
    shuffle partner i ^ j when (i & j == 0) == (i & k == 0), else the
    max."""
    i = np.arange(keys.size)
    y = keys[i ^ j]
    take_min = ((i & j) == 0) == ((i & k) == 0)
    keys[:] = np.where(take_min, np.minimum(keys, y), np.maximum(keys, y))


def _bitonic(keys):
    """The kernel's sort of Q = max(P, 32) keys (the ones past P all
    ones): every step k <= 32 in registers, then per k >= 64 the steps
    j >= 32 in shared memory and j < 32 in registers."""
    p = keys.size
    q = max(p, 32)
    work = np.full(q, np.uint64(ALL), np.uint64)
    work[:p] = keys
    for k in (2, 4, 8, 16, 32):
        j = k >> 1
        while j > 0:
            _lane_step(work, k, j)
            j >>= 1
    k = 64
    while k <= q:
        j = k >> 1
        while j >= 32:
            _smem_step(work, k, j)
            j >>= 1
        while j > 0:
            _lane_step(work, k, j)
            j >>= 1
        k <<= 1
    return work[:p]


def _suppress_rows(bx, area, rows, threshold, min_method):
    """[len(rows), n] bool: sorted row i suppresses sorted row j (float32,
    one rounding per operation, NaN-propagating max/min, the zero skip)."""
    f = np.float32
    bi, ai = bx[rows][:, None, :], area[rows][:, None]
    bj, aj = bx[None, :, :], area[None, :]
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        w = np.maximum(f(0), np.minimum(bi[..., 2], bj[..., 2])
                       - np.maximum(bi[..., 0], bj[..., 0]) + f(1))
        h = np.maximum(f(0), np.minimum(bi[..., 3], bj[..., 3])
                       - np.maximum(bi[..., 1], bj[..., 1]) + f(1))
        inter = w * h
        denom = np.minimum(ai, aj) if min_method else ai + aj - inter
        o = inter / denom
    out = (o > f(threshold)) & np.isfinite(o)
    if threshold >= 0:
        out &= ~(inter == 0)
    return out


def _build_mask(bx, area, valid, n, w, ws, threshold, min_method):
    """Words [n, WS] as Python ints; only valid rows i and words
    w >= i // 64 are built (bits j > i, j < n), the rest is garbage."""
    mask = [[ALL] * ws for _ in range(n)]
    rows = np.where(valid)[0]
    for c in range(0, rows.size, 256):
        chunk = rows[c:c + 256]
        sup = _suppress_rows(bx, area, chunk, threshold, min_method)
        sup &= np.arange(n)[None, :] > chunk[:, None]
        pad = np.zeros((chunk.size, 64 * w), bool)
        pad[:, :n] = sup
        words = np.packbits(pad.reshape(chunk.size, w, 64), axis=-1,
                            bitorder="little").view("<u8")[..., 0]
        for r, i in enumerate(chunk):
            for k in range(i // 64, w):
                mask[i][k] = int(words[r, k])
    return mask


def _stage(mask, b, n, ws):
    """stage_block: rows 64b.. of words (b & ~1)..WS, 16 bytes (two words)
    a copy; the rest of the buffer keeps garbage."""
    buf = [[ALL] * ws for _ in range(64)]
    rows, k0 = min(64, n - 64 * b), b & ~1
    pairs = (ws - k0) // 2
    for idx in range(rows * pairs):
        t, k = idx // pairs, k0 + 2 * (idx % pairs)
        buf[t][k], buf[t][k + 1] = mask[64 * b + t][k], mask[64 * b + t][k + 1]
    return buf


def _or_reduce(kw, rows, k):
    """Lane l contributes rows l and l + 32 of word k when kept; the two
    32-bit warp reductions give the OR."""
    m = [0] * 32
    for lane in range(32):
        for t in (lane, lane + 32):
            if (kw >> t) & 1:
                m[lane] |= rows[t][k]
    lo = hi = 0
    for v in m:
        lo, hi = lo | (v & 0xFFFFFFFF), hi | (v >> 32)
    return (hi << 32) | lo


def _sweep(mask, validw, n, w, ws, glob):
    slots = (w + 31) // 32
    rem = [[0] * slots for _ in range(32)]     # lane, slot -> word
    keepw = []
    for b in range(w):
        rows = _stage(mask, b, n, ws) if glob else mask[64 * b:64 * b + 64]
        # rows past n are not read (the kernel reads 0 for them)
        own = [rows[t] if 64 * b + t < n else [0] * ws for t in range(64)]
        cand = validw[b] & ~rem[b & 31][b >> 5] & ALL
        kw, steps = cand, 0
        while True:       # the fixed point from keep = cand
            new = cand & ~_or_reduce(kw, own, b) & ALL
            steps += 1
            if new == kw:
                break
            kw = new
        assert steps <= 66
        keepw.append(kw)
        for k in range(b + 1, w):
            rem[k & 31][k >> 5] |= _or_reduce(kw, own, k)
    return keepw


def model_keep_mask(boxes, threshold, method):
    """[S, n, 5] float32 -> [S, n] bool, as csrc/nms.cu computes it."""
    sets, n, _ = boxes.shape
    out = np.zeros((sets, n), bool)
    if n == 0:
        return out
    p, w, ws, glob, _ = _layout(n)
    for s in range(sets):
        b = boxes[s].astype(np.float32)
        keys = _bitonic(_keys(b[:, 4], n, p))
        np.testing.assert_array_equal(keys, np.sort(keys))
        order = (n - 1 - (keys[:n] & np.uint64(0xFFFFFFFF)).astype(
            np.int64))
        bx = b[order, :4]
        area = ((bx[:, 2] - bx[:, 0] + np.float32(1))
                * (bx[:, 3] - bx[:, 1] + np.float32(1)))
        valid = (keys[:n] >> np.uint64(32)) != np.uint64(0xFFFFFFFF)
        validw = [sum(1 << t for t in range(64)
                      if 64 * k + t < n and valid[64 * k + t])
                  for k in range(w)]
        mask = _build_mask(bx, area, valid, n, w, ws, threshold,
                           method == "Min")
        keepw = _sweep(mask, validw, n, w, ws, glob)
        for r in range(n):
            out[s, order[r]] = bool((keepw[r >> 6] >> (r & 63)) & 1)
    return out


def _signed_zero_cases(rng):
    """Scores of +-0.0 (and +-1e-30) that tie under torch.sort, among
    overlapping boxes, so the tie rule decides which one keeps."""
    b = np.stack([_soup(rng, 128) for _ in range(3)])
    z = rng.integers(0, 4, size=b.shape[:2])
    b[..., 4] = np.choose(z, [np.float32(0.0), np.float32(-0.0),
                              np.float32(1e-30), b[..., 4]])
    return b


def _nonfinite_cases(rng):
    b = np.stack([_soup(rng, 128) for _ in range(3)])
    u = rng.uniform(size=b.shape[:2])
    b[..., 4] = np.where(u < 0.15, np.nan, np.where(
        u < 0.3, np.inf, np.where(u < 0.4, -np.inf, b[..., 4])))
    return b


def _cases():
    rng = np.random.default_rng(11)
    cases = dict(_nms_cases())
    cases["signed_zero_ties"] = (0.5, "Union", _signed_zero_cases(rng))
    cases["nan_inf"] = (0.5, "Union", _nonfinite_cases(rng))
    cases["min_ties"] = (0.7, "Min", np.stack(
        [_soup(rng, 64, ties=True, invalid=0.1) for _ in range(2)]))
    # a cross-scale soup: 1,024 rows over a 240x320 frame at 0.7
    x1, y1 = rng.uniform(0, 300, 1024), rng.uniform(0, 220, 1024)
    side = 12 + rng.uniform(0, 90, 1024)
    s = rng.uniform(0, 1, 1024)
    s[rng.uniform(size=1024) < 0.3] = -np.inf
    cases["cross_scale_1024"] = (0.7, "Union", np.stack(
        [x1, y1, x1 + side, y1 + side * rng.uniform(0.8, 1.2, 1024),
         s], 1).astype(np.float32)[None])
    cases["chain_1024"] = (0.5, "Union",
                           tboxes.adversarial_nms_chain(1024)[None])
    return cases


@pytest.fixture(scope="module")
def results():
    """{case: (threshold, method, sets, model, jax fixed point, Pallas)};
    the JAX calls are grouped by (threshold, method, rows)."""
    cases = _cases()
    groups = {}
    for name, (th, m, sets) in cases.items():
        groups.setdefault((th, m, sets.shape[1]), []).append(name)
    out = {}
    for (th, m, _), names in groups.items():
        b = jnp.asarray(np.concatenate([cases[n][2] for n in names]))
        fixed = np.asarray(jax.jit(jax.vmap(
            lambda c, th=th, m=m: jboxes.nms_mask_jax(c, th, m)))(b))
        pallas = np.asarray(nms_mask_pallas_batched(b, th, m,
                                                    interpret=True))
        at = 0
        for n in names:
            k = cases[n][2].shape[0]
            out[n] = (th, m, cases[n][2],
                      model_keep_mask(cases[n][2], th, m),
                      fixed[at:at + k], pallas[at:at + k])
            at += k
    return out


CASES = ["per_scale", "cross_scale", "stage2", "stage3", "union", "min",
         "ties", "all_invalid", "chain", "signed_zero_ties", "nan_inf",
         "min_ties", "cross_scale_1024", "chain_1024"]


@pytest.mark.parametrize("case", CASES)
def test_model_matches_plain_jax_and_pallas(results, case):
    """Each side computes the overlaps of the same boxes in its own
    float32 order: none lies within ``OVERLAP_EPS`` of the threshold."""
    th, m, sets, model, fixed, pallas = results[case]
    assert min(overlap_margins(one, th, m) for one in sets) > OVERLAP_EPS
    plain = tnms.nms_mask_plain(torch.from_numpy(sets), th, m).numpy()
    np.testing.assert_array_equal(model, plain)
    np.testing.assert_array_equal(model, fixed)
    np.testing.assert_array_equal(model, pallas)


def test_model_chain_keeps_even_rows(results):
    model = results["chain_1024"][3][0]
    np.testing.assert_array_equal(np.where(model)[0], np.arange(0, 1024, 2))


def test_signed_zero_keys_tie_like_torch_sort():
    """-0.0 and +0.0 get one high word, so the row breaks the tie, as
    torch.sort(stable) on the negated reversed scores does (8 keys: the
    network runs on 32, the 24 past P all ones)."""
    s = np.array([0.0, -0.0, 0.5, -0.0, 0.0, -1.0], np.float32)
    keys = _bitonic(_keys(s, 6, 8))
    order = 5 - (keys[:6] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    want = tnms._score_order(torch.from_numpy(s)[None])[0].numpy()
    np.testing.assert_array_equal(order, want)


@pytest.mark.parametrize("n", [1, 2, 63, 64, 65, 1000, 1024, 1100, 2048,
                               4096, 11068])
def test_layout_and_schedule_cover_every_row(n):
    """Every valid row's mask words are built by exactly one (CTA rank,
    warp) of a cluster of 1-8; the staging copies stay inside the set's
    scratch rows and the buffer; the mode and shared memory fit, and the
    shared-memory mode's float4 boxes start on 16 bytes (one row too)."""
    p, w, ws, glob, threads = _layout(n)
    assert p >= n and 64 * w >= n and ws % 2 == 0
    assert glob or (n * ws * 8 + _a16(p * 8)) % 16 == 0
    assert (n > 1024) == glob or n == 1100 and not glob
    assert not glob or w <= 32 * 8
    nwarps = threads // 32
    for csize in (1, 2, 4, 8):
        seen = np.zeros(n, int)
        for rank in range(csize):
            for warp in range(nwarps):
                seen[np.arange(rank + csize * warp, n, csize * nwarps)] += 1
        assert (seen == 1).all()
    if glob:
        for b in range(w):
            rows, k0 = min(64, n - 64 * b), b & ~1
            pairs = (ws - k0) // 2
            last_t, last_k = rows - 1, k0 + 2 * (pairs - 1)
            assert (64 * b + last_t) * ws + last_k + 1 < n * ws
            assert last_t * ws + last_k + 1 < 64 * ws


def test_model_global_mode_at_2048_rows():
    """A 2,048-row set takes the global-scratch mode: the sweep reads the
    staged blocks, and the mask equals the plain version's."""
    rng = np.random.default_rng(3)
    b = np.stack([_soup(rng, 2048, invalid=0.2)])
    b[..., :4] *= 4
    assert _layout(2048)[3]
    assert overlap_margins(b[0], 0.5) > OVERLAP_EPS
    model = model_keep_mask(b, 0.5, "Union")
    plain = tnms.nms_mask_plain(torch.from_numpy(b), 0.5, "Union").numpy()
    np.testing.assert_array_equal(model, plain)
