"""Kernel B1 on the tensor cores (``csrc/mining.cu``) on the CPU, where it
cannot run: its 3xTF32 arithmetic and its index maps, held against the
plain version and the JAX oracle.

(a) A torch emulation of the kernel's arithmetic: each operand rounded to
TF32 with ``cvt.rna`` (round to nearest, ties away from zero, on the bit
pattern), hi = tf32(x), lo = tf32(x - hi), the dots as hi.lo + lo.hi +
hi.hi in float32 matmuls (TF32 off on the CPU), then the distance in the
kernel's order, ``max((a2 + p2) - 2 ap, 0)``.

(b) On integer rows the emulation's indices equal the plain version's; on
L2-normalized rows at 2048 x 4096 x 128 its picks meet the tolerance the
card's path check uses (``chip_smoke.py`` mining): pick distance within
1e-5 of the plain pick's (float64) and on the same side of pos_sq, unless
a negative lies within 1e-5 of pos_sq.

(c) One TF32 pass (hi only) fails that tolerance, so the check can tell a
one-pass kernel from a three-pass one.

(d) A numpy model of the kernel's tiling: anchor tiles of 128 rows as two
m64 warpgroups, pool tiles of 128 columns, the wgmma m64n128 accumulator
fragment map (warpgroup, lane, register) -> (anchor, pool row), each
thread's walk over its columns with strict comparisons, the quad merge,
the pool splits of ``mining_splits`` and the merge kernel. On tie-heavy
integer cases it reproduces the plain indices and the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.ops import (
    distances as jdist,
    mining as jmining,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
    distances as tdist,
    mining as tmining,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    mining as tkernel,
)

TB, TN, KC = 128, 128, 32   # csrc/mining.cu: anchors a CTA, pool tile, chunk
TOL = 1e-5                  # chip_smoke.py's path tolerance

T = torch.from_numpy


# ------------------------------------------------- (a) the arithmetic


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the bit pattern: add half of the 13 dropped
    bits' weight to the magnitude, then clear them (float32 sign-magnitude
    bits make the add round away from zero for either sign)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def dots_3xtf32(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The kernel's dots: hi.lo + lo.hi first, then hi.hi, in float32."""
    ah, al = split_tf32(a)
    ph, pl = split_tf32(p)
    return (ah @ pl.T + al @ ph.T) + ah @ ph.T


def dots_1xtf32(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """One TF32 pass: what a kernel without the lo terms computes."""
    return tf32_rna(a) @ tf32_rna(p).T


def emulated_pick(anc, pos_sq, al, pool, pl, dots=dots_3xtf32):
    """The kernel's indices under ``dots``: full-f32 norms, the distance in
    the kernel's order, the plain masked arg-reductions."""
    a2 = torch.sum(torch.square(anc), dim=1)
    p2 = torch.sum(torch.square(pool), dim=1)
    sq = torch.clamp_min((a2[:, None] + p2[None, :]) - 2.0 * dots(anc, pool),
                         0.0)
    return tmining.mine_semi_hard_negative(sq, pos_sq, al, pl)


def test_tf32_rna_rounds_to_nearest_ties_away():
    one, half_ulp = 1.0, 2.0 ** -11          # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + half_ulp, -(one + half_ulp),
                      one + half_ulp - 2.0 ** -23, 3.0 * 2.0 ** -11 + one,
                      7.0, -1024.0, 0.0], dtype=torch.float32)
    want = [one + 2.0 ** -10, -(one + 2.0 ** -10), one,
            one + 2.0 ** -9, 7.0, -1024.0, 0.0]
    assert tf32_rna(x).tolist() == want
    rng = np.random.default_rng(0)
    v = T(rng.normal(size=4096).astype(np.float32))
    hi, lo = split_tf32(v)
    for h in (hi, lo):
        assert not (h.view(torch.int32) & 0x1FFF).any()
    # x - hi is exact in float32, and hi + lo leaves ~2^-22 of |x|
    assert torch.equal((v.double() - hi.double()).float(), v - hi)
    assert float(((v.double() - hi.double() - lo.double()).abs()
                  / v.double().abs()).max()) <= 2.0 ** -21
    # integers below 2^11 in magnitude: hi = x, lo = 0
    ints = torch.arange(-2047, 2048, dtype=torch.float32)
    hi, lo = split_tf32(ints)
    assert torch.equal(hi, ints) and not lo.any()


def _int_case(seed, b, n, d, ids, pos_sq=None, one_label=False):
    """Coordinates in {-1, 0, 1}: exact products and sums, many ties."""
    rng = np.random.default_rng(seed)
    anc = rng.integers(-1, 2, (b, d)).astype(np.float32)
    pool = rng.integers(-1, 2, (n, d)).astype(np.float32)
    ps = (rng.integers(0, 2 * d, b).astype(np.float32) if pos_sq is None
          else np.full(b, pos_sq, np.float32))
    al, pl = rng.integers(0, ids, b), rng.integers(0, ids, n)
    if one_label:
        al[:], pl[:] = 0, 0
    return anc, ps, al, pool, pl


@pytest.mark.parametrize("shape", [(64, 128, 32, 10), (300, 1001, 100, 50),
                                   (100, 2000, 160, 30)])
def test_3xtf32_indices_equal_plain_on_integer_rows(shape):
    """(b) Exact inputs: 3xTF32 dots equal the f32 ones, so do the picks."""
    x = [T(v) for v in _int_case(1, *shape)]
    a, p = x[0], x[3]
    torch.testing.assert_close(dots_3xtf32(a, p), a @ p.T, rtol=0, atol=0)
    want = tkernel.semi_hard_mining_plain(*x)
    np.testing.assert_array_equal(emulated_pick(*x).numpy(), want.numpy())


def _normalized_case(seed=0, b=2048, n=4096, d=128, ids=512):
    """L2-normalized random rows, as the head hands B1, with pos_sq where
    the negatives' distances are densest (~2 +- 0.18), so that near ties
    above pos_sq decide the picks."""
    rng = np.random.default_rng(seed)
    anc = tdist.l2_normalize(T(rng.normal(size=(b, d)).astype(np.float32)))
    pool = tdist.l2_normalize(T(rng.normal(size=(n, d)).astype(np.float32)))
    ps = T(rng.uniform(1.6, 2.2, b).astype(np.float32))
    return [anc, ps, T(rng.integers(0, ids, b)), pool,
            T(rng.integers(0, ids, n))]


def path_violations(x, got, want):
    """Anchors whose pick breaks chip_smoke.py's path check against the
    plain pick: distance (float64) more than 1e-5 away, or on the other
    side of pos_sq, unless a negative lies within 1e-5 of pos_sq."""
    anc, pos_sq, al, pool, pl = x
    a64, p64, ps = anc.double(), pool.double(), pos_sq.double()
    d_got = ((a64 - p64[got.long()]) ** 2).sum(1)
    d_want = ((a64 - p64[want.long()]) ** 2).sum(1)
    sq = tdist.pairwise_sq_l2(anc, pool)
    near = (((sq - pos_sq[:, None]).abs() < TOL)
            & (al[:, None] != pl[None, :])).any(1)
    side = (d_got > ps) != (d_want > ps)
    bad = (((d_got - d_want).abs() > TOL) | side) & ~near
    return int(bad.sum()), int((got != want).sum())


@pytest.fixture(scope="module")
def normalized():
    x = _normalized_case()
    return x, tkernel.semi_hard_mining_plain(*x)


def test_3xtf32_meets_the_path_tolerance(normalized):
    """(b) Three passes: every pick within the path check's tolerance."""
    x, want = normalized
    a, p = x[0], x[3]
    err = float((dots_3xtf32(a, p).double() - a.double() @ p.double().T)
                .abs().max())
    assert err < 1e-6
    bad, differ = path_violations(x, emulated_pick(*x), want)
    assert bad == 0, f"{bad} picks outside the tolerance ({differ} differ)"


def test_1xtf32_fails_the_path_tolerance(normalized):
    """(c) One pass (hi only) moves distances by ~1e-3 and fails the check
    on many anchors: the check catches a one-pass kernel."""
    x, want = normalized
    bad, differ = path_violations(x, emulated_pick(*x, dots=dots_1xtf32),
                                  want)
    assert bad > 20 and differ >= bad


# ------------------------------------------------ (d) the index model

# wgmma m64nNk8 accumulator: register r = 4 jb + 2 h + e of lane l in warp w
# holds row 16 w + l / 4 + 8 h, column 8 jb + 2 (l % 4) + e
_WG, _LT, _R = np.meshgrid(np.arange(2), np.arange(128), np.arange(64),
                           indexing="ij")
ROW = _WG * 64 + (_LT >> 5) * 16 + ((_LT & 31) >> 2) + 8 * ((_R >> 1) & 1)
COL = 8 * (_R >> 2) + 2 * (_LT & 3) + (_R & 1)


def test_fragment_map_covers_each_tile_entry_once():
    """Every (anchor, pool row) of a 128 x 128 tile sits in exactly one
    register of one thread; a thread's registers visit its columns in
    increasing order for each of its two rows; the 4 lanes of a quad hold
    the same rows."""
    flat = (ROW * TN + COL).ravel()
    assert np.array_equal(np.sort(flat), np.arange(TB * TN))
    for h in range(2):
        cols = COL[..., [r for r in range(64) if (r >> 1) & 1 == h]]
        assert (np.diff(cols, axis=-1) > 0).all()
    quad_rows = ROW[:, :, 0].reshape(2, 32, 4)
    assert (quad_rows == quad_rows[..., :1]).all()


def mining_splits(b, n, sms):
    """csrc/mining.cu::mining_splits."""
    row_tiles = -(-b // TB)
    tiles = -(-n // TN)
    splits = max(1, min(sms // row_tiles, tiles))
    per = -(-tiles // splits)
    return -(-tiles // per)


def _better_min(d, i, bd, bi):
    return (d < bd) | ((d == bd) & (i < bi))


def _better_max(d, i, bd, bi):
    return (d > bd) | ((d == bd) & (i < bi))


def kernel_model(anc, pos_sq, al, pool, pl, sms=132):
    """The kernel's tiling, fragment walk and merges in numpy float32, the
    tile products by the 3xTF32 emulation. [B] int32."""
    b, d = anc.shape
    n = pool.shape[0]
    dp = -(-d // KC) * KC
    none = np.iinfo(np.int32).max
    rows = -(-b // TB) * TB
    a = np.zeros((rows, dp), np.float32)
    a[:b, :d] = anc
    tiles = -(-n // TN)
    p = np.zeros((tiles * TN, dp), np.float32)
    p[:n, :d] = pool
    a2 = np.zeros(rows, np.float32)
    a2[:b] = (anc * anc).sum(1, dtype=np.float32)
    p2 = np.zeros(tiles * TN, np.float32)
    p2[:n] = (pool * pool).sum(1, dtype=np.float32)
    plp = np.zeros(tiles * TN, np.int64)
    plp[:n] = pl
    splits = mining_splits(b, n, sms)
    per = -(-tiles // splits)
    part = {k: np.zeros((splits, b), np.float32 if k[-1] == "d" else np.int64)
            for k in ("semi_d", "semi_i", "far_d", "far_i")}
    q = _LT[..., 0] & 3                                    # [2, 128]
    for i0 in range(0, rows, TB):
        r_idx = [i0 + ROW[..., 2 * h] for h in range(2)]   # [2, 128] each
        a2h = [a2[r] for r in r_idx]
        psh = [np.where(r < b, pos_sq[np.minimum(r, b - 1)], 0) for r in r_idx]
        alh = [np.where(r < b, al[np.minimum(r, b - 1)], 0) for r in r_idx]
        for s in range(splits):
            sd = [np.full((2, 128), np.inf, np.float32) for _ in range(2)]
            si = [np.full((2, 128), none) for _ in range(2)]
            fd = [np.full((2, 128), -np.inf, np.float32) for _ in range(2)]
            fi = [np.full((2, 128), none) for _ in range(2)]
            for t in range(s * per, min(tiles, s * per + per)):
                j0 = t * TN
                dots = dots_3xtf32(T(a[i0:i0 + TB]),
                                   T(p[j0:j0 + TN])).numpy()
                acc = dots[ROW, COL]                       # [2, 128, 64]
                for jb in range(TN // 8):
                    for e in range(2):
                        j = j0 + 8 * jb + 2 * q + e
                        for h in range(2):
                            dist = np.maximum(
                                (a2h[h] + p2[j]) - np.float32(2)
                                * acc[..., 4 * jb + 2 * h + e], 0)
                            ok = (j < n) & (plp[j] != alh[h])
                            semi = ok & (dist > psh[h]) & (dist < sd[h])
                            sd[h] = np.where(semi, dist, sd[h])
                            si[h] = np.where(semi, j, si[h])
                            far = ok & (dist > fd[h])
                            fd[h] = np.where(far, dist, fd[h])
                            fi[h] = np.where(far, j, fi[h])
            for h in range(2):
                for off in (1, 2):                         # the quad merge
                    lane = _LT[..., 0] ^ off
                    osd, osi = sd[h][:, lane[0]], si[h][:, lane[0]]
                    ofd, ofi = fd[h][:, lane[0]], fi[h][:, lane[0]]
                    take = _better_min(osd, osi, sd[h], si[h])
                    sd[h], si[h] = (np.where(take, osd, sd[h]),
                                    np.where(take, osi, si[h]))
                    take = _better_max(ofd, ofi, fd[h], fi[h])
                    fd[h], fi[h] = (np.where(take, ofd, fd[h]),
                                    np.where(take, ofi, fi[h]))
                write = (q == 0) & (r_idx[h] < b)
                rr = r_idx[h][write]
                part["semi_d"][s, rr] = sd[h][write]
                part["semi_i"][s, rr] = si[h][write]
                part["far_d"][s, rr] = fd[h][write]
                part["far_i"][s, rr] = fi[h][write]
    # the merge kernel
    sd, si = np.full(b, np.inf, np.float32), np.full(b, none)
    fd, fi = np.full(b, -np.inf, np.float32), np.full(b, none)
    for s in range(splits):
        take = _better_min(part["semi_d"][s], part["semi_i"][s], sd, si)
        sd, si = (np.where(take, part["semi_d"][s], sd),
                  np.where(take, part["semi_i"][s], si))
        take = _better_max(part["far_d"][s], part["far_i"][s], fd, fi)
        fd, fi = (np.where(take, part["far_d"][s], fd),
                  np.where(take, part["far_i"][s], fi))
    return np.where(si != none, si, np.where(fi != none, fi, 0)).astype(
        np.int32)


def _jax_pick(anc, ps, al, pool, pl):
    return np.asarray(jmining.mine_semi_hard_negative(
        jdist.pairwise_sq_l2(jnp.asarray(anc), jnp.asarray(pool)),
        jnp.asarray(ps), jnp.asarray(al), jnp.asarray(pl)))


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("case", [
    dict(b=200, n=700, d=40, ids=6),              # ragged B, N, D; ties
    dict(b=130, n=300, d=16, ids=4, pos_sq=1e6),  # every anchor falls back
    dict(b=40, n=260, d=8, ids=1, one_label=True),  # no negative: index 0
])
def test_kernel_model_matches_plain_and_jax(case, sms):
    """(d) The model of the tiles, fragments and merges picks the plain
    version's and the JAX package's indices on tie-heavy integer rows,
    with the pool split over 132 SMs' worth of ranges or in one range."""
    x = _int_case(2, **case)
    assert (mining_splits(case["b"], case["n"], sms) > 1) == (sms == 132)
    got = kernel_model(*x, sms=sms)
    want = tkernel.semi_hard_mining_plain(*[T(v) for v in x]).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _jax_pick(*x))
    anc, ps, al, pool, pl = x
    if case.get("one_label"):
        assert (got == 0).all()
    else:
        # the case really is tie-heavy: tied minima above pos_sq
        sq = tdist.pairwise_sq_l2(T(anc), T(pool)).numpy()
        semi = np.where((al[:, None] != pl[None, :]) & (sq > ps[:, None]),
                        sq, np.inf)
        tied = (semi == semi.min(1, keepdims=True)) & np.isfinite(semi)
        assert case.get("pos_sq") or (tied.sum(1) > 1).sum() > 20
