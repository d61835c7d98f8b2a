"""Numpy models of kernel B3's two instances (``csrc/stem.cu``).

f32 (``stem_kernel``): the persistent grid's walk (CTA c takes tiles c,
c + grid, ... of (b, 8x8 pooled pixels)), each tile's 20x20 window staged
in element pairs with a zero fill outside the image, the taps in the
shared-memory layout the inner loop reads ([25][G][slot]), and the thread
items (2 pooled pixels x 1 maxout group, item = tid + k x threads). The
model checks that every tile is taken once, that no read falls outside the
staged window or the image, that every output is written exactly once, and
that the values, summed in the kernel's order (taps row-major, then + bias;
without its FMA roundings), equal ``stem_conv_maxout_pool_plain`` within
1e-4.

bf16 (``stem_tc_kernel``): the same walk and window in bf16, the B operand
written to shared memory from the [25, C] taps and the bias (n8 chunk
MAXOUT gb + s holds the channels s G + 8 gb + n; rows 0..24 are the taps,
rows 25 and 26 the bias's hi and lo bf16 parts, the rest zero, as is every
column from G on) in the K-major core-matrix layout that the wgmma
descriptors read, the A fragments gathered from the window (column k =
16 ks + 8 h + 2 t + e is tap k, columns 25 and 26 are 1.0; rows ordered
(dy, s, dx)), each warp's 16 rows of a wgmma evaluated on the matrices
that its lanes' fragments and the descriptors make up, the sums rounded
to bf16 pairs, the register maxout, the pool over dy in registers and
over dx by the lane ^ 4 shuffle, and the stores: at the compiled width
(C=99/efm3) the staged output and its copy to device memory (16-byte runs
where a row is aligned), at widths read at run time straight to device
memory. It checks that the fragments make up the im2col product, that
every staged entry and every output is written once, and that the values
equal the plain version in bf16 within 1e-2.
"""

import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    stem as tstem,
)

TY = TX = 8
IH = IW = 2 * TY + 4
IWS = 24
F32_THREADS = {(3, 99): 352}   # the compiled width; else 256
TC_THREADS, TC_MT = 128, 4


def _inputs(seed, b, h, w, c):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, h, w)).astype(np.float32),
            (rng.normal(0, 0.2, (25, c))).astype(np.float32),
            rng.normal(0, 0.1, c).astype(np.float32))


def _tiles(B, H, W):
    Ho, Wo = H // 2, W // 2
    tiles_x, tiles_y = -(-Wo // TX), -(-Ho // TY)
    return Ho, Wo, tiles_x, tiles_y, B * tiles_y * tiles_x


def _walk(total, grid):
    """The persistent grid's tiles in the order each CTA takes them."""
    grid = min(grid, total)
    taken = np.zeros(total, int)
    for cta in range(grid):
        for tile in range(cta, total, grid):
            taken[tile] += 1
            yield tile
    assert (taken == 1).all()


def _stage_window(x, tile, tiles_x, tiles_y, H, W):
    """stage_window: pairs (r, c), c even, all in or all out; the padding
    columns 20..23 stay unstaged (NaN)."""
    win = np.full((IH, IWS), np.nan, np.float32)
    tx, rest = tile % tiles_x, tile // tiles_x
    ty, b = rest % tiles_y, rest // tiles_y
    iy0, ix0 = 2 * ty * TY - 2, 2 * tx * TX - 2
    for k in range(IH * (IW // 2)):
        r, c = k // (IW // 2), 2 * (k % (IW // 2))
        iy, ix = iy0 + r, ix0 + c
        if 0 <= iy < H and 0 <= ix < W:
            assert ix + 1 < W            # the pair's second element
            win[r, c:c + 2] = x[b, iy, ix:ix + 2]
        else:
            win[r, c:c + 2] = 0.0
    return win, b, ty * TY, tx * TX


def _plain(x, w, bias, maxout, dtype=torch.float32):
    c = w.shape[1]
    return tstem.stem_conv_maxout_pool_plain(
        torch.from_numpy(x)[..., None].to(dtype),
        torch.from_numpy(w.reshape(5, 5, 1, c)), torch.from_numpy(bias),
        maxout=maxout).float().numpy()


# ------------------------------------------------------------------ f32


def run_f32(x, w, bias, maxout, grid):
    B, H, W = x.shape
    C = w.shape[1]
    G = C // maxout
    cout = 2 * G if maxout == 3 else G
    threads = F32_THREADS.get((maxout, C), 256)
    slot = 4 if (maxout, C) == (3, 99) else maxout
    # ws[(tap G + g) slot + s] = w[tap, s G + g], as the CTA loads it
    ws = np.full(25 * G * slot, np.nan, np.float32)
    for k in range(25 * C):
        tap, ch = divmod(k, C)
        ws[(tap * G + ch % G) * slot + ch // G] = w[tap, ch]
    Ho, Wo, tiles_x, tiles_y, total = _tiles(B, H, W)
    out = np.zeros((B, Ho, Wo, cout), np.float32)
    writes = np.zeros(out.shape, int)
    items = np.arange((TY * TX // 2) * G)
    # each thread's items: tid, tid + threads, ...
    per_thread = np.bincount(items % threads, minlength=threads)
    for tile in _walk(total, grid):
        win, b, py0, px0 = _stage_window(x, tile, tiles_x, tiles_y, H, W)
        g, pp = items % G, items // G
        ty, tx2 = pp // (TX // 2), pp % (TX // 2)
        py, px = py0 + ty, px0 + 2 * tx2
        live = (py < Ho) & (px < Wo)
        g, ty, tx2, py, px = g[live], ty[live], tx2[live], py[live], px[live]
        rows = 2 * ty[:, None] + np.arange(6)[None]
        cols = 4 * tx2[:, None] + np.arange(8)[None]
        assert rows.max() < IH and cols.max() < IW
        v = win[rows[:, :, None], cols[:, None, :]]          # [items, 6, 8]
        assert not np.isnan(v).any()
        acc = np.zeros((g.size, 2, maxout, 4), np.float32)
        for di in range(5):
            for dj in range(5):
                base = ((di * 5 + dj) * G + g) * slot
                wv = np.stack([ws[base + s] for s in range(maxout)], 1)
                assert not np.isnan(wv).any()
                for q in range(2):
                    c0 = 2 * q + dj
                    ph = np.stack([v[:, di, c0], v[:, di, c0 + 1],
                                   v[:, di + 1, c0], v[:, di + 1, c0 + 1]], 1)
                    acc[:, q] += ph[:, None, :] * wv[:, :, None]
        bv = np.stack([bias[s * G + g] for s in range(maxout)], 1)
        ph = acc + bv[:, None, :, None]                       # [i, q, s, f]
        mx = ph.max(axis=(2, 3))
        mn = ph.min(axis=2).max(axis=2)
        for q in range(2):
            ok = px + q < Wo
            sel = (b, py[ok], px[ok] + q)
            out[sel + (g[ok],)] = mx[ok, q]
            np.add.at(writes, sel + (g[ok],), 1)
            if maxout == 3:
                out[sel + (G + g[ok],)] = mn[ok, q]
                np.add.at(writes, sel + (G + g[ok],), 1)
    return out, writes, per_thread


F32_CASES = [(3, 99, 1, 16, 16), (3, 99, 2, 30, 46), (2, 96, 1, 16, 16),
             (2, 96, 2, 30, 46), (3, 63, 2, 30, 46), (2, 48, 3, 12, 20)]


@pytest.mark.parametrize("maxout,c,b,h,w", F32_CASES)
@pytest.mark.parametrize("grid", [264, 5])
def test_f32_schedule_writes_each_output_once(maxout, c, b, h, w, grid):
    x, wk, bias = _inputs(maxout * 1000 + c + h, b, h, w, c)
    out, writes, _ = run_f32(x, wk, bias, maxout, grid)
    assert (writes == 1).all()
    np.testing.assert_allclose(out, _plain(x, wk, bias, maxout),
                               rtol=1e-4, atol=1e-4)


def test_f32_items_fill_the_block_at_the_compiled_widths():
    """C=99/efm3 (compiled): 1,056 items on 352 threads; LightCNN9's
    C=96/mfm2 (read at run time): 1,536 on 256; no thread idles."""
    for (maxout, c), threads in {**F32_THREADS, (2, 96): 256}.items():
        items = (TY * TX // 2) * (c // maxout)
        assert items % threads == 0
        x, wk, bias = _inputs(0, 1, 16, 16, c)
        _, _, per_thread = run_f32(x, wk, bias, maxout, 1)
        assert (per_thread == items // threads).all()


# ----------------------------------------------------------------- bf16


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16(
        ).float().numpy()


def _lanes():
    lane = np.arange(32)
    return lane >> 2, lane & 3          # gq (the groupID), t


B_LBO, B_SBO = 128, 256


def b_smem(w, bias, maxout):
    """B as the CTA writes it to shared memory: bf16 values by byte offset
    / 2, word kp of column n of step ks (rows 16 ks + 2 kp, + 1) at byte
    ((ks NT + n / 8) 2 + kp / 4) 128 + (n % 8) 16 + (kp % 4) 4."""
    C = w.shape[1]
    hi = _bf16(bias)
    rows = np.concatenate([w, hi[None], _bf16(bias - hi)[None],
                           np.zeros((5, C), np.float32)])       # [32, C]
    G = C // maxout
    NT = maxout * -(-G // 8)
    sm = np.full(2 * NT * B_SBO // 2, np.nan, np.float32)
    for i in range(2 * NT * 64):
        kp, n, ks = i % 8, (i // 8) % (8 * NT), i // (64 * NT)
        nt = n // 8
        gg = 8 * (nt // maxout) + n % 8
        ch = (nt % maxout) * G + gg
        k = 16 * ks + 2 * kp
        byte = ((ks * NT + nt) * 2 + kp // 4) * 128 + (n % 8) * 16 + (kp % 4) * 4
        assert np.isnan(sm[byte // 2:byte // 2 + 2]).all()   # written once
        sm[byte // 2:byte // 2 + 2] = rows[k:k + 2, ch] if gg < G else 0.0
    return sm, NT


def b_matrix(sm, start):
    """The 16 x 8 B of the n8 chunk whose descriptor starts at byte
    `start`, read as wgmma reads a K-major layout without swizzle: row k
    of column c at start + (k / 8) LBO + c 16 + (k % 8) 2."""
    B = np.zeros((16, 8), np.float32)
    for k in range(16):
        for c in range(8):
            B[k, c] = sm[(start + (k // 8) * B_LBO + c * 16 + (k % 8) * 2) // 2]
    return B


def pixel_of(warp, i):
    """Each lane's pooled pixel (in the tile, row-major) in m16 tile i:
    tile column 2 warp + i / 2, row 4 (i % 2) + gq / 2."""
    gq, _ = _lanes()
    return (4 * (i & 1) + (gq >> 1)) * TX + 2 * warp + (i >> 1)


def a_fragments(win, warp, i):
    """a[ks][reg] = (lo, hi) for every lane, gathered as the kernel does."""
    gq, t = _lanes()
    dx = gq & 1
    p = pixel_of(warp, i)
    r0 = 2 * (p // TX) * IWS + 2 * (p % TX) + dx
    flat = win.reshape(-1)
    a = np.zeros((2, 4, 2, 32), np.float32)
    for ks in range(2):
        for h in range(2):
            for dy in range(2):
                for e in range(2):
                    k = 16 * ks + 8 * h + 2 * t + e
                    off = np.where(k < 25, (k // 5) * IWS + k % 5, 0)
                    r = r0 + dy * IWS + off
                    # no read outside the staged part of the window
                    assert (r // IWS < IH).all() and (r % IWS < IW).all()
                    val = flat[r]
                    assert not np.isnan(val).any()
                    a[ks, 2 * h + dy, e] = np.where(
                        k < 25, val, np.where((k == 25) | (k == 26), 1.0, 0.0))
    return a


def a_matrix(a_ks):
    """The 16x16 A that the lanes' fragments make up (a0: row gq, cols 2t,
    2t+1; a1: row gq+8; a2: row gq, cols 2t+8, 2t+9; a3: row gq+8)."""
    gq, t = _lanes()
    A = np.full((16, 16), np.nan, np.float32)
    for reg in range(4):
        row = gq + 8 * (reg & 1)
        for e in range(2):
            A[row, 2 * t + 8 * (reg >> 1) + e] = a_ks[reg, e]
    return A


def c_fragments(D):
    """c[lane][4] from the 16x8 D (c0, c1: row gq, cols 2t, 2t+1; c2, c3:
    row gq+8)."""
    gq, t = _lanes()
    return np.stack([D[gq, 2 * t], D[gq, 2 * t + 1],
                     D[gq + 8, 2 * t], D[gq + 8, 2 * t + 1]], 1)


def run_tc(x, w, bias, maxout, grid, compiled=None):
    """The kernel's instance compiled for C=99/efm3 (``compiled``: by
    default where the width is that one) stages each tile's output and
    copies it out; the instance that reads its width at run time stores
    straight to device memory."""
    B, H, W = x.shape
    C = w.shape[1]
    if compiled is None:
        compiled = (maxout, C) == (3, 99)
    G = C // maxout
    GB = -(-G // 8)
    NT = maxout * GB
    cout = 2 * G if maxout == 3 else G
    xb, wb = _bf16(x), _bf16(w)
    sm, nt_ = b_smem(wb, bias, maxout)
    assert nt_ == NT and not np.isnan(sm).any()
    bias_rows = np.stack([_bf16(bias), _bf16(bias - _bf16(bias))])
    # the compiled width takes all NT chunks in one wgmma, the others one
    # group of 8 channels (MAXOUT chunks) a wgmma: chunk j of a wgmma
    # starting at chunk c0 is read at (ks NT + c0) SBO + j SBO
    nch = NT if compiled else maxout
    Bm = np.zeros((2, NT, 16, 8), np.float32)
    for ks in range(2):
        for c0 in range(0, NT, nch):
            for j in range(nch):
                Bm[ks, c0 + j] = b_matrix(sm, (ks * NT + c0) * B_SBO
                                          + j * B_SBO)
    # column n of n8 tile MAXOUT gb + s is channel s G + 8 gb + n
    for nt in range(NT):
        gb, s = divmod(nt, maxout)
        for n in range(8):
            gg = 8 * gb + n
            col = np.concatenate([Bm[0, nt, :, n], Bm[1, nt, :, n]])
            want = (np.concatenate([wb[:, s * G + gg],
                                    bias_rows[:, s * G + gg], np.zeros(5)])
                    if gg < G else np.zeros(32))
            np.testing.assert_array_equal(col, want)
    Ho, Wo, tiles_x, tiles_y, total = _tiles(B, H, W)
    out = np.zeros((B, Ho, Wo, cout), np.float32)
    writes = np.zeros(out.shape, int)
    gq, t = _lanes()
    dx = gq & 1
    carry = np.zeros(32)
    for tile in _walk(total, grid):
        win, b, py0, px0 = _stage_window(xb, tile, tiles_x, tiles_y, H, W)
        stg = np.full((TY * TX, cout), np.nan, np.float32)
        stg_writes = np.zeros(stg.shape, int)
        for warp in range(TC_THREADS // 32):
            for i in range(TC_MT):
                a = a_fragments(win, warp, i)
                p_lane = pixel_of(warp, i)
                Am = np.concatenate([a_matrix(a[0]), a_matrix(a[1])], 1)
                # row r = 8 dy + 2 s + dx is conv position (2 ty + dy,
                # 2 tx + dx) of pixel s: the im2col row of its 25 taps
                for r in range(16):
                    dy, s, dxr = r >> 3, (r & 7) >> 1, r & 1
                    p = p_lane[2 * s * 4]          # lane gq = 2 s, t = 0
                    cy, cx = 2 * (p // TX) + dy, 2 * (p % TX) + dxr
                    want = np.concatenate(
                        [win[cy:cy + 5, cx:cx + 5].reshape(25), [1.0, 1.0],
                         np.zeros(5)])
                    np.testing.assert_array_equal(Am[r], want)
                for gb in range(GB):
                    g0 = 8 * gb + 2 * t
                    acc = np.zeros((maxout, 32, 4), np.float32)
                    for s in range(maxout):
                        for ks in range(2):
                            acc[s] += c_fragments(
                                Am[:, 16 * ks:16 * ks + 16]
                                @ Bm[ks, gb * maxout + s])
                    acc = _bf16(acc)   # the bf16 pairs of the epilogue
                    mxs, mns = np.zeros((2, 32)), np.zeros((2, 32))
                    for e in range(2):
                        mx = np.full(32, -np.inf, np.float32)
                        mn = np.full(32, -np.inf, np.float32)
                        for dy in range(2):
                            vals = acc[:, :, 2 * dy + e]           # [s, lane]
                            mx = np.maximum(mx, vals.max(0))
                            mn = np.maximum(mn, vals.min(0))
                        mxs[e] = np.maximum(mx, mx[np.arange(32) ^ 4])
                        mns[e] = np.maximum(mn, mn[np.arange(32) ^ 4])
                    if compiled:
                        carry = _compiled_stores(stg, stg_writes, g0, dx,
                                                 t, p_lane, mxs, mns, carry,
                                                 G, cout, maxout)
                        continue
                    for e in range(2):
                        g = g0 + e
                        for lane in range(32):
                            if g[lane] >= G or (maxout == 2 and dx[lane]):
                                continue
                            c = G + g[lane] if dx[lane] else g[lane]
                            v = mns[e, lane] if dx[lane] else mxs[e, lane]
                            p = p_lane[lane]
                            py, px = py0 + p // TX, px0 + p % TX
                            if py < Ho and px < Wo:
                                out[b, py, px, c] = v
                                writes[b, py, px, c] += 1
        if not compiled:
            continue
        if maxout == 3:
            # the word (-1, 0) of the min half lands on the max of channel
            # G - 1 first; that channel's own (later) store leaves it right
            assert (stg_writes[:, G - 1] == 2).all()
            stg_writes[:, G - 1] = 1
        assert (stg_writes == 1).all()
        npx, nrow = min(TX, Wo - px0), min(TY, Ho - py0)
        if npx == TX and (Wo * cout) % 8 == 0:
            # 16-byte runs: each row's npx x cout elements start aligned
            assert (((b * Ho + py0) * Wo + px0) * cout) % 8 == 0
            assert (TX * cout) % 8 == 0
        for r in range(nrow):
            out[b, py0 + r, px0:px0 + npx] = stg[r * TX:r * TX + npx]
            writes[b, py0 + r, px0:px0 + npx] += 1
    return _bf16(out), writes


def _compiled_stores(stg, stg_writes, g0, dx, t, p, mxs, mns, carry, G,
                     cout, maxout):
    """The compiled width's stores of one (gb, m16 tile), one aligned word
    a lane: the max pair (g0, g0 + 1) from lanes dx = 0; for efm3 (G odd)
    the min word (g0 - 1, g0) from lanes dx = 1, channel g0 - 1 shuffled
    from lane t - 1 (for t = 0 from lane t = 3's value of the group
    before, `carry`). Returns the new carry."""
    lane = np.arange(32)
    prev = np.where(t == 3, carry, mns[1])[np.where(t == 0, lane + 3,
                                                     lane - 1)]
    word_at = p * cout + np.where(dx == 1, G - 1 + g0, g0)
    live = np.where(dx == 1, (maxout == 3) & (g0 < G), g0 + 1 < G)
    assert (word_at[live] % 2 == 0).all()         # 4-byte aligned
    _check_banks(word_at, dx, live)
    for ln in range(32):
        if live[ln]:
            vals = (prev[ln], mns[0, ln]) if dx[ln] else (mxs[0, ln],
                                                          mxs[1, ln])
            for k in range(2):
                pix, c = divmod(word_at[ln] + k, cout)
                stg[pix, c] = vals[k]
                stg_writes[pix, c] += 1
        elif not dx[ln] and g0[ln] < G:          # the last channel alone
            stg[p[ln], g0[ln]] = mxs[0, ln]
            stg_writes[p[ln], g0[ln]] += 1
    return mns[1]


def _check_banks(elem, dx, live):
    """The staging stores of one (gb, m16 tile), by lanes dx = 0 and by
    lanes dx = 1 (first and second element), each touch distinct banks or
    the same word."""
    for lanes in (live & (dx == 0), live & (dx == 1)):
        for half in range(2):
            words = (elem[lanes] + half) // 2
            banks = {}
            for wd in np.unique(words):
                assert banks.setdefault(wd % 32, wd) == wd, "bank conflict"


TC_CASES = [(3, 99, 1, 16, 16), (3, 99, 2, 30, 46), (2, 96, 1, 16, 16),
            (2, 96, 1, 30, 46), (3, 63, 1, 12, 20)]


@pytest.mark.parametrize("maxout,c,b,h,w", TC_CASES)
def test_tc_fragments_and_writes(maxout, c, b, h, w):
    x, wk, bias = _inputs(maxout * 100 + c + w, b, h, w, c)
    out, writes = run_tc(x, wk, bias, maxout, grid=3)
    assert (writes == 1).all()
    np.testing.assert_allclose(out, _plain(x, wk, bias, maxout,
                                           torch.bfloat16),
                               rtol=1e-2, atol=1e-2)


def test_tc_step_spreads_the_staging_banks():
    """An m16 tile's 4 pixels lie a tile row apart: at the compiled width
    (66 bf16 a pixel) their staged outputs start 8, 16 and 24 banks from
    the first, so no two of the 4 share a bank."""
    gq, _ = _lanes()
    for warp in range(TC_THREADS // 32):
        for i in range(TC_MT):
            p = pixel_of(warp, i)
            assert (np.diff(p[::8]) == TX).all()
            banks = p[::8] * 66 // 2 % 32
            assert sorted((banks - banks[0]) % 32) == [0, 8, 16, 24]


def test_tc_unstaged_stores():
    """The instance that reads its width at run time stores straight to
    device memory: at C=99 too (as the runtime_widths ablation runs it),
    each output once, the same values."""
    x, wk, bias = _inputs(5, 1, 12, 20, 99)
    out, writes = run_tc(x, wk, bias, 3, grid=2, compiled=False)
    assert (writes == 1).all()
    np.testing.assert_allclose(out, _plain(x, wk, bias, 3, torch.bfloat16),
                               rtol=1e-2, atol=1e-2)


def test_tc_k_order_taps_then_bias_then_zeros():
    """K: the 25 taps row-major, the bias's hi and lo parts, 5 zero
    columns; each lane's 8 A values of a k16 step are columns 16 ks + 8 h
    + 2 t + e; B's first chunk read through its descriptor holds them."""
    gq, t = _lanes()
    ks_cols = sorted({16 * ks + 8 * h + 2 * int(tt) + e
                      for ks in range(2) for h in range(2)
                      for tt in t for e in range(2)})
    assert ks_cols == list(range(32))
    wk = np.arange(25 * 99, dtype=np.float32).reshape(25, 99)
    bias = np.linspace(-1, 1, 99).astype(np.float32)
    sm, NT = b_smem(wk, bias, 3)
    for ks in range(2):
        Bm = b_matrix(sm, ks * NT * B_SBO)
        for k in range(16):
            tap = 16 * ks + k
            want = (wk[tap, :8] if tap < 25 else _bf16(bias[:8]) if tap == 25
                    else _bf16(bias[:8] - _bf16(bias[:8])) if tap == 26
                    else np.zeros(8))
            np.testing.assert_array_equal(Bm[k], want)
    # hi + lo carries the bias to ~2^-17 of it
    hi = _bf16(bias)
    np.testing.assert_allclose(hi + _bf16(bias - hi), bias, rtol=2 ** -15,
                               atol=0)
