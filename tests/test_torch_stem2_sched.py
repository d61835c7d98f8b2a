"""A numpy model of kernel B4's persistent schedule (``csrc/stem.cu``).

The model walks the kernel's grid as the kernel does: CTA c takes tiles
c, c + grid, ... of (b, 8x8 pooled pixels); each tile's 20x20 input window
is staged in element pairs with a zero fill outside the image; stage 1
gives a thread item 2 pooled pixels x 1 mfm2 pair of conv1, stage 2 4
pixels x 4 pairs of conv2a, with the weights in the shared-memory layouts
the kernel reads. It checks that every tile is taken once, that no read
falls outside the staged window or the image, that every stem-tile entry
and every output (b, py, px, j) is written exactly once, and that the
values so placed equal ``stem2_conv_plain`` (float32, 1e-4: the model sums
in the kernel's order without its FMA roundings).
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
THREADS = 192
C, C2 = 96, 96   # LightCNN9's conv1 and conv2a widths


def _params(rng):
    return (rng.normal(0, 0.1, (5, 5, 1, C)).astype(np.float32),
            rng.normal(0, 0.1, C).astype(np.float32),
            rng.normal(0, 0.1, (1, 1, C // 2, C2)).astype(np.float32),
            rng.normal(0, 0.1, C2).astype(np.float32))


def _stage_window(x, b, ty, tx, H, W):
    """stage_window: pairs (r, c), c even, all in or all out."""
    win = np.full((IH, IWS), np.nan, np.float32)   # unstaged: NaN
    iy0, ix0 = 2 * ty * TY - 2, 2 * tx * TX - 2
    for k in range(IH * (IW // 2)):
        r, c = k // (IW // 2), 2 * (k % (IW // 2))
        iy, ix = iy0 + r, ix0 + c
        inside = 0 <= iy < H and 0 <= ix < W
        assert c + 1 < IWS
        if inside:
            assert ix + 1 < W            # the pair's second element
            win[r, c:c + 2] = x[b, iy, ix:ix + 2]
        else:
            win[r, c:c + 2] = 0.0
    return win


def run_schedule(x, w, bias, w2, b2, grid):
    """The kernel's walk, with every write counted; returns (out,
    writes per output, tiles taken per tile)."""
    B, H, W = x.shape
    G, half2 = C // 2, C2 // 2
    Ho, Wo = H // 2, W // 2
    tiles_x, tiles_y = -(-Wo // TX), -(-Ho // TY)
    total = B * tiles_y * tiles_x
    # w1s[tap][g][s] = w[tap, s*G + g]; w2s[k][j][t] = w2[k, t*half2 + j]
    w1s = w.reshape(25, 2, G).transpose(0, 2, 1)
    w2s = w2.reshape(G, 2, half2).transpose(0, 2, 1).reshape(G, C2)
    out = np.zeros((B, Ho, Wo, half2), np.float32)
    writes = np.zeros(out.shape, int)
    taken = np.zeros(total, int)
    NJ = half2 // 4
    for cta in range(min(grid, total)):
        for tile in range(cta, total, min(grid, total)):
            taken[tile] += 1
            tx, rest = tile % tiles_x, tile // tiles_x
            ty, b = rest % tiles_y, rest // tiles_y
            win = _stage_window(x, b, ty, tx, H, W)
            # stage 1: item -> (g, ty_, tx2); reads rows 2ty_..+5, cols
            # 4tx2..+7 of the window
            item = np.arange((TY * TX // 2) * G)
            g, pp = item % G, item // G
            ty_, tx2 = pp // (TX // 2), pp % (TX // 2)
            rows = 2 * ty_[:, None] + np.arange(6)[None]
            cols = 4 * tx2[:, None] + np.arange(8)[None]
            assert rows.max() < IH and cols.max() < IW
            v = win[rows[:, :, None], cols[:, None, :]]      # [items, 6, 8]
            assert not np.isnan(v).any()
            st = np.full((G, TY * TX), np.nan, np.float32)
            st_writes = np.zeros(st.shape, int)
            for q in range(2):
                mx = np.full(item.size, -np.inf, np.float32)
                for s in range(2):
                    acc = np.zeros((item.size, 4), np.float32)
                    for di in range(5):
                        for dj in range(5):
                            wv = w1s[di * 5 + dj, g, s]
                            c0 = 2 * q + dj
                            acc[:, 0] += v[:, di, c0] * wv
                            acc[:, 1] += v[:, di, c0 + 1] * wv
                            acc[:, 2] += v[:, di + 1, c0] * wv
                            acc[:, 3] += v[:, di + 1, c0 + 1] * wv
                    mx = np.maximum(mx, (acc + bias[s * G + g][:, None]).max(1))
                p = ty_ * TX + 2 * tx2 + q
                st[g, p] = mx
                np.add.at(st_writes, (g, p), 1)
            assert (st_writes == 1).all()
            # stage 2: item -> (pg, jg), pixel groups fastest; 4 pixels x
            # 4 pairs
            item = np.arange((TY * TX // 4) * NJ)
            pg, jg = item % (TY * TX // 4), item // (TY * TX // 4)
            px4 = 4 * pg[:, None] + np.arange(4)[None]          # [items, 4]
            w8 = _w8(w2s, jg)                                    # [G, items, 8]
            y = np.zeros((item.size, 4, 8), np.float32)
            for k in range(G):                  # input channels ascending
                y += st[k][px4][:, :, None] * w8[k][:, None, :]
            j = 4 * jg[:, None] + np.arange(4)[None]             # [items, 4]
            o = np.maximum(y[:, :, 0::2] + b2[j][:, None, :],
                           y[:, :, 1::2] + b2[j + half2][:, None, :])
            py = ty * TY + px4 // TX
            pxx = tx * TX + px4 % TX
            ok = (py < Ho) & (pxx < Wo)
            for it, p in zip(*np.nonzero(ok)):
                out[b, py[it, p], pxx[it, p], j[it]] = o[it, p]
                writes[b, py[it, p], pxx[it, p], j[it]] += 1
    return out, writes, taken


def _w8(w2s, jg):
    """The two float4 a stage-2 item reads per input channel: pairs
    4jg..4jg+3, each (t=0, t=1): [G, items, 8]."""
    return np.stack([w2s[:, 8 * j:8 * j + 8] for j in jg], axis=1)


@pytest.mark.parametrize("b,h,w", [(1, 112, 96), (3, 112, 96),
                                   (3, 30, 46), (1, 2, 2), (3, 4, 6)])
@pytest.mark.parametrize("grid", [132 * 3, 7])
def test_schedule_writes_each_output_once(b, h, w, grid):
    rng = np.random.default_rng(b * 1000 + h + w)
    x = rng.uniform(0, 1, (b, h, w)).astype(np.float32)
    wk, bias, w2, b2 = _params(rng)
    out, writes, taken = run_schedule(x, wk.reshape(25, C), bias,
                                      w2.reshape(C // 2, C2), b2, grid)
    assert (taken == 1).all()
    assert (writes == 1).all()
    want = tstem.stem2_conv_plain(torch.from_numpy(x)[..., None],
                                  torch.from_numpy(wk),
                                  torch.from_numpy(bias),
                                  torch.from_numpy(w2),
                                  torch.from_numpy(b2)).numpy()
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)


def test_stage_items_fill_the_block_at_lightcnn9_widths():
    """At C = C2 = 96 the 192 threads take 8 stage-1 items and 1 stage-2
    item each: no thread idles in either stage."""
    assert (TY * TX // 2) * (C // 2) == 8 * THREADS
    assert (TY * TX // 4) * (C2 // 8) == THREADS
