"""The bf16 tensor-core version of kernel B6 (``csrc/front9_tc.cu``) on the
CPU, where it cannot run: its weight layout, and a numpy model of its index
arithmetic held against the plain version.

(a) Unpacking ``pack_front9_weights_tc`` by the PTX definition of the
mma.m16n8k16 B fragment gives back the HWIO kernels rounded to bf16, as
GEMM B matrices with rows (tap, cin) and the mfm2 pairs (j, j + C/2) in
columns 2j, 2j+1.

(b) The model computes conv1, conv2a and conv2 per 8x8-pooled-output tile
as the kernel does: the stem's im2col rows (dy, s, dx) and window offsets,
conv2a over the 324 halo rows (clamped past the end, zero outside the
image), conv2's implicit-GEMM rows and per-tap halo addresses with K in
(tap, cin) order, mfm2 over column pairs and the pool over the rows' dy and
dx. In f32 on bf16-representable inputs and weights it must equal the plain
version (``front9_plain``) within 1e-5, at a tile-edge shape and at full
width; the JAX package's ``front9_chain_pallas`` is held to the plain
version in tests/test_torch_lightcnn.py.
"""

import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    front9 as tfront9,
)

T_, NH, IN = 8, 18, 40   # csrc/front9_tc.cu T, NH, IN


def _params(seed, c1=96, c2a=96, c2=192, rounded=False):
    """Random conv1/conv2a/conv2 weights in the flax layout (HWIO), scaled
    like tests/test_pallas_kernels.py::_front9_params; ``rounded`` makes
    them bf16-representable."""
    rng = np.random.default_rng(seed)

    def t(shape, s):
        w = torch.from_numpy(rng.normal(size=shape).astype(np.float32) * s)
        return w.to(torch.bfloat16).float() if rounded else w

    return {"conv1": {"kernel": t((5, 5, 1, c1), 0.1), "bias": t((c1,), 0.1)},
            "conv2a": {"kernel": t((1, 1, c1 // 2, c2a), 0.1),
                       "bias": t((c2a,), 0.1)},
            "conv2": {"kernel": t((3, 3, c2a // 2, c2), 0.05),
                      "bias": t((c2,), 0.1)}}


def unfrag(p) -> np.ndarray:
    """[K/16, N/16, 32, 8] -> the B matrix [K, N]: lane l = 4g + t holds, at
    4q + 2h + e, B[16 ks + 8h + 2t + e, 16 np + 8q + g] (b0, b1 of n8 tile
    2 np, then of 2 np + 1)."""
    p = np.asarray(p.float())
    ks, np_, lane, i = np.meshgrid(*map(np.arange, p.shape), indexing="ij")
    g, t = lane // 4, lane % 4
    q, h, e = i // 4, (i // 2) % 2, i % 2
    bm = np.full((16 * p.shape[0], 16 * p.shape[1]), np.nan, np.float32)
    bm[16 * ks + 8 * h + 2 * t + e, 16 * np_ + 8 * q + g] = p
    assert not np.isnan(bm).any()
    return bm


def _interleaved(w: np.ndarray) -> np.ndarray:
    """[K, 2h] -> columns 2j, 2j+1 = columns j, j+h."""
    h = w.shape[1] // 2
    return np.stack([w[:, :h], w[:, h:]], 2).reshape(w.shape[0], -1)


@pytest.mark.parametrize("widths", [(8, 24, 64), (96, 96, 192)])
def test_pack_front9_weights_tc_layout(widths):
    """(a) Every packed weight sits where the kernel's fragments read it;
    padding is zero; bf16 packing goes to this layout."""
    c1, c2a, c2 = widths
    params = _params(1, *widths)
    packed = tfront9.pack_front9_weights(params, torch.bfloat16)
    assert packed["dtype"] == torch.bfloat16 and packed["widths"] == widths

    def bf(name):
        return params[name]["kernel"].to(torch.bfloat16).float().numpy()

    def check(bm, want):
        k, n = want.shape
        np.testing.assert_array_equal(bm[:k, :n], _interleaved(want))
        assert not bm[k:].any() and not bm[:, n:].any()

    check(unfrag(packed["w1"]), bf("conv1").reshape(25, c1))
    check(unfrag(packed["w2a"]), bf("conv2a").reshape(c1 // 2, c2a))
    w2 = unfrag(packed["w2"])
    cin16 = -(-(c2a // 2) // 16) * 16
    assert w2.shape[0] == 9 * cin16
    for tap in range(9):
        check(w2[tap * cin16:(tap + 1) * cin16],
              bf("conv2")[tap // 3, tap % 3])
    for n in ("w1", "w2a", "w2"):
        assert packed[n].dtype == torch.bfloat16 and packed[n].is_contiguous()
    for n in ("conv1", "conv2a", "conv2"):
        b = packed["b" + n[4:]]
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b, params[n]["bias"])


def test_front9_bf16_kernel_refuses_other_widths():
    """The bf16 kernel is built for LightCNN9's widths; a bf16 tensor at
    other widths raises at the launch instead of taking another kernel."""
    params = _params(2, 8, 24, 64)
    packed = tfront9.pack_front9_weights(params, torch.bfloat16)
    x = torch.zeros(1, 16, 16, 1, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="widths"):
        tfront9._launch(x, packed)
    with pytest.raises(ValueError, match="packed for"):
        tfront9._launch(x, tfront9.pack_front9_weights(_params(2),
                                                        torch.float32))


# ------------------------------------------- (b) the kernel's index model

# m16-tile row r = 8 dy + 2 s + dx (csrc/front9_tc.cu, stages 1 and 3)
_R = np.arange(16)
_DY, _S, _DX = _R >> 3, (_R & 7) >> 1, _R & 1


def _stem_rows():
    """Window offset of each stem GEMM row: m16 tile mt holds halo positions
    p = 4 mt + s, rows (dy, dx) their conv1 phases. [81, 16]."""
    p = 4 * np.arange(NH * NH // 4)[:, None] + _S
    return (2 * (p // NH) + _DY) * IN + 2 * (p % NH) + _DX


def _conv2_rows():
    """Halo position (tap (0, 0)) of each conv2 GEMM row: m16 tile mt holds
    pooled pixels P = 4 mt + s, rows (dy, dx) their 2x2 conv2 positions.
    [16, 16]."""
    P = 4 * np.arange(16)[:, None] + _S
    return (2 * (P >> 3) + _DY) * NH + 2 * (P & 7) + _DX


def _pool_rows(c):
    """[tiles, 16 rows, N] -> the max over each row's dy and dx: [tiles, 4
    (s), N] (the kernel's register max and lane shuffle)."""
    return c.reshape(c.shape[0], 2, 4, 2, -1).max(axis=(1, 3))


def _mfm_cols(c, bias):
    """GEMM columns 2j, 2j+1 (+ the interleaved biases) -> their max."""
    c = c + _interleaved(bias[None])[0]
    return np.maximum(c[..., 0::2], c[..., 1::2])


def model(x, packed):
    """The kernel's arithmetic in numpy f32: x [B, H, H] -> [B, H/4, H/4,
    96]."""
    w1, w2a, w2 = (unfrag(packed[n]) for n in ("w1", "w2a", "w2"))
    b1, b2a, b2 = (packed[n].numpy() for n in ("b1", "b2a", "b2"))
    b, h = x.shape[:2]
    h2, h4 = h // 2, h // 4
    tiles = -(-h4 // T_)
    out = np.full((b, tiles * T_, tiles * T_, 96), np.nan, np.float32)
    k = np.arange(32)
    tap_off = np.where(k < 25, (k // 5) * IN + k % 5, 0)
    stem_rows, conv2_rows = _stem_rows(), _conv2_rows()
    halo = np.arange(NH * NH)
    clamp = np.minimum(np.arange(21 * 16), NH * NH - 1).reshape(21, 16)
    taps = np.array([di * NH + dj for di in range(3) for dj in range(3)])
    for bi in range(b):
        for ty in range(tiles):
            for tx in range(tiles):
                oy0, ox0 = ty * T_, tx * T_
                hy0, hx0 = 2 * oy0 - 1, 2 * ox0 - 1
                iy0, ix0 = 2 * hy0 - 2, 2 * hx0 - 2
                win = np.zeros((IN, IN), np.float32)
                ys = slice(max(iy0, 0), min(iy0 + IN, h))
                xs = slice(max(ix0, 0), min(ix0 + IN, h))
                win[ys.start - iy0:ys.stop - iy0,
                    xs.start - ix0:xs.stop - ix0] = x[bi, ys, xs]
                # stage 1: stem
                a1 = np.where(k < 25, win.reshape(-1)[
                    stem_rows[..., None] + tap_off], 0)       # [81, 16, 32]
                stem = _pool_rows(_mfm_cols(a1 @ w1, b1)).reshape(-1, 48)
                # stage 2: conv2a (rows past 323 read row 323, unused)
                a = _mfm_cols(stem[clamp] @ w2a, b2a).reshape(-1, 48)
                a = a[:NH * NH]
                cy, cx = hy0 + halo // NH, hx0 + halo % NH
                inside = (cy >= 0) & (cy < h2) & (cx >= 0) & (cx < h2)
                a = np.where(inside[:, None], a, 0)
                # stage 3: conv2 + mfm2 + pool, K = (tap, cin)
                a3 = a[conv2_rows[..., None] + taps].reshape(16, 16, 9 * 48)
                y = _pool_rows(_mfm_cols(a3 @ w2, b2)).reshape(64, 96)
                out[bi, oy0:oy0 + T_, ox0:ox0 + T_] = y.reshape(8, 8, 96)
    return out[:, :h4, :h4]


@pytest.mark.parametrize("shape", [(2, 68, 68), (1, 36, 36)])
def test_front9_tc_index_model_matches_plain(shape):
    """(b) The model of the kernel's tiling, row maps, tap addresses and K
    order, in f32, equals front9_plain within 1e-5: 2x68x68 has partial
    tiles (17 pooled outputs a side), 1x36x36 two tiles a side."""
    params = _params(3, rounded=True)
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    packed = tfront9.pack_front9_weights_tc(params)
    got = model(x, packed)
    want = tfront9.front9_plain(torch.from_numpy(x)[..., None], params)
    assert got.shape == tuple(want.shape)
    assert float(want.abs().mean()) > 1e-2
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-5)
