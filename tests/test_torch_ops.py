"""Port ops against their JAX twins, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package's
function (its Pallas kernel in interpret mode, where it has one) and the
port's, which on CPU tensors runs each kernel's plain PyTorch version.
Integer and boolean outputs (EFM3 values, NMS keep masks) must match
exactly; float outputs to the tolerance each test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import improving_face_recognition_performance_using_triplet_loss_tpu.ops.boxes as jboxes
from improving_face_recognition_performance_using_triplet_loss_tpu.ops import (
    distances as jdist,
    mfm as jmfm,
    s2d_stem as js2d,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.pallas.mfm_kernel import (
    efm3_pallas,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.pallas.nms_kernel import (
    nms_mask_pallas_batched,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.ops.pallas.stem_kernel import (
    stem_conv_maxout_pool_pallas,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_cascade import (
    crop_resize_boxes,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_pnet import (
    compute_weight_mat,
    resize_linear,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
    boxes as tboxes,
    distances as tdist,
    mfm as tmfm,
    oracles as toracles,
    s2d_stem as ts2d,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
    efm3 as tefm3,
    stem as tstem,
)

from _torch_ties import OVERLAP_EPS, overlap_margins

T = torch.from_numpy


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------- MFM / EFM


@pytest.mark.parametrize("shape", [(7, 66), (5, 513), (2, 3, 4, 99),
                                   (6, 99), (4, 261), (3, 387)])
def test_efm3_and_mfm2_exact(shape):
    x = np.random.default_rng(sum(shape)).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(_np(tmfm.efm3(T(x))),
                                  np.asarray(jmfm.efm3(jnp.asarray(x))))
    if shape[-1] % 2 == 0:
        np.testing.assert_array_equal(_np(tmfm.mfm2(T(x))),
                                      np.asarray(jmfm.mfm2(jnp.asarray(x))))
    rows = x.reshape(-1, shape[-1])
    want = np.asarray(efm3_pallas(jnp.asarray(rows), interpret=True))
    np.testing.assert_array_equal(_np(tefm3.efm3_rows(T(rows))), want)
    with pytest.raises(ValueError):
        tefm3.efm3_rows(T(rows[:, :-1]))


# the odd thirds of the serving path (EFMNet342 and LightCNN29 widths)
@pytest.mark.parametrize("c", [66, 99, 261, 387])
@pytest.mark.parametrize("dtype", ["bf16", "f16", "f64"])
def test_efm3_rows_dtypes_exact(c, dtype):
    """efm3_rows in bf16, f16 and f64 equals efm3_pallas (interpret) on the
    same values; f64 rows hold f32 values (JAX without x64 computes them in
    f32, exactly)."""
    x = np.random.default_rng(c).normal(size=(9, c)).astype(np.float32)
    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "f16": (jnp.float16, torch.float16),
              "f64": (jnp.float32, torch.float64)}[dtype]
    want = np.asarray(efm3_pallas(jnp.asarray(x, jd), interpret=True),
                      np.float64)
    got = tefm3.efm3_rows(T(x).to(td))
    assert got.dtype == td and got.shape == (9, 2 * c // 3)
    np.testing.assert_array_equal(got.double().numpy(), want)


def test_efm3_rows_nan_and_refusals():
    """NaN propagates as torch.maximum / torch.minimum propagate it; the
    wrapper refuses C % 3, a tensor that is not 2-D and a non-float one."""
    x = np.random.default_rng(5).normal(size=(4, 66)).astype(np.float32)
    x[0, 3] = x[1, 22 + 5] = x[2, 44 + 21] = np.nan
    got = tefm3.efm3_rows(T(x)).numpy()
    want = np.asarray(efm3_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got).sum() == 6
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    for bad in (T(x[:, :-1]), T(x[None]), T(x).long()):
        with pytest.raises(ValueError):
            tefm3.efm3_rows(bad)


def test_efm3_fast_path_matches_movedim_path():
    """mfm.efm3 on a contiguous channel-last tensor (the [rows, C] view
    directly) equals its movedim path (channel axis 1, or a non-contiguous
    channel-last view) and efm3_plain."""
    x = T(np.random.default_rng(6).normal(size=(2, 5, 6, 99)).astype(
        np.float32))
    fast = tmfm.efm3(x)
    nchw = tmfm.efm3(x.permute(0, 3, 1, 2), axis=1).permute(0, 2, 3, 1)
    strided = tmfm.efm3(x.transpose(1, 2)).transpose(1, 2)
    assert not x.transpose(1, 2).is_contiguous()
    for other in (nchw, strided, tmfm.efm3_plain(x)):
        np.testing.assert_array_equal(fast.numpy(), other.numpy())


# ------------------------------------------------------------------- NMS


def _soup(rng, n, ties=False, invalid=0.0):
    x1 = rng.uniform(0, 60, n)
    y1 = rng.uniform(0, 60, n)
    s = rng.uniform(0, 1, n)
    if ties:
        s = np.round(s, 1)
    s[rng.uniform(size=n) < invalid] = -np.inf
    return np.stack([x1, y1, x1 + rng.uniform(1, 50, n),
                     y1 + rng.uniform(1, 50, n), s], 1).astype(np.float32)


# Cases grouped by (threshold, method) so that each group is ONE batched
# call of nms_mask_jax (vmapped) and of the Pallas kernel: the JAX side
# compiles once per group instead of once per test. Sets shorter than the
# group's longest are padded with -inf rows for the JAX calls (as the
# Pallas kernel pads to 128 itself): such rows sort last and never keep nor
# suppress, so the masks of the real rows are unchanged. The port runs each
# case at its own shape.
def _nms_cases():
    rng = np.random.default_rng(0)
    cases = {}

    def soups(n, k, **kw):
        return np.stack([_soup(rng, n, **kw) for _ in range(k)])

    # the four NMS calls of one frame of the serving path, with the -inf
    # rows the fixed capacities leave
    cases["per_scale"] = (0.5, "Union", soups(128, 8, invalid=0.3))
    cases["cross_scale"] = (0.7, "Union", soups(1024, 1, invalid=0.3))
    cases["stage2"] = (0.7, "Union", soups(128, 1, invalid=0.3))
    cases["stage3"] = (0.7, "Min", soups(64, 1, invalid=0.3))
    cases["union"] = (0.7, "Union", soups(128, 3, invalid=0.1))
    cases["min"] = (0.7, "Min", soups(64, 3, invalid=0.1))
    # 1-decimal scores tie in bulk: the oracle's order among ties is
    # unspecified, so the contract there is the JAX rule (ties to the
    # highest row)
    cases["ties"] = (0.5, "Union", soups(128, 3, ties=True, invalid=0.1))
    invalid = soups(128, 1)
    invalid[..., 4] = -np.inf
    cases["all_invalid"] = (0.5, "Union", invalid)
    cases["chain"] = (0.5, "Union",
                      tboxes.adversarial_nms_chain(256)[None])
    return cases


def _pad_invalid(sets, n):
    pad = np.zeros((sets.shape[0], n - sets.shape[1], 5), np.float32)
    pad[..., 4] = -np.inf
    return np.concatenate([sets, pad], axis=1)


@pytest.fixture(scope="module")
def nms_results():
    """{case: (threshold, method, sets, jax fixed point, jax Pallas)}."""
    cases = _nms_cases()
    groups = {}
    for name, (th, method, sets) in cases.items():
        groups.setdefault((th, method), []).append(name)
    out = {}
    for (th, method), names in groups.items():
        n_max = max(cases[n][2].shape[1] for n in names)
        sets = np.concatenate([_pad_invalid(cases[n][2], n_max)
                               for n in names])
        b = jnp.asarray(sets)
        fixed = np.asarray(jax.jit(jax.vmap(
            lambda c, th=th, m=method: jboxes.nms_mask_jax(c, th, m)))(b))
        pallas = np.asarray(nms_mask_pallas_batched(b, th, method,
                                                    interpret=True))
        at = 0
        for n in names:
            k, m = cases[n][2].shape[:2]
            out[n] = (th, method, cases[n][2], fixed[at:at + k, :m],
                      pallas[at:at + k, :m])
            at += k
    return out


def _check_nms(case, oracle=True):
    """The port's masks equal JAX's and the oracle's. Every side takes the
    same boxes, but each computes the overlaps in its own float32 order:
    no overlap of a set lies within ``OVERLAP_EPS`` of the threshold, so
    that rounding cannot decide a suppression (scores are inputs, and
    their ties go by the tie rule)."""
    threshold, method, sets, fixed, pallas = case
    for one in sets:
        assert overlap_margins(one, threshold, method) > OVERLAP_EPS
    got = tboxes.nms_mask_batched(T(sets), threshold, method).numpy()
    np.testing.assert_array_equal(got, fixed)
    np.testing.assert_array_equal(got, pallas)
    for s in range(sets.shape[0]):
        one = tboxes.nms_mask(T(sets[s]), threshold, method).numpy()
        np.testing.assert_array_equal(one, got[s])
        if oracle:
            ok = np.isfinite(sets[s, :, 4])
            keep = toracles.nms(sets[s][ok], threshold, method)
            np.testing.assert_array_equal(np.sort(np.where(ok)[0][keep]),
                                          np.where(got[s])[0])
    return got


@pytest.mark.parametrize("case", ["union", "min"])
def test_nms_matches_jax_pallas_and_oracle(nms_results, case):
    _check_nms(nms_results[case])


def test_nms_score_ties_match_fixed_point(nms_results):
    _check_nms(nms_results["ties"], oracle=False)


def test_nms_all_invalid_and_empty(nms_results):
    assert not _check_nms(nms_results["all_invalid"]).any()
    assert tboxes.nms_mask_batched(torch.zeros(2, 0, 5), 0.5).shape == (2, 0)


@pytest.mark.parametrize("case", ["per_scale", "cross_scale", "stage2",
                                  "stage3"])
def test_nms_path_shapes(nms_results, case):
    """Per-scale [8, 128] at 0.5 Union, cross-scale [1, 1024] at 0.7
    Union, stage 2 [1, 128] at 0.7 Union, stage 3 [1, 64] at 0.7 Min."""
    _check_nms(nms_results[case])


def test_nms_adversarial_chain(nms_results):
    chain = nms_results["chain"][2][0]
    np.testing.assert_array_equal(chain, jboxes.adversarial_nms_chain(256))
    keep = _check_nms(nms_results["chain"])[0]
    np.testing.assert_array_equal(np.where(keep)[0], np.arange(0, 256, 2))


def test_box_helpers_and_pnet_decode_match_jax():
    """bbreg / rerec against the JAX cascade's, and the PNet decode against
    the JAX decode as the cascade runs it, under jit (where XLA multiplies
    by the float32 reciprocal of the constant scale before the trunc).
    1-decimal heatmap values tie in bulk: top_k order among ties is by
    index."""
    from improving_face_recognition_performance_using_triplet_loss_tpu.detect.device_cascade import (
        bbreg_jax,
        rerec_jax,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        device_cascade as tcascade,
    )

    rng = np.random.default_rng(21)
    boxes = _soup(rng, 12)
    reg = rng.normal(scale=0.1, size=(12, 4)).astype(np.float32)
    np.testing.assert_allclose(tcascade.bbreg(T(boxes), T(reg)).numpy(),
                               np.asarray(bbreg_jax(jnp.asarray(boxes),
                                                    jnp.asarray(reg))),
                               rtol=1e-6)
    np.testing.assert_allclose(tcascade.rerec(T(boxes)).numpy(),
                               np.asarray(rerec_jax(jnp.asarray(boxes))),
                               rtol=1e-6)
    imap = np.round(rng.uniform(size=(2, 19, 23)), 1).astype(np.float32)
    hreg = rng.normal(scale=0.1, size=(2, 19, 23, 4)).astype(np.float32)
    scale = 0.6 * 0.709 ** 3
    decode = jax.jit(jboxes.decode_pnet_topk_jax, static_argnums=(2, 3, 4))
    # every box corner the decode truncates, (2 p + 1) / scale and
    # (2 p + 12) / scale, clears an integer by far more than the float32
    # rounding of its product; the scores are inputs, and their ties go by
    # the index rule
    pos = np.arange(23, dtype=np.float64)
    inv = np.float64(np.float32(1.0 / scale))
    corners = np.concatenate([(2 * pos + 1) * inv, (2 * pos + 12) * inv])
    assert np.abs(corners - np.round(corners)).min() > 1e-4
    got = tboxes.decode_pnet_topk(T(imap), T(hreg), scale, 0.3, 64).numpy()
    for i in range(2):
        np.testing.assert_array_equal(
            got[i], np.asarray(decode(imap[i], hreg[i], scale, 0.3, 64)))


# ------------------------------------------------------------------ stem


def _stem_inputs(c, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    w = (rng.normal(size=(5, 5, 1, c)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(c,)) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("maxout,c", [(2, 96), (3, 99)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_stem_matches_jax(maxout, c, dtype):
    """Port reference_stem and the kernel's plain version against JAX
    reference_stem and the Pallas stem (interpret mode): f32 at 1e-5
    (another summation order), bf16 at 1e-2 (tests/test_s2d_stem.py)."""
    x, w, b = _stem_inputs(c, maxout * 10 + c)
    tol = 1e-5 if dtype == "f32" else 1e-2
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    jx, jw, jb = (jnp.asarray(a, jd) for a in (x, w, b))
    tx, tw, tb = (T(a).to(td) for a in (x, w, b))
    ref = jax.jit(lambda x, w, b: js2d.reference_stem(x, w, b, maxout=maxout))
    want = [np.asarray(ref(jx, jw, jb), np.float32),
            np.asarray(stem_conv_maxout_pool_pallas(jx, jw, jb, maxout=maxout,
                                                    interpret=True),
                       np.float32)]
    got = [_np(ts2d.reference_stem(tx, tw, tb, maxout=maxout)),
           _np(tstem.stem_conv_maxout_pool(tx, tw, tb, maxout=maxout))]
    assert got[1].shape == (2, 8, 8, c // 2 if maxout == 2 else 2 * c // 3)
    for g in got:
        for wnt in want:
            np.testing.assert_allclose(g, wnt, rtol=tol, atol=tol)


def test_space_to_depth_and_packed_weights_exact():
    x = np.random.default_rng(0).normal(size=(2, 6, 8, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        ts2d.space_to_depth2(T(x)).numpy(),
        np.asarray(js2d.space_to_depth2(jnp.asarray(x))))
    w = np.random.default_rng(1).normal(size=(5, 5, 1, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        ts2d.pack_stem_weights(T(w)).numpy(),
        np.asarray(js2d.pack_stem_weights(jnp.asarray(w))))


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize("n_in,n_out", [(64, 39), (20, 48)])
def test_resize_weights_match_jax_resize(n_in, n_out):
    """The weight matrix is what ``jax.image.resize`` applies: resizing an
    identity image along one axis returns it."""
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat as jwm

    got = compute_weight_mat(n_in, n_out, n_out / n_in, 0.0).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jwm(n_in, n_out, n_out / n_in, 0.0,
                            _fill_triangle_kernel, True)), atol=1e-6)
    eye = jnp.eye(n_in, dtype=jnp.float32)[:, :, None]
    via_resize = np.asarray(jax.image.resize(eye, (n_out, n_in, 1),
                                             "linear"))[..., 0].T
    np.testing.assert_allclose(got, via_resize, atol=1e-6)
    img = np.random.default_rng(n_in).uniform(0, 255, (2, n_in, 30, 3))
    img = img.astype(np.float32)
    want = np.stack([np.asarray(jax.image.resize(jnp.asarray(i),
                                                 (n_out, 20, 3), "linear"))
                     for i in img])
    np.testing.assert_allclose(resize_linear(T(img), n_out, 20).numpy(), want,
                               rtol=1e-5, atol=1e-3)


def test_crop_weights_match_jax_scale_and_translate():
    """Per-box warps: the batched weights equal what
    ``jax.image.scale_and_translate`` applies (an identity image again),
    and the crops equal the JAX package's vmapped crop-resize, boxes that
    leave the image included (zeros outside)."""
    from improving_face_recognition_performance_using_triplet_loss_tpu.detect.device_cascade import (
        crop_resize_boxes_vmapped,
    )

    rng = np.random.default_rng(3)
    boxes = np.array([[3, 5, 40, 42], [-6, -2, 20, 30], [30, 40, 70, 66],
                      [10, 10, 10, 12]], np.float32)
    size, n_in = 24, 64
    sy = np.float32(size) / (boxes[:, 3] - boxes[:, 1] + np.float32(1))
    ty = -(boxes[:, 1] - np.float32(1)) * sy
    got = compute_weight_mat(n_in, size, T(sy), T(ty)).numpy()
    eye = jnp.eye(n_in, dtype=jnp.float32)[:, :, None]
    want = np.asarray(jax.vmap(lambda s, t: jax.image.scale_and_translate(
        eye, (size, n_in, 1), (0,), s[None], t[None], "linear"))(
            jnp.asarray(sy), jnp.asarray(ty)))[..., 0]
    np.testing.assert_allclose(got, np.swapaxes(want, 1, 2), atol=1e-6)
    img = rng.uniform(0, 255, (n_in, 48, 3)).astype(np.float32)
    want = np.asarray(crop_resize_boxes_vmapped(jnp.asarray(img),
                                                jnp.asarray(boxes), size))
    crops = crop_resize_boxes(T(img)[None], T(boxes)[None], size)[0].numpy()
    np.testing.assert_allclose(crops, want, rtol=1e-5, atol=1e-3)


# ------------------------------------------------------------- distances


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gallery_sims_match_jax(dtype):
    rng = np.random.default_rng(11)
    gal = rng.normal(size=(9, 342)).astype(np.float32)
    emb = rng.normal(size=(4, 342)).astype(np.float32)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    np.testing.assert_allclose(tdist.l2_normalize_np(gal),
                               jdist.l2_normalize_np(gal), rtol=0, atol=0)
    jn = jnp.asarray(jdist.narrow_gallery_np(jdist.l2_normalize_np(gal), jd))
    tn = tdist.narrow_gallery_np(tdist.l2_normalize_np(gal), td)
    np.testing.assert_array_equal(_np(tn), np.asarray(jn, np.float32))
    je = jdist.l2_normalize(jnp.asarray(emb))
    te = tdist.l2_normalize(T(emb))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-7)
    np.testing.assert_allclose(tdist.gallery_sims(te, tn).numpy(),
                               np.asarray(jdist.gallery_sims(je, jn)),
                               atol=1e-5)
    # int8 rows (the 127 scale) are stored too, equal to JAX's
    np.testing.assert_array_equal(
        tdist.narrow_gallery_np(tdist.l2_normalize_np(gal), np.int8).numpy(),
        np.asarray(jdist.narrow_gallery_np(jdist.l2_normalize_np(gal),
                                           jnp.int8)))
