"""The port's gallery storage, ``DeviceGallery`` and matchers against the
JAX package's, on the CPU.

int8 and bf16 narrowing and ``gallery_sims`` are held bit for bit to JAX at
D = 342 and at a D that is not a multiple of 8 (the int8 product pads the
depth to a multiple of 8 with zeros, which adds nothing). ``DeviceGallery``
goes through every mutation and a doubling beside the JAX one and is read
back with ``to_host()``: rows built from ``initial`` are normalized on the
host on both sides and must be equal bit for bit; rows written by ``add``
/ ``set_row`` are normalized on the host here and on the device (in XLA)
in JAX, so they are held within one f32 ulp (f32), one bf16 ulp (bf16) or
one int8 step (int8) and equal wherever JAX's value is not within 1e-6 of
a rounding boundary. The mesh-sharded paths, run over a process group of
one, equal their unsharded twins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_face_recognition_performance_using_triplet_loss_tpu.ops import (
    distances as jd,
)
from improving_face_recognition_performance_using_triplet_loss_tpu.serve import (
    device_gallery as jdg,
    gallery as jgal,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch import (
    parallel,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
    _common,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
    distances as td,
)
from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
    device_gallery as tdg,
    gallery as tgal,
    pipeline as tpipe,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the sharded pipelines' convs would otherwise
    oversubscribe the cores under the suite's workers."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}


def _rows(seed, n, d):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("d", [342, 37])
@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_narrow_and_gallery_sims_bit_equal_to_jax(name, d):
    jdt, tdt = DTYPES[name]
    gal_n = jd.l2_normalize_np(_rows(0, 40, d))
    probes = jd.l2_normalize_np(_rows(1, 6, d))
    jrows = jd.narrow_gallery_np(gal_n, jdt)
    trows = td.narrow_gallery_np(gal_n, tdt)
    np.testing.assert_array_equal(_np(trows),
                                  np.asarray(jrows, np.float32))
    # the device-side narrowing of the same rows
    np.testing.assert_array_equal(
        _np(td.narrow_gallery(torch.from_numpy(gal_n), tdt)),
        np.asarray(jd.narrow_gallery(jnp.asarray(gal_n), jdt), np.float32))
    want = np.asarray(jd.gallery_sims(jnp.asarray(probes),
                                      jnp.asarray(jrows)))
    got = td.gallery_sims(torch.from_numpy(probes), trows).numpy()
    assert got.dtype == np.float32 and got.shape == (6, 40)
    if name == "int8":
        np.testing.assert_array_equal(got, want)
    else:   # f32 x bf16 widened: the sum order of the product may differ
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a leading batch axis, as the multi-stream multi-face pipeline passes
    got3 = td.gallery_sims(torch.from_numpy(probes.reshape(2, 3, d)), trows)
    np.testing.assert_array_equal(got3.reshape(6, 40).numpy(), got)


def test_int8_product_is_exact_and_pads_every_operand():
    """The padded ``_int_mm`` route equals an int64 product at shapes that
    need every pad (N < 17, D and G not multiples of 8), and at the
    extremes of the 127 grid."""
    rng = np.random.default_rng(3)
    for n, d, g in ((1, 342, 5), (3, 37, 13), (20, 16, 8)):
        q = rng.integers(-127, 128, (n, d)).astype(np.int8)
        rows = rng.integers(-127, 128, (g, d)).astype(np.int8)
        rows[0] = 127
        q[0] = -127
        got = td.int8_product(torch.from_numpy(q), torch.from_numpy(rows))
        assert got.dtype == torch.int32 and got.shape == (n, g)
        np.testing.assert_array_equal(
            got.numpy(), q.astype(np.int64) @ rows.astype(np.int64).T)


def test_gallery_dtype_names():
    assert _common.GALLERY_DTYPE_NAMES == ("f32", "bf16", "int8")
    assert [_common.gallery_dtype(n) for n in _common.GALLERY_DTYPE_NAMES] \
        == [torch.float32, torch.bfloat16, torch.int8]
    with pytest.raises(ValueError, match="int8"):
        td.narrow_gallery_np(np.zeros((1, 4), np.float32), torch.float16)


def _assert_rows_close(got, want, name, exact_mask=None):
    """Rows normalized on two hosts' arithmetic: within one unit of the
    storage's resolution, and equal where ``exact_mask`` says JAX's value
    is off a rounding boundary."""
    tol = {"f32": 1.2e-7, "bf16": 2 ** -8, "int8": 1.0 / 127}[name]
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * 1.0001)
    if exact_mask is not None:
        np.testing.assert_array_equal(got[exact_mask], want[exact_mask])


def _off_boundary(vecs, name):
    """Elements of the normalized rows whose narrowed value cannot flip
    with a one-ulp change of the f32 normalization."""
    x = jd.l2_normalize_np(vecs)
    if name == "int8":
        frac = np.abs(x * 127.0 - np.floor(x * 127.0) - 0.5)
        return frac > 1e-4
    return np.ones_like(x, bool) if name == "bf16" else None


@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
def test_device_gallery_mutations_match_jax(name):
    jdt, tdt = DTYPES[name]
    d = 342
    init = _rows(4, 3, d)
    new = _rows(5, 4, d)
    jg = jdg.DeviceGallery(dim=d, capacity=2, initial=init, dtype=jdt)
    tg = tdg.DeviceGallery(dim=d, capacity=2, initial=init, dtype=tdt,
                           device="cpu")
    assert (tg.capacity, tg.rows) == (jg.capacity, jg.rows) == (4, 3)
    # host-normalized initial rows: bit for bit
    np.testing.assert_array_equal(tg.to_host(), jg.to_host())
    ptr = tg.gallery_n.data_ptr()
    assert tg.add(new[0]) == jg.add(new[0]) == 3
    assert tg.gallery_n.data_ptr() == ptr        # written in place
    assert int(tg.rows_arg) == 4 and tg.rows_arg.dtype == torch.int32
    assert tg.rows_arg.ndim == 0
    # a doubling: the only mutation that moves the buffer
    assert tg.add(new[1]) == jg.add(new[1]) == 4
    assert tg.capacity == jg.capacity == 8
    assert tg.gallery_n.data_ptr() != ptr
    ptr = tg.gallery_n.data_ptr()
    tg.set_row(1, new[2])
    jg.set_row(1, new[2])
    tg.clear_row(0)
    jg.clear_row(0)
    assert tg.gallery_n.data_ptr() == ptr
    assert int(tg.rows_arg) == 5 and tg.gallery_n.dtype == tdt
    got, want = tg.to_host(), jg.to_host()
    assert got.shape == want.shape == (5, d)
    np.testing.assert_array_equal(got[[0, 2]], want[[0, 2]])
    written = np.stack([new[2], new[0], new[1]])
    mask = _off_boundary(written, name)
    _assert_rows_close(got[[1, 3, 4]], want[[1, 3, 4]], name, mask)
    # padding rows stay zero
    assert not tg.gallery_n[5:].any()
    with pytest.raises(IndexError):
        tg.set_row(5, new[3])
    with pytest.raises(IndexError):
        tg.clear_row(-1)
    with pytest.raises(ValueError):
        tg.add(new[3][:10])


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_from_rows_compacts_tombstones_like_jax(name):
    jdt, tdt = DTYPES[name]
    rows = _rows(6, 5, 342)
    keep = np.array([True, False, True, True, False])
    jg = jdg.DeviceGallery.from_rows(rows, capacity=2, keep=keep, dtype=jdt)
    tg = tdg.DeviceGallery.from_rows(rows, capacity=2, keep=keep, dtype=tdt,
                                     device="cpu")
    assert (tg.rows, tg.capacity) == (jg.rows, jg.capacity) == (3, 4)
    np.testing.assert_array_equal(tg.to_host(), jg.to_host())


def test_device_gallery_feeds_the_dynamic_match():
    """``(gallery_n, rows_arg)`` plug into the pipelines' match: padding
    never wins, an empty gallery reports the -2.0 sentinel."""
    rows = _rows(7, 3, 342)
    tg = tdg.DeviceGallery(dim=342, capacity=8, device="cpu")
    probe = torch.from_numpy(td.l2_normalize_np(rows[1:2]))
    idx, sim, real = tpipe._match_gallery(
        td.gallery_sims(probe, tg.gallery_n), tg.rows_arg)
    assert not bool(real[0])
    for r in rows:
        tg.add(r)
    idx, sim, real = tpipe._match_gallery(
        td.gallery_sims(probe, tg.gallery_n), tg.rows_arg)
    assert int(idx[0]) == 1 and bool(real[0])
    assert abs(float(sim[0]) - 1.0) < 1e-6


@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
def test_unsharded_matchers_match_jax(name):
    jdt, tdt = DTYPES[name]
    gallery = _rows(8, 30, 342)
    queries = gallery[[3, 7, 29]] + 0.01 * _rows(9, 3, 342)
    jidx, jsim = jgal.make_gallery_matcher(gallery, dtype=jdt)(
        jnp.asarray(queries))
    tidx, tsim = tgal.make_gallery_matcher(gallery, dtype=tdt,
                                           device="cpu")(queries)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tsim.numpy(), np.asarray(jsim), rtol=0,
                               atol=1e-6)
    jix, jsm = jgal.match_gallery_tpu(gallery, queries, sim_th=0.999,
                                      dtype=jdt)
    tix, tsm = tgal.match_gallery_tpu(gallery, queries, sim_th=0.999,
                                      dtype=tdt, device="cpu")
    np.testing.assert_array_equal(tix, jix)
    np.testing.assert_allclose(tsm, jsm, rtol=0, atol=1e-6)


def _world1_dg():
    """A one-rank row-sharded gallery after adds and a doubling, against
    the unsharded one."""
    rows = _rows(11, 5, 4)
    mesh = parallel.make_2d_mesh(1)
    got = tdg.DeviceGallery(dim=4, capacity=2, initial=rows[:2], mesh=mesh,
                            device="cpu")
    want = tdg.DeviceGallery(dim=4, capacity=2, initial=rows[:2],
                             device="cpu")
    for g in (got, want):
        for v in rows[2:]:
            g.add(v)
        g.clear_row(1)
    assert got.capacity == want.capacity == 8
    return got.to_host(), want.to_host()


def _world1_pipelines(gallery_sharded: bool):
    """A sharded pipeline over one rank against the unsharded one on the
    same frame and nets."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.efm_symbol import (
        build_efmnet342,
    )

    torch.manual_seed(0)
    det = MTCNNDetector(device="cpu")
    net = build_efmnet342(4, image_size=32, device="cpu",
                          generator=torch.Generator().manual_seed(0))
    gallery = _rows(12, 3, 342)
    frames = (np.random.default_rng(0).random((1, 48, 48, 3)) * 255).astype(
        np.float32)
    kw = dict(frame_h=48, frame_w=48, embed_size=32,
              thresholds=(0.3, 0.3, 0.3), sim_threshold=-1.0, device="cpu")
    want = tpipe.make_multistream_pipeline(det, net, gallery, **kw)(frames)
    if gallery_sharded:
        mesh = parallel.make_2d_mesh(1)
        gal_n, rows = tpipe.shard_gallery(gallery, mesh, device="cpu")
        got = tpipe.make_gallery_sharded_multistream_pipeline(
            det, net, mesh, **kw)(frames, gal_n, rows)
    else:
        got = tpipe.make_sharded_multistream_pipeline(
            det, net, gallery, parallel.make_mesh(), **kw)(frames)
    assert set(got) == set(want)
    return ({k: v.numpy() for k, v in got.items()},
            {k: v.numpy() for k, v in want.items()})


def _world1_matcher():
    gallery = _rows(13, 7, 16)
    queries = gallery[[1, 6]] + 0.01
    got = tgal.make_sharded_gallery_matcher(gallery, parallel.make_mesh(),
                                            device="cpu")(queries)
    want = tgal.make_gallery_matcher(gallery, device="cpu")(queries)
    return [t.numpy() for t in got], [t.numpy() for t in want]


@pytest.mark.parametrize("call", [
    _world1_dg,
    _world1_matcher,
    lambda: (tgal.match_gallery_sharded(_rows(14, 5, 8), _rows(15, 2, 8),
                                        device="cpu"),
             tgal.match_gallery_tpu(_rows(14, 5, 8), _rows(15, 2, 8),
                                    device="cpu")),
    lambda: (tpipe.shard_gallery(_rows(16, 3, 8), parallel.make_2d_mesh(1),
                                 device="cpu")[0].numpy(),
             tpipe.normalize_gallery(_rows(16, 3, 8), device="cpu").numpy()),
    lambda: _world1_pipelines(False),
    lambda: _world1_pipelines(True),
], ids=[f"call{i}" for i in range(6)])
def test_sharded_paths_raise_naming_a10(call):
    """(Named when these paths refused; each now runs.) Over a process
    group of one each sharded path equals its unsharded twin exactly:
    the row-sharded ``DeviceGallery``, the sharded matchers,
    ``shard_gallery`` and both sharded pipelines
    (tests/test_torch_parallel_serve.py holds them to JAX on 2 ranks)."""
    with parallel.process_group("cpu"):
        got, want = call()
    _assert_tree_equal(got, want)


def _assert_tree_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_tree_equal(g, w)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
