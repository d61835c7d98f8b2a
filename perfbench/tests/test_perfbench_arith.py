"""The per-layer arithmetic on synthetic traces: the busy union, the idle
gaps, the families, the roofline and mfu, and their readers."""

from types import SimpleNamespace

import pytest

from perfbench.core import cell, readings
from perfbench.core.trace import GLUE, Trace, family
from perfbench.counts import kernels


def test_busy_is_the_union_of_intervals():
    # two kernels overlapping on two streams count once; a gap stays idle
    t = Trace(device=[("a", 0.0, 100.0), ("b", 50.0, 150.0),
                      ("c", 300.0, 400.0), ("d", 310.0, 320.0)],
              host=[], wall_s=500e-6, steps=1)
    assert t.busy_s() == pytest.approx(250e-6)
    assert readings.idle_share(SimpleNamespace(trace=t)) == pytest.approx(50.0)


def test_idle_gaps_by_host_operation():
    t = Trace(device=[("k", 0.0, 10.0), ("k", 40.0, 50.0),
                      ("k", 60.0, 70.0)],
              host=[("aten::to", 12.0, 39.0), ("aten::mul", 51.0, 52.0)],
              wall_s=1e-4, steps=1)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::to"] == pytest.approx(30e-6)
    assert gaps["host (untraced)"] == pytest.approx(10e-6)


@pytest.mark.parametrize("name,fam", [
    ("Memcpy HtoD (Pageable -> Device)", "memcpy"),
    ("Memset (Device)", "memcpy"),
    ("void nms_bitmask_kernel<4>(Args)", "nms"),
    ("void stem_kernel<3, 1>(float const*)", "stem"),
    ("void (anonymous namespace)::efm3_kernel<float, 1>(float const*)",
     "efm3"),
    ("void (anonymous namespace)::efm3_bwd_kernel<float>(float const*)",
     "efm3_bwd"),
    ("mining_tc(CUtensorMap)", "mining"),
    ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs", "conv"),
    ("void cudnn::detail::dgrad_engine<float, 512>", "conv"),
    ("void fft2d_r2c_32x32<float, false, 0u, false>(float2*)", "conv"),
    ("void pointwise_mult_and_sum_complex<float2, 8, 4>(float2*)", "conv"),
    ("sm80_xmma_gemm_cf32cf32_f32f32_cf32_nt_n_tilesize64x32x8", "conv"),
    ("void internal::region_transform_ABC_val<int, 32, 32>", "conv"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128>", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4, add>", GLUE)])
def test_families(name, fam):
    assert family(name) == fam


class _Driver:
    def __init__(self, calls, flops, batches=1):
        self._calls, self._flops, self._b = calls, flops, batches

    def calls(self):
        return self._calls

    def flops_per_step(self):
        return self._flops

    def batches_per_step(self):
        return self._b


def test_roofline_and_its_launch_check():
    calls = {"efm3": [(kernels.efm3(1024, 99), 2)],
             "stem": [(kernels.stem(4, 64, 64, 99), 1)]}
    least = kernels.least_total_s(calls)
    # two steps of two batches; the traced kernels took 4x their least time
    t = Trace(device=[("efm3_kernel<float>", 0.0, least * 1e6),
                      ("stem_kernel<3>", 0.0, least * 1e6),
                      ("elementwise", 0.0, 99.0)], host=[],
              wall_s=1.0, steps=2)
    run = SimpleNamespace(trace=t, driver=_Driver(calls, 0, batches=2),
                          launches={"efm3": 8, "stem": 4})
    assert readings.roofline(run) == pytest.approx(200.0)
    run.launches = {"efm3": 7, "stem": 4}
    assert readings.roofline(run) is None


def test_least_times():
    # B2 at 1,024 x 99: 99 + 66 floats a row read and written
    assert kernels.efm3(1024, 99) == pytest.approx(
        1024 * 165 * 4 / kernels.MEM_BYTES_PER_S)
    # B3 at batch 128, 128x128: bound by its operations at 67 TFLOP/s
    ops = 2 * 25 * 99 * 128 * 128 * 128 + 2 * 128 * 128 * 128 * 99
    assert kernels.stem(128, 128, 128, 99) == pytest.approx(ops / 67e12)


def test_mfu():
    run = SimpleNamespace(window={"steps": 10, "seconds": 2.0},
                          driver=_Driver({}, 6.7e12))
    assert readings.mfu(run) == pytest.approx(50.0)


def test_forbidden_modules_compare_whole_names():
    pkg = "improving_face_recognition_performance_using_triplet_loss_tpu"
    assert cell.loaded_forbidden([pkg + "_torch", pkg + "_torch.models",
                                  "jaxtyping", "numpy"]) == []
    assert cell.loaded_forbidden(["jax.numpy", pkg + ".models",
                                  "flax"]) == sorted(["jax", pkg, "flax"])
