#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's hand-written kernels from ``csrc/`` (CUDA C++) and
holds each against its plain PyTorch version on the card at the shapes its
path gives it (B3 and B6 in f32 and, on the tensor cores, in bf16). Then it
drives the paths of the port, each with the launch counts set to 0 just
before it and read just after:

- serving: ``serve_demo --streams 16`` at 240x320 with EFMNet342 at 64x64
  and random seeded weights (kernels B5, B3, B2), rerun on the CPU with the
  same frames and weights to check the answers;
- head training: ``train_head --mining semi_hard_fused`` at batch 16384
  over 342-d synthetic features (kernel B1), rerun with the plain
  ``--mining semi_hard`` on the card to check the losses and cosines;
- extraction: ``extract_features`` at batch 128 over synthetic-face stores,
  LightCNN9 at 128x128 (kernel B6) and on 112x96 crops (kernel B4), and
  LightCNN29 at 128x128 (B3, B2), each checked against a CPU rerun of its
  first rows, plus ``--bf16`` runs of LightCNN9 (B6 on the tensor cores)
  and LightCNN29 (B3 on the tensor cores) held to the f32 ones;
- LightCNN9 serving: ``serve_demo --streams 16 --model lightcnn9
  --image-size 128`` at 240x320 (B5, B6), rerun on the CPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py front9 extract   # the build and these phases

Prints one JSON line per phase, a ``{"kernels": [...]}`` line, the card's
name and power limit, and last ``{"ok": true, "device": {...}}``. Exits
non-zero, printing no result, without CUDA, outside a checkout of the
repository, or when any phase fails. Every phase starts from PyTorch's
defaults, under which cuDNN runs float32 convolutions in TF32: the CLIs
turn TF32 off themselves (``device.full_f32``), so the card and the CPU
compute the same float32 products, and the path phases check that they
did; a kernel phase that runs cuDNN (a plain version or a yardstick) turns
it off itself.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"
JAX_PKG = "improving_face_recognition_performance_using_triplet_loss_tpu"

# H100 SXM, NVIDIA's data sheet: HBM3 rate, the float32 rate outside the
# tensor cores (B2-B5, f32 B6, B1's epilogue), the dense bf16 tensor-core
# rate (B6 in bf16) and the dense TF32 rate (B1's three TF32 products)
MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
TF32_TC_OPS_PER_S = 495e12

STREAMS, FRAME_HW, IMAGE = 16, (240, 320), 64
# the head slice: batch 16384 (the reference's), a 32768-row mining pool,
# 342-d features into a 128-d head, a 65,536-row store of 4,096 identities
HEAD_BATCH, FEAT_DIM, EMB_DIM = 16384, 342, 128
HEAD_IDS, HEAD_PER_ID, HEAD_EPOCHS = 4096, 16, 2

# the kernels each path launches (the counts are read per path)
PATH_KERNELS = {"slice": ("nms", "stem", "efm3"), "head": ("mining",),
                "extract": ("front9", "front9_bf16", "stem2", "stem",
                            "stem_bf16", "efm3"),
                "serve9": ("nms", "front9")}


def slice_argv(frames: int, device: str) -> list[str]:
    """serve_demo's arguments for the slice: 16 streams of 240x320 frames,
    EFMNet342 on 64x64 crops, 1,000 gallery identities."""
    return ["--streams", str(STREAMS), "--frames", str(frames),
            "--frame-size", str(FRAME_HW[0]), str(FRAME_HW[1]),
            "--image-size", str(IMAGE), "--identities", "1000",
            "--det-thresholds", "0.3", "0.3", "0.3", "--device", device]


# the serving path's NMS calls per dispatch (detect/device_pnet.py,
# detect/device_cascade.py): [sets, rows, threshold, method]; 8 pyramid
# scales at 240x320
NMS_PATH = {"per_scale": (STREAMS * 8, 128, 0.5, "Union"),
            "cross_scale": (STREAMS, 1024, 0.7, "Union"),
            "stage2": (STREAMS, 128, 0.7, "Union"),
            "stage3": (STREAMS, 64, 0.7, "Min")}
# EFM3 calls of one EFMNet342 forward over the STREAMS crops:
# (rows, channels) -> calls
EFM3_PATH = {(STREAMS * 32 * 32, 66): 1, (STREAMS * 32 * 32, 99): 2,
             (STREAMS * 32 * 32, 198): 1,
             (STREAMS * 16 * 16, 132): 2, (STREAMS * 16 * 16, 198): 3,
             (STREAMS * 16 * 16, 387): 1,
             (STREAMS * 8 * 8, 258): 3, (STREAMS * 8 * 8, 387): 4,
             (STREAMS * 8 * 8, 261): 1,
             (STREAMS * 4 * 4, 174): 4, (STREAMS * 4 * 4, 261): 6,
             (STREAMS, 513): 1}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """Least time for the work in ms, and what sets it."""
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, ops / ops_per_s
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops else
                                     "operations")


def time_ms(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of ``fn`` on the card over ``reps`` back-to-back calls (CUDA
    events; inputs stay resident in L2 as they do on the path)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ----------------------------------------------------------------- phases


def phase_build(ctx):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        _build,
    )

    t0 = time.perf_counter()
    _build.build_all()
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name in _build.FLAGS:
        _build.load(name)
        ptxas[name] = [ln.strip() for ln in _build.ptxas_report(name).splitlines()
                       if "registers" in ln or "spill" in ln]
    return {"seconds": seconds, "ptxas": ptxas}


def _soups(torch, gen, sets, n, *, ties=False, invalid=0.3):
    """Random boxes in a 240x320 frame: [sets, n, 5] on the card."""
    u = lambda *s: torch.rand(*s, generator=gen)  # noqa: E731
    x1 = u(sets, n) * 300
    y1 = u(sets, n) * 220
    side = 12 + u(sets, n) * 90
    score = u(sets, n)
    if ties:
        score = torch.round(score * 10) / 10
    score = torch.where(u(sets, n) < invalid, float("-inf"), score)
    b = torch.stack([x1, y1, x1 + side, y1 + side * (0.8 + 0.4 * u(sets, n)),
                     score], -1)
    return b.cuda()


def _greedy_iou_count(boxes, threshold, method) -> int:
    """IoUs greedy NMS evaluates on these sets: each kept box against the
    later rows still alive when it is reached (what the kernel computes)."""
    import numpy as np

    total = 0
    for b in boxes.cpu().numpy():
        b = b[np.isfinite(b[:, 4])]
        order = np.argsort(-b[:, 4], kind="stable")
        x1, y1, x2, y2 = (b[order, i] for i in range(4))
        area = (x2 - x1 + 1) * (y2 - y1 + 1)
        alive = np.ones(len(order), bool)
        for i in range(len(order)):
            if not alive[i]:
                continue
            rest = np.where(alive[i + 1:])[0] + i + 1
            total += len(rest)
            w = np.maximum(0, np.minimum(x2[i], x2[rest])
                           - np.maximum(x1[i], x1[rest]) + 1)
            h = np.maximum(0, np.minimum(y2[i], y2[rest])
                           - np.maximum(y1[i], y1[rest]) + 1)
            inter = w * h
            den = (np.minimum(area[i], area[rest]) if method == "Min"
                   else area[i] + area[rest] - inter)
            alive[rest[inter / den > threshold]] = False
    return total


def _nms_edge_cases(torch, gen) -> dict:
    """Cases off the path: sets in the global-scratch mode (2,048 and 4,096
    rows), -0.0 / +0.0 / 1e-30 score ties, NaN and +-inf scores among
    finite ones, one-row sets, Min with tied scores."""
    cases = {"rows_2048": (_soups(torch, gen, 2, 2048), 0.5, "Union"),
             "rows_4096": (_soups(torch, gen, 1, 4096), 0.5, "Union")}
    b = _soups(torch, gen, STREAMS, 128, invalid=0.0)
    pick = torch.randint(0, 4, b.shape[:2], generator=gen).cuda()
    zero = torch.zeros_like(b[..., 4])
    b[..., 4] = torch.where(pick == 0, zero, torch.where(
        pick == 1, -zero, torch.where(pick == 2, zero + 1e-30, b[..., 4])))
    cases["signed_zero_ties"] = (b, 0.5, "Union")
    b = _soups(torch, gen, STREAMS, 128, invalid=0.0)
    u = torch.rand(b.shape[:2], generator=gen).cuda()
    b[..., 4] = torch.where(u < 0.15, float("nan"), torch.where(
        u < 0.3, float("inf"), torch.where(u < 0.4, float("-inf"),
                                           b[..., 4])))
    cases["nan_inf"] = (b, 0.5, "Union")
    cases["one_row"] = (_soups(torch, gen, 8, 1, invalid=0.0), 0.5, "Union")
    cases["min_ties"] = (_soups(torch, gen, STREAMS, 64, ties=True), 0.7,
                         "Min")
    return cases


def nms_device_ms(torch, fn, reps: int = 20) -> tuple[float, dict]:
    """Device ms per call of ``fn`` from a profiler trace: all kernels, and
    by kernel name."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name[:60]] += ev.time_range.elapsed_us() / 1e3 / reps
    return sum(by_name.values()), dict(by_name)


def phase_nms(ctx):
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
        boxes as tb,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        nms,
    )

    gen = torch.Generator().manual_seed(1)
    cases = {name: (_soups(torch, gen, s, n), th, m)
             for name, (s, n, th, m) in NMS_PATH.items()}
    cases["ties"] = (_soups(torch, gen, STREAMS, 1024, ties=True), 0.5,
                     "Union")
    cases["chain_1024"] = (torch.from_numpy(
        tb.adversarial_nms_chain(1024))[None].cuda(), 0.5, "Union")
    invalid = _soups(torch, gen, 1, 128)
    invalid[..., 4] = float("-inf")
    cases["all_invalid"] = (invalid, 0.5, "Union")
    cases.update(_nms_edge_cases(torch, gen))
    lib = nms._lib()
    report, worst = {}, 0
    for name, (b, th, m) in cases.items():
        got = nms.nms_mask_batched(b, th, m)
        want = nms.nms_mask_plain(b, th, m)
        torch.cuda.synchronize()
        diff = int((got != want).sum())
        worst = max(worst, int(diff > 0))
        report[name] = {"shape": list(b.shape[:2]), "kept": int(got.sum()),
                        "mismatches": diff,
                        "global_mode": bool(lib.nms_global_mode(b.shape[1]))}
    chain_keep = tb.nms_mask(cases["chain_1024"][0][0], 0.5).cpu()
    chain_ok = torch.equal(chain_keep.nonzero().flatten(),
                           torch.arange(0, 1024, 2))
    ms = plain_ms = nbytes = ops = 0.0
    calls = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in NMS_PATH:
        b, th, m = cases[name]
        k = time_ms(torch, lambda: nms.nms_mask_batched(b, th, m), 20)
        ms += k
        plain_ms += time_ms(torch, lambda: nms.nms_mask_plain(b, th, m), 3,
                            warmup=1)
        nbytes += b.numel() * 4 + b.shape[0] * b.shape[1]
        ops += 14 * _greedy_iou_count(b, th, m)
        dev, by_name = nms_device_ms(
            torch, lambda: nms.nms_mask_batched(b, th, m))
        calls[name] = {"wrapper_ms": k, "device_ms": dev,
                       "kernels": by_name,
                       "cluster": nms.cluster_size(*b.shape[:2], sms)}
    bound_ms, bound_by = bound(nbytes, ops)
    ok = worst == 0 and chain_ok
    ctx["kernels"]["nms"].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=None)
    return {"ok": ok, "tolerance": "masks exact", "cases": report,
            "chain_keeps_even_rows": chain_ok, "path_ms": ms,
            "path_device_ms": sum(c["device_ms"] for c in calls.values()),
            "path_plain_ms": plain_ms, "path_calls": calls,
            "smem_bytes": {name: lib.nms_smem_bytes(n)
                           for name, (_, n, _, _) in NMS_PATH.items()}}


# kernel B3's two path shapes, (B, H, W, C, maxout): a 16-crop serving
# dispatch (EFMNet342's conv1 at 64x64) and a LightCNN29 extraction batch
# (group1 at 128x128)
STEM_PATH = {"serving": (STREAMS, IMAGE, IMAGE, 99, 3),
             "lightcnn29": (128, 128, 128, 99, 3)}
# the checked cases: both path shapes and a ragged shape (edge tiles, W/2
# not a multiple of 4), all three at the compiled width (C=99, efm3);
# LightCNN9's mfm2 width and widths that no model uses (the instances that
# read their widths at run time, mfm2 and efm3), the last wide (C=1512:
# the f32 kernel holds 148 KB of taps in shared memory)
STEM_CASES = {**STEM_PATH, "ragged": (2, 30, 46, 99, 3),
              "mfm2_c96": (STREAMS, IMAGE, IMAGE, 96, 2),
              "other_c63": (2, 30, 46, 63, 3),
              "other_c48": (3, 12, 20, 48, 2),
              "wide_c1512": (1, 16, 20, 1512, 3)}


def stem_inputs(torch, gen, b, h, w, c):
    x = torch.rand(b, h, w, 1, generator=gen).cuda()
    wk = (torch.randn(5, 5, 1, c, generator=gen) / 5.0).cuda()
    bias = (torch.randn(c, generator=gen) * 0.1).cuda()
    return x, wk, bias


def stem_device_ms(torch, fn, reps: int = 20) -> tuple[float | None, dict]:
    """Kernel B3's own device ms per launch (``fn`` launches it once) from
    a profiler trace, as the mean of its events, so a trace that misses
    some events still reads right (None where the trace holds none: not
    measured); and every kernel's ms per call."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name, stem_us = defaultdict(float), []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_name[ev.name[:60]] += ev.time_range.elapsed_us() / 1e3 / reps
            if "stem" in ev.name:
                stem_us.append(ev.time_range.elapsed_us())
    ms = sum(stem_us) / len(stem_us) / 1e3 if stem_us else None
    return ms, dict(by_name)


def stem_timing(torch, F, mfm, stem, x, w, bias, maxout, dtype) -> dict:
    """Kernel B3 at one path shape in one dtype: the wrapper's ms (CUDA
    events), the kernel's own device ms (profiler), the wrapper's host us
    a call, the plain version's ms, one cuDNN conv + maxout + pool
    composite's ms, and the bound."""
    xs = x.to(dtype)
    xn = xs.permute(0, 3, 1, 2)
    wn, bn = w.to(dtype).permute(3, 2, 0, 1).contiguous(), bias.to(dtype)
    act = mfm.efm3_plain if maxout == 3 else mfm.mfm2

    def library():
        return F.max_pool2d(act(F.conv2d(xn, wn, bn, padding=2), 1), 2, 2)

    def kernel():
        return stem.stem_conv_maxout_pool(xs, w, bias, maxout=maxout)

    b, h, wd, _ = x.shape
    c = w.shape[3]
    c_out = c // 2 if maxout == 2 else 2 * (c // 3)
    reps = 50 if b * h * wd < 1 << 20 else 20
    device_ms, by_name = stem_device_ms(torch, kernel)
    n_io = x.numel() + b * (h // 2) * (wd // 2) * c_out
    ops = 2 * 25 * c * b * h * wd + 2 * b * h * wd * c
    tc = dtype == torch.bfloat16
    bound_ms, bound_by = bound(n_io * xs.element_size()
                               + (w.numel() + bias.numel()) * 4, ops,
                               BF16_TC_OPS_PER_S if tc else F32_OPS_PER_S)
    return {"ms": time_ms(torch, kernel, reps),
            "device_ms": device_ms, "device_kernels": by_name,
            "host_us_per_call": host_us(kernel, 200),
            "plain_ms": time_ms(torch, lambda: stem.stem_conv_maxout_pool_plain(
                xs, w, bias, maxout=maxout), reps),
            "library_ms": time_ms(torch, library, reps),
            "bound_ms": bound_ms, "bound_by": bound_by, "gflop": ops / 1e9}


def phase_stem(ctx):
    """Kernel B3 against its plain version at every case of STEM_CASES in
    f32 (1e-4) and bf16 (1e-2), then timed at both path shapes in both
    dtypes beside a cuDNN composite of the same layers (TF32 off)."""
    import torch
    import torch.nn.functional as F

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
        mfm,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        stem,
    )

    full_f32()   # cuDNN runs in the plain version and the yardstick

    gen = torch.Generator().manual_seed(2)
    cases, worst = {}, {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, (b, h, wd, c, maxout) in {
            **STEM_CASES, "misaligned": STEM_CASES["ragged"]}.items():
        x, w, bias = stem_inputs(torch, gen, b, h, wd, c)
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            xs = x.to(dtype)
            if name == "misaligned":
                # one element into its storage: the wrapper copies it to an
                # aligned buffer, as the kernels stage pairs of elements
                flat = torch.empty(xs.numel() + 1, dtype=dtype,
                                   device=xs.device)
                xs = flat[1:].view(xs.shape).copy_(xs)
            got = stem.stem_conv_maxout_pool(xs, w, bias, maxout=maxout)
            want = stem.stem_conv_maxout_pool_plain(xs, w, bias,
                                                    maxout=maxout)
            torch.cuda.synchronize()
            got, want = got.float(), want.float()
            err = float((got - want).abs().max())
            worst[dtype] = max(worst[dtype], err)
            # a comparison of outputs that are all zero would prove nothing
            mean_abs = float(want.abs().mean())
            cases[f"{name}_{str(dtype).split('.')[1]}"] = {
                "shape": list(got.shape), "max_abs_err": err,
                "tolerance": tol, "mean_abs": mean_abs,
                "ok": bool(torch.allclose(got, want, rtol=tol, atol=tol))
                and mean_abs > 1e-2}
    timing = {}
    for name, (b, h, wd, c, maxout) in STEM_PATH.items():
        x, w, bias = stem_inputs(torch, gen, b, h, wd, c)
        for dtype in (torch.float32, torch.bfloat16):
            timing[f"{name}_{str(dtype).split('.')[1]}"] = stem_timing(
                torch, F, mfm, stem, x, w, bias, maxout, dtype)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for kern, dtype in (("stem", "float32"), ("stem_bf16", "bfloat16")):
        t = timing[f"lightcnn29_{dtype}"]
        ctx["kernels"][kern].update(max_abs_err=worst[getattr(torch, dtype)],
                                    **{k: t[k] for k in keys})
    return {"ok": all(v["ok"] for v in cases.values()), "cases": cases,
            "library": "cuDNN conv2d + efm3 / mfm2 + max_pool2d (TF32 off)",
            "timing": timing}


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` (``time.perf_counter_ns`` over
    ``calls`` back-to-back calls, from an idle card: the enqueue cost)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t = (time.perf_counter_ns() - t0) / calls / 1e3
    torch.cuda.synchronize()
    return t


def phase_efm3(ctx):
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        efm3,
    )

    gen = torch.Generator().manual_seed(3)
    worst, ms, plain_ms, lib_ms, nbytes, ops = 0.0, 0.0, 0.0, 0.0, 0.0, 0.0
    calls, host, lib_host = 0, 0.0, 0.0
    shapes = {}
    for (rows, c), n in EFM3_PATH.items():
        x = torch.randn(rows, c, generator=gen).cuda()
        got = efm3.efm3_rows(x)
        want = efm3.efm3_rows_plain(x)
        exact = {"f32": bool(torch.equal(got, want))}
        for name, dt in (("bf16", torch.bfloat16), ("f16", torch.float16),
                         ("f64", torch.float64)):
            xd = x.to(dt)
            exact[name] = bool(torch.equal(efm3.efm3_rows(xd),
                                           efm3.efm3_rows_plain(xd)))
        # NaN at ~1% of the inputs: the same outputs are NaN, the rest equal
        xn = torch.where(torch.rand(rows, c, generator=gen).cuda() < 0.01,
                         float("nan"), x)
        gn, wn = efm3.efm3_rows(xn), efm3.efm3_rows_plain(xn)
        nan_out = gn.isnan()
        exact["nan"] = bool(torch.equal(nan_out, wn.isnan())) and bool(
            torch.equal(gn[~nan_out], wn[~nan_out]))
        worst = max(worst, float((got - want).abs().max()))
        t = c // 3
        k = time_ms(torch, lambda: efm3.efm3_rows(x), 50)
        p = time_ms(torch, lambda: efm3.efm3_rows_plain(x), 50)
        lib = time_ms(torch, lambda: torch.aminmax(x.view(rows, 3, t), dim=1),
                      50)
        h = host_us(lambda: efm3.efm3_rows(x))
        lh = host_us(lambda: torch.aminmax(x.view(rows, 3, t), dim=1))
        ms, plain_ms, lib_ms = ms + n * k, plain_ms + n * p, lib_ms + n * lib
        host, lib_host = host + n * h, lib_host + n * lh
        nbytes += n * (rows * c + rows * 2 * t) * 4
        ops += n * rows * 2 * t * 2          # two compares per output
        calls += n
        shapes[f"{rows}x{c}"] = {"calls": n, "exact": exact,
                                 "nan_outputs": int(nan_out.sum()), "ms": k,
                                 "host_us_per_call": h}
    # where a call's host time goes, at the last shape: the output's
    # allocation, and the ctypes launch alone into a preallocated output
    fn, stream = efm3._fns()
    o, dev = efm3.efm3_rows(x), x.get_device()
    host_parts = {
        "shape": [rows, c],
        "alloc_us": host_us(lambda: x.new_empty(o.shape)),
        "ctypes_launch_us": host_us(lambda: fn(
            x.data_ptr(), o.data_ptr(), rows, t, 0, stream(dev))),
        "wrapper_us": h}
    bound_ms, bound_by = bound(nbytes, ops)
    ctx["kernels"]["efm3"].update(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=lib_ms)
    ok = worst == 0.0 and all(all(v["exact"].values())
                              for v in shapes.values())
    return {"ok": ok, "tolerance": "exact (f32, bf16, f16, f64; NaN "
                                   "positions equal)",
            "calls_per_forward": calls, "forward_ms": ms,
            "forward_plain_ms": plain_ms, "forward_aminmax_ms": lib_ms,
            "forward_bound_ms": bound_ms,
            "host_us_per_call": host / calls,
            "aminmax_host_us_per_call": lib_host / calls,
            "host_parts": host_parts, "shapes": shapes}


def _serving_checks(torch, out, cpu, dim: int) -> tuple[dict, dict]:
    """The serving path's answers on the card against the CPU rerun of the
    same frames and weights: found, index and cap_dropped exact, box at
    1e-2, embedding at 1e-3."""
    found = out["found"]
    checks = {
        "shapes": (tuple(out["box"].shape) == (STREAMS, 4)
                   and tuple(out["embedding"].shape) == (STREAMS, dim)),
        "finite": bool(torch.isfinite(out["embedding"]).all()),
        "unit_norm": bool(((out["embedding"][found].norm(dim=-1) - 1).abs()
                           < 1e-4).all()),
        "found_equal": bool(torch.equal(found, cpu["found"])),
        "index_equal": bool(torch.equal(out["index"], cpu["index"])),
        "cap_dropped_equal": bool(torch.equal(out["cap_dropped"],
                                              cpu["cap_dropped"])),
    }
    both = found & cpu["found"]
    box_err = float((out["box"][both] - cpu["box"][both]).abs().max()) \
        if both.any() else 0.0
    emb_err = float((out["embedding"][both]
                     - cpu["embedding"][both]).abs().max()) \
        if both.any() else 0.0
    checks["box_atol_1e-2"] = box_err <= 1e-2
    checks["embedding_atol_1e-3"] = emb_err <= 1e-3
    return checks, {"found": int(found.sum()),
                    "box_max_err_vs_cpu": box_err,
                    "embedding_max_err_vs_cpu": emb_err,
                    "cap_dropped": out["cap_dropped"].tolist()}


def _serve(ctx, path: str, argv, dim: int) -> dict:
    """serve_demo on the card with the launch counts of ``path`` read
    around it, then on the CPU with the same seed (same weights and
    frames), held to :func:`_serving_checks`."""
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )

    for c in ctx["counters"].values():
        c.reset()
    res = serve_demo.main(argv("cuda"))
    torch.cuda.synchronize()
    cli_tf32_off = tf32_off()
    launches = read_launches(ctx, path)
    dispatches = res["dispatches"] + 1
    out = {k: v.cpu() for k, v in res["out"].items()}
    cpu = serve_demo.main(argv("cpu"))["out"]
    checks, report = _serving_checks(torch, out, cpu, dim)
    checks["launched"] = all(n > 0 for n in launches.values())
    checks["cli_turned_tf32_off"] = cli_tf32_off
    return {"checks": checks, "frames_per_s": res["fps"],
            "first_dispatch_s": res["first_s"], "dispatches": dispatches,
            "launches": launches,
            "launches_per_dispatch": {k: v / dispatches
                                      for k, v in launches.items()},
            **report}


def phase_slice(ctx):
    r = _serve(ctx, "slice", lambda dev: slice_argv(
        STREAMS if dev == "cpu" else 64, dev), 342)
    return {"ok": all(r["checks"].values()), **r}


def serve9_argv(frames: int, device: str) -> list[str]:
    """serve_demo's arguments for LightCNN9 serving: the slice's 16 streams
    of 240x320 frames, LightCNN9 on 128x128 crops (its published input)."""
    return [
        "--streams", str(STREAMS), "--frames", str(frames),
        "--frame-size", str(FRAME_HW[0]), str(FRAME_HW[1]),
        "--image-size", "128", "--model", "lightcnn9", "--identities",
        "1000", "--det-thresholds", "0.3", "0.3", "0.3", "--device", device]


def phase_serve9(ctx):
    r = _serve(ctx, "serve9", lambda dev: serve9_argv(
        STREAMS if dev == "cpu" else 2 * STREAMS, dev), 256)
    r["checks"]["front9_once_per_dispatch"] = (
        r["launches"]["front9"] == r["dispatches"])
    return {"ok": all(r["checks"].values()), **r}


def read_launches(ctx, path: str) -> dict[str, int]:
    """The launch counts of ``path``'s kernels; the kernels line keeps each
    kernel's count from the first path run that launched it."""
    launches = {k: ctx["counters"][k].count for k in PATH_KERNELS[path]}
    read_launches_from(ctx, launches)
    return launches


def _int_rows(torch, rng, b, n, d, ids, *, pos_sq=None, one_label=False):
    """Mining inputs with coordinates in {-1, 0, 1}: every product and sum
    is exact in float32, so the kernel and the plain version must pick the
    same index, ties (which are common) included."""
    import numpy as np

    anc = rng.integers(-1, 2, (b, d)).astype(np.float32)
    pool = rng.integers(-1, 2, (n, d)).astype(np.float32)
    ps = (rng.integers(0, 2 * d, b).astype(np.float32) if pos_sq is None
          else np.full(b, pos_sq, np.float32))
    al, pl = rng.integers(0, ids, b), rng.integers(0, ids, n)
    if one_label:
        al[:], pl[:] = 0, 0
    return [torch.from_numpy(x).cuda() for x in (anc, ps, al, pool, pl)]


def head_path_inputs(torch, seed: int = 0):
    """What the head step hands kernel B1 at the path shape: one
    ``PairBatcher`` batch of 16384 anchors and positives from the synthetic
    store, through a random 342->128 head, L2-normalized; the pool is
    ``[anchors | positives]``."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        PairBatcher,
        synthetic_features,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.heads import (
        LinearHead,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.distances import (
        l2_normalize,
    )

    feats, labels = synthetic_features(num_ids=HEAD_IDS, per_id=HEAD_PER_ID,
                                       dim=FEAT_DIM, seed=seed)
    anchor, positive, lab = next(iter(PairBatcher(feats, labels, HEAD_BATCH,
                                                  seed=seed)))
    head = LinearHead(FEAT_DIM, EMB_DIM,
                      generator=torch.Generator().manual_seed(seed)).cuda()
    with torch.no_grad():
        x = torch.from_numpy(np.concatenate([anchor, positive])).cuda()
        pool_n = l2_normalize(head(x))
    lab = torch.from_numpy(lab).cuda().to(torch.int32)
    anc_n = pool_n[:HEAD_BATCH]
    pos_sq = ((anc_n - pool_n[HEAD_BATCH:]) ** 2).sum(1)
    return anc_n, pos_sq, lab, pool_n, torch.cat([lab, lab])


def phase_mining(ctx):
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        mining,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.distances import (
        pairwise_sq_l2,
    )

    rng = np.random.default_rng(5)
    b, n = HEAD_BATCH, 2 * HEAD_BATCH
    exact = {"64x128x32": _int_rows(torch, rng, 64, 128, 32, 10),
             "16x16x32": _int_rows(torch, rng, 16, 16, 32, 10),
             "1000x3000x128": _int_rows(torch, rng, 1000, 3000, EMB_DIM, 50),
             "3x5x3": _int_rows(torch, rng, 3, 5, 3, 2),
             "fallback": _int_rows(torch, rng, 256, 700, 64, 20,
                                   pos_sq=1e6),
             "one_label": _int_rows(torch, rng, 100, 300, 16, 1,
                                    one_label=True),
             # B, N off the 128-row tiles and D = 100 off the 32-float
             # chunks: the zero pad and TMA's out-of-range rows
             "ragged_1000x3001x100": _int_rows(torch, rng, 1000, 3001, 100,
                                               50),
             # one anchor tile: the pool split over the SMs, then merged
             "small_b_100x20000x128": _int_rows(torch, rng, 100, 20000,
                                                EMB_DIM, 50),
             # D > 128: the anchor chunks stream through the ring as well
             "wide_d_300x2000x160": _int_rows(torch, rng, 300, 2000, 160,
                                              30),
             "path_shape_int": _int_rows(torch, rng, b, n, EMB_DIM, HEAD_IDS)}
    lib = mining._lib()
    cases = {}
    for name, x in exact.items():
        got, want = mining.semi_hard_mining(*x), mining.semi_hard_mining_plain(*x)
        torch.cuda.synchronize()
        cb, cn = x[0].shape[0], x[3].shape[0]
        cases[name] = {"shape": [cb, cn, x[0].shape[1]],
                       "splits": lib.mining_splits(cb, cn),
                       "mismatches": int((got != want).sum())}
    exact_ok = all(c["mismatches"] == 0 for c in cases.values())

    # the path shape on real head outputs: 3xTF32 products and summation
    # orders differ from cuBLAS's, so a near-tie may go the other way; hold
    # each pick to the plain pick's distance (recomputed in float64) and
    # side of pos_sq
    anc, pos_sq, al, pool, pl = x = head_path_inputs(torch)
    got = mining.semi_hard_mining(*x).long()
    want = mining.semi_hard_mining_plain(*x).long()
    dist = lambda idx: ((anc.double() - pool[idx].double()) ** 2).sum(1)  # noqa: E731
    d_got, d_want = dist(got), dist(want)
    side_differs = (d_got > pos_sq.double()) != (d_want > pos_sq.double())
    near = torch.zeros_like(side_differs)
    for i in side_differs.nonzero().flatten().tolist():
        sq = pairwise_sq_l2(anc[i:i + 1], pool)[0]
        near[i] = bool(((sq - pos_sq[i]).abs() < 1e-5)[pl != al[i]].any())
    gap = (d_got - d_want).abs()
    checks = {"exact_cases_equal": exact_ok,
              "small_b_takes_the_split_merge": cases[
                  "small_b_100x20000x128"]["splits"] > 1,
              "picks_are_negatives": bool((pl[got] != al).all()),
              "distance_within_1e-5": bool(((gap <= 1e-5) | near).all()),
              "same_side_of_pos_sq": bool((~side_differs | near).all())}
    ms = time_ms(torch, lambda: mining.semi_hard_mining(*x), 20)
    plain_ms = time_ms(torch, lambda: mining.semi_hard_mining_plain(*x), 5,
                       warmup=2)
    # yardsticks, neither of them B1's function: cuBLAS's f32 GEMM of the
    # product alone, and the same GEMM in TF32 (one pass, TF32 on for that
    # timing only)
    gemm_ms = time_ms(torch, lambda: anc @ pool.T, 20)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32_gemm_ms = time_ms(torch, lambda: anc @ pool.T, 20)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    d = anc.shape[1]
    nbytes = (b * d + n * d) * 4 + b * 4 + (b + n) * 4 + b * 4
    # three TF32 products on the tensor cores; the epilogue (~8 operations
    # a distance) and the norms on the CUDA cores
    f32_ops = 8 * b * n + 2 * (b + n) * d
    bound_ms, bound_by = bound(nbytes, 3 * 2 * b * n * d, TF32_TC_OPS_PER_S)
    bound_ms = max(bound_ms, f32_ops / F32_OPS_PER_S * 1e3)
    # the CUDA-core kernel's bound (every operation at the f32 rate)
    cuda_core_bound_ms, _ = bound(nbytes, 2 * b * n * d + f32_ops)
    ctx["kernels"]["mining"].update(
        max_abs_err=float(gap.max()), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return {"ok": all(checks.values()), "checks": checks,
            "tolerance": "indices exact on exact inputs; at the path shape "
                         "pick distance within 1e-5 (float64) and same side "
                         "of pos_sq unless a candidate is within 1e-5 of it",
            "exact_cases": cases, "path_shape": [b, n, d],
            "path_splits": lib.mining_splits(b, n),
            "path_index_differences": int((got != want).sum()),
            "path_max_distance_gap": float(gap.max()),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "f32_cuda_core_bound_ms": cuda_core_bound_ms,
            "effective_tflops": 2 * b * n * d / ms / 1e9,
            "tensor_core_share_of_bound": bound_ms / ms,
            "cublas_f32_gemm_ms": gemm_ms, "cublas_tf32_gemm_ms": tf32_gemm_ms}


def _epoch_cos_means(csv: str, rows_per_epoch: int):
    import numpy as np

    data = np.loadtxt(csv, dtype=np.float64, ndmin=2)
    epochs = data.reshape(-1, rows_per_epoch, 2)
    return data.shape[0], epochs.mean(1)


def phase_head(ctx):
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        train_head,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        save_feature_store,
        split_identities,
        synthetic_features,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.export import (
        load_exported_params,
    )

    feats, labels = synthetic_features(num_ids=HEAD_IDS, per_id=HEAD_PER_ID,
                                       dim=FEAT_DIM, seed=0)
    train_mask, test_mask = split_identities(labels, 0.7)
    train_steps = int(train_mask.sum()) // HEAD_BATCH
    eval_steps = int(test_mask.sum()) // HEAD_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        store = {}
        for name, mask in (("train", train_mask), ("test", test_mask)):
            store[name] = os.path.join(tmp, f"{name}.npz")
            save_feature_store(store[name], feats[mask], labels[mask])

        def run(mining_mode):
            out = os.path.join(tmp, mining_mode)
            state, hist = train_head.main([
                "--features", store["train"], "--test-features",
                store["test"], "--batch-size", str(HEAD_BATCH), "--epochs",
                str(HEAD_EPOCHS), "--mining", mining_mode, "--device", "cuda",
                "--out-dir", out])
            torch.cuda.synchronize()
            rows, cos = _epoch_cos_means(
                os.path.join(out, "cosine_similarity.csv"),
                train_steps * HEAD_BATCH)
            return out, hist, rows, cos

        for c in ctx["counters"].values():
            c.reset()
        out, hist, rows, cos = run("semi_hard_fused")
        launches = read_launches(ctx, "head")
        cli_tf32_off = tf32_off()
        params, _, manifest = load_exported_params(os.path.join(out,
                                                                "export"))
        _, plain_hist, plain_rows, plain_cos = run("semi_hard")

    losses = [s["loss"] for h in hist for s in h.steps]
    plain_losses = [s["loss"] for h in plain_hist for s in h.steps]
    rel = [abs(a - b) / max(abs(b), 1e-12)
           for a, b in zip(losses, plain_losses)]
    cos_gap = float(np.abs(cos - plain_cos).max())
    steps = HEAD_EPOCHS * (train_steps + eval_steps)
    checks = {
        "launches_equal_steps": launches["mining"] == steps,
        "losses_finite": bool(np.isfinite(losses + [h.valid["loss"]
                                                    for h in hist]).all()),
        "csv_rows": rows == HEAD_EPOCHS * train_steps * HEAD_BATCH,
        "export_loads": (manifest["model"] == "linear_head"
                         and params["proj"]["kernel"].shape
                         == (FEAT_DIM, EMB_DIM)),
        "plain_run_same_steps": len(plain_losses) == len(losses),
        "epoch_cos_means_atol_1e-4": cos_gap <= 1e-4,
        "step_loss_rtol_1e-2": max(rel) <= 1e-2,
        "cli_turned_tf32_off": cli_tf32_off,
    }
    step_s = [s["seconds"] for h in hist for s in h.steps]
    plain_step_s = [s["seconds"] for h in plain_hist for s in h.steps]
    return {"ok": all(checks.values()), "checks": checks,
            "launches": launches, "steps": steps,
            "train_steps_per_epoch": train_steps,
            "eval_steps_per_epoch": eval_steps,
            "losses": losses, "plain_losses": plain_losses,
            "valid_loss": [h.valid["loss"] for h in hist],
            "epoch_cos_means": cos.tolist(),
            "plain_epoch_cos_means": plain_cos.tolist(),
            "max_epoch_cos_mean_gap": cos_gap, "max_step_loss_rel_gap": max(rel),
            "train_step_s": step_s, "plain_train_step_s": plain_step_s,
            "card": torch.cuda.get_device_name(0)}


# LightCNN9's front-half widths: conv1 96 -> 48, conv2a 96 -> 48, conv2
# 192 -> 96 (the JAX package's models/lightcnn.py::LightCNN9)
C1, C2A, C2 = 96, 96, 192
EXTRACT_BATCH = 128
# the least cosine between an embedding of the --bf16 extraction and the
# f32 one: the JAX package's own bf16 LightCNN9 stays above 0.99995 on the
# CPU (32-128 px, random weights, synthetic faces;
# tests/test_torch_lightcnn.py), and the bound leaves 20x that gap
BF16_COS_MIN = 0.999


def front9_params(torch, gen, c1=C1, c2a=C2A, c2=C2):
    """Random conv1/conv2a/conv2 weights in the flax layout (HWIO), scaled
    like tests/test_pallas_kernels.py::_front9_params, on the card."""
    def t(shape, s):
        return (torch.randn(*shape, generator=gen) * s).cuda()

    return {"conv1": {"kernel": t((5, 5, 1, c1), 0.1), "bias": t((c1,), 0.1)},
            "conv2a": {"kernel": t((1, 1, c1 // 2, c2a), 0.1),
                       "bias": t((c2a,), 0.1)},
            "conv2": {"kernel": t((3, 3, c2a // 2, c2), 0.05),
                      "bias": t((c2,), 0.1)}}


def _nchw_conv(F, x, kernel, bias, padding):
    return F.conv2d(x, kernel.permute(3, 2, 0, 1), bias, padding=padding)


def bf16_ulps(torch, a, b):
    """|a - b| in units in the last place of bf16 at the larger of |a| and
    |b| (8 significant bits: ulp(v) = 2^(e - 8) for v = m 2^e, 0.5 <= m <
    1)."""
    a, b = a.double(), b.double()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    ulp = torch.ldexp(torch.ones_like(a), (e - 8).clamp(min=-133))
    return (a - b).abs() / ulp


def phase_front9(ctx):
    import torch
    import torch.nn.functional as F

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
        mfm,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        front9,
    )

    full_f32()   # cuDNN runs in the plain version and the yardstick

    gen = torch.Generator().manual_seed(6)
    params = front9_params(torch, gen)
    cases = {"path_128x128x128": (EXTRACT_BATCH, 128),
             "tile_edge_2x68x68": (2, 68), "batch1_128": (1, 128),
             "small_3x12x12": (3, 12)}
    out, worst, worst_bf16 = {}, 0.0, 0.0
    for name, (b, hw) in cases.items():
        x = torch.rand(b, hw, hw, 1, generator=gen).cuda()
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            xs = x.to(dtype)
            got = front9.front9_chain(xs, params)
            want = front9.front9_plain(xs, params)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            # a comparison of outputs that are all zero would prove nothing
            mean_abs = float(want.float().abs().mean())
            rec = {"max_abs_err": err, "tolerance": tol, "mean_abs": mean_abs,
                   "shape": list(got.shape)}
            ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                     atol=tol)) and mean_abs > 1e-2
            if dtype == torch.float32:
                # the f32 kernel sums in the plain version's order
                worst = max(worst, err)
                rec["exact"] = bool(torch.equal(got, want))
                ok = ok and rec["exact"]
            else:
                # the tensor cores sum in another order: report how often
                # a bf16 rounding tips, and by how far
                worst_bf16 = max(worst_bf16, err)
                differ = got != want
                rec.update(differing=int(differ.sum()),
                           differing_share=float(differ.float().mean()),
                           max_ulps=float(bf16_ulps(torch, got, want).max()))
            rec["ok"] = ok
            out[f"{name}_{str(dtype).split('.')[1]}"] = rec
    b, hw = cases["path_128x128x128"]
    x = torch.rand(b, hw, hw, 1, generator=gen).cuda()
    xb = x.to(torch.bfloat16)
    packed = front9.pack_front9_weights(params, torch.float32)
    packed_bf = front9.pack_front9_weights(params, torch.bfloat16)
    p32 = {k: (v["kernel"], v["bias"]) for k, v in params.items()}
    pbf = {k: (v["kernel"].bfloat16(), v["bias"].bfloat16())
           for k, v in params.items()}

    def composite(xn, p):
        # cuDNN composite of the same layers (TF32 off)
        y = F.max_pool2d(mfm.mfm2(_nchw_conv(F, xn, *p["conv1"], 2), 1), 2, 2)
        y = mfm.mfm2(_nchw_conv(F, y, *p["conv2a"], 0), 1)
        y = mfm.mfm2(_nchw_conv(F, y, *p["conv2"], 1), 1)
        return F.max_pool2d(y, 2, 2)

    xn, xbn = x.permute(0, 3, 1, 2), xb.permute(0, 3, 1, 2)
    lib_err = float((composite(xn, p32).permute(0, 2, 3, 1)
                     - front9.front9_plain(x, params)).abs().max())
    ms = time_ms(torch, lambda: front9.front9_chain(x, params, packed), 20)
    plain_ms = time_ms(torch, lambda: front9.front9_plain(x, params), 10)
    library_ms = time_ms(torch, lambda: composite(xn, p32), 10)
    ms_bf = time_ms(torch, lambda: front9.front9_chain(xb, params, packed_bf),
                    50)
    plain_bf = time_ms(torch, lambda: front9.front9_plain(xb, params), 10)
    library_bf = time_ms(torch, lambda: composite(xbn, pbf), 20)
    h2 = hw // 2
    ops = 2 * b * (hw * hw * 25 * C1 + h2 * h2 * (C1 // 2) * C2A
                   + h2 * h2 * 9 * (C2A // 2) * C2)
    n_w = sum(v["kernel"].numel() for v in params.values())
    n_b = sum(v["bias"].numel() for v in params.values())
    n_out = b * (hw // 4) ** 2 * (C2 // 2)
    bound_ms, bound_by = bound((x.numel() + n_w + n_b + n_out) * 4, ops)
    bound_bf, bound_by_bf = bound(
        (x.numel() + n_w + n_out) * 2 + n_b * 4, ops, BF16_TC_OPS_PER_S)
    ctx["kernels"]["front9"].update(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    ctx["kernels"]["front9_bf16"].update(
        max_abs_err=worst_bf16, ms=ms_bf, plain_ms=plain_bf,
        bound_ms=bound_bf, bound_by=bound_by_bf, library_ms=library_bf)
    return {"ok": all(v["ok"] for v in out.values()) and lib_err < 1e-4,
            "cases": out, "tile": 8,
            "smem_bytes_per_cta": front9.smem_bytes(C1, C2A),
            "smem_bytes_per_cta_bf16": front9.tc_smem_bytes(),
            "library": "cuDNN conv2d x3 + mfm2 + max_pool2d x2 (TF32 off)",
            "library_vs_plain_max_abs_err": lib_err,
            "path_shape": [b, hw, hw, 1], "gflop": ops / 1e9,
            "f32": {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "tflops": ops / ms / 1e9},
            "bf16": {"ms": ms_bf, "plain_ms": plain_bf,
                     "library_ms": library_bf, "bound_ms": bound_bf,
                     "tflops": ops / ms_bf / 1e9}}


def phase_stem2(ctx):
    import torch
    import torch.nn.functional as F

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
        mfm,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        stem,
    )

    full_f32()   # cuDNN runs in the plain version and the yardstick

    gen = torch.Generator().manual_seed(7)
    params = front9_params(torch, gen)
    w, bias = params["conv1"]["kernel"], params["conv1"]["bias"]
    w2, bias2 = params["conv2a"]["kernel"], params["conv2a"]["bias"]
    # the path shape, edge tiles, one image, the smallest even shapes, and
    # far more tiles than the persistent grid has CTAs
    cases = {"path_128x112x96": (EXTRACT_BATCH, 112, 96),
             "odd_tiles_3x30x46": (3, 30, 46), "batch1_112x96": (1, 112, 96),
             "smallest_2x2x2": (2, 2, 2), "small_3x4x6": (3, 4, 6),
             "many_tiles_256x112x96": (256, 112, 96)}
    out, worst = {}, 0.0
    for name, (b, h, wd) in cases.items():
        x = torch.rand(b, h, wd, 1, generator=gen).cuda()
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            xs = x.to(dtype)
            got = stem.stem2_conv(xs, w, bias, w2, bias2).float()
            want = stem.stem2_conv_plain(xs, w, bias, w2, bias2).float()
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if dtype == torch.float32:
                worst = max(worst, err)
            # a comparison of outputs that are all zero would prove nothing
            mean_abs = float(want.abs().mean())
            out[f"{name}_{str(dtype).split('.')[1]}"] = {
                "max_abs_err": err, "tolerance": tol, "mean_abs": mean_abs,
                "exact": bool(torch.equal(got, want)),
                "ok": bool(torch.allclose(got, want, rtol=tol, atol=tol))
                and mean_abs > 1e-2, "shape": list(got.shape)}
    b, h, wd = cases["path_128x112x96"]
    x = torch.rand(b, h, wd, 1, generator=gen).cuda()
    xn = x.permute(0, 3, 1, 2)

    def library():
        y = F.max_pool2d(mfm.mfm2(_nchw_conv(F, xn, w, bias, 2), 1), 2, 2)
        return mfm.mfm2(_nchw_conv(F, y, w2, bias2, 0), 1)

    ms = time_ms(torch, lambda: stem.stem2_conv(x, w, bias, w2, bias2), 50)
    plain_ms = time_ms(torch, lambda: stem.stem2_conv_plain(
        x, w, bias, w2, bias2), 20)
    library_ms = time_ms(torch, library, 20)
    ops = 2 * b * (h * wd * 25 * C1 + (h // 2) * (wd // 2) * (C1 // 2) * C2A)
    n_out = b * (h // 2) * (wd // 2) * (C2A // 2)
    n_w = w.numel() + bias.numel() + w2.numel() + bias2.numel()
    nbytes = (x.numel() + n_w + n_out) * 4
    bound_ms, bound_by = bound(nbytes, ops)
    ctx["kernels"]["stem2"].update(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    # bf16 at the same shape: the kernel (bf16 in and out, f32 sums on the
    # CUDA cores) against the same composite in bf16 (cuDNN's tensor cores)
    xb = x.bfloat16()
    xbn = xb.permute(0, 3, 1, 2)
    wb, bb, w2b, b2b = (t.bfloat16() for t in (w, bias, w2, bias2))

    def library_bf16():
        y = F.max_pool2d(mfm.mfm2(_nchw_conv(F, xbn, wb, bb, 2), 1), 2, 2)
        return mfm.mfm2(_nchw_conv(F, y, w2b, b2b, 0), 1)

    bf16 = {"ms": time_ms(torch, lambda: stem.stem2_conv(
                xb, w, bias, w2, bias2), 50),
            "plain_ms": time_ms(torch, lambda: stem.stem2_conv_plain(
                xb, w, bias, w2, bias2), 20),
            "library_ms": time_ms(torch, library_bf16, 20),
            "bound_ms": bound((x.numel() + n_out) * 2 + n_w * 4, ops)[0]}
    return {"ok": all(v["ok"] for v in out.values()), "cases": out,
            "library": "cuDNN conv2d x2 + mfm2 + max_pool2d, f32",
            "path_shape": [b, h, wd, 1], "gflop": ops / 1e9, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bf16_timing": bf16}


# the extraction runs: (model, store kind, image side(s), rows on the card,
# rows rerun on the CPU, the kernels that must launch once per batch)
EXTRACT_RUNS = {
    "lightcnn9_128": ("lightcnn9", "mmap", (128, 128), 4096, 16,
                      {"front9": 1, "front9_bf16": 0, "stem2": 0}),
    "lightcnn9_112x96": ("lightcnn9", "npz", (112, 96), 1024, 16,
                         {"stem2": 1, "front9": 0, "front9_bf16": 0}),
    "lightcnn29_128": ("lightcnn29", "npz", (128, 128), 512, 8,
                       {"stem": 1, "stem_bf16": 0, "efm3": 29}),
}
# the --bf16 reruns of some of those stores, held to the f32 features by
# cosine: the kernels that must launch once per batch (or never)
EXTRACT_BF16_RUNS = {
    "lightcnn9_128": {"front9_bf16": 1, "front9": 0},
    "lightcnn29_128": {"stem_bf16": 1, "stem": 0, "efm3": 29},
}


def _extract(ctx, store: str, model: str, device: str, out: str,
             batch: int, bf16: bool = False):
    """One ``extract_features`` run over ``store``, the launch counts of
    the extraction path read around it."""
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        extract_features,
    )

    for c in ctx["counters"].values():
        c.reset()
    res = extract_features.main(
        ["--train-images", store, "--model", model, "--batch-size",
         str(batch), "--device", device, "--out-dir", out]
        + (["--bf16"] if bf16 else []))["train"]
    if device == "cuda":
        torch.cuda.synchronize()
    return res, ({k: c.count for k, c in ctx["counters"].items()
                  if k in PATH_KERNELS["extract"]})


def phase_extract(ctx):
    """``extract_features`` on the card with random seeded weights over
    synthetic-face stores: LightCNN9 at 128x128 from a uint8 mmap store
    (B6 once per batch), LightCNN9 on a 112x96 center crop from an .npz
    store (B4 once per batch), LightCNN29 at 128x128 (B3 once and B2 29
    times per batch). Each run's first rows are rerun on the CPU by the
    same CLI (same seed, same weights): features within 1e-4, equal
    predictions. --bf16 runs of LightCNN9 at 128x128 (B6 on the tensor
    cores) and LightCNN29 (B3 on the tensor cores, B2 in bf16) are held to
    the f32 ones by cosine (BF16_COS_MIN). Rows/s are the CLI's extraction
    seconds: a parity run, not a benchmark (tools/profile_extract_torch.py
    measures)."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        load_feature_store,
        save_image_store,
        save_image_store_mmap,
        synthetic_faces,
    )

    faces, labels = synthetic_faces(num_ids=256, per_id=16, size=128, seed=0)
    runs, checks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (model, kind, (h, w), rows, cpu_rows, per_batch) in \
                EXTRACT_RUNS.items():
            y0, x0 = (faces.shape[1] - h) // 2, (faces.shape[2] - w) // 2
            imgs = faces[:rows, y0:y0 + h, x0:x0 + w]
            store = os.path.join(tmp, name + ("" if kind == "mmap" else ".npz"))
            (save_image_store_mmap if kind == "mmap" else save_image_store)(
                store, imgs, labels[:rows])
            cpu_store = os.path.join(tmp, name + "_cpu.npz")
            save_image_store(cpu_store, imgs[:cpu_rows], labels[:cpu_rows])
            out = os.path.join(tmp, name)
            res, launches = _extract(ctx, store, model, "cuda", out,
                                     EXTRACT_BATCH)
            cli_tf32_off = tf32_off()
            read_launches_from(ctx, launches)
            cpu, _ = _extract(ctx, cpu_store, model, "cpu", out + "_cpu",
                              cpu_rows)
            batches = -(-rows // EXTRACT_BATCH)
            feat_err = float(np.abs(res.features[:cpu_rows]
                                    - cpu.features).max())
            stored, _ = load_feature_store(os.path.join(out, "train.npz"))
            csv_rows = sum(1 for _ in open(os.path.join(
                out, "feature_vector_train.csv")))
            run_checks = {
                f"{k}_launches": launches[k] == n * batches
                for k, n in per_batch.items()}
            run_checks.update({
                "features_atol_1e-4_vs_cpu": feat_err <= 1e-4,
                "predictions_equal_cpu": bool(np.array_equal(
                    res.predictions[:cpu_rows], cpu.predictions)),
                "finite": bool(np.isfinite(res.features).all()),
                "shapes": (res.features.shape == (rows, 256 if model
                                                  == "lightcnn9" else 684)),
                "files": stored.shape == res.features.shape
                and csv_rows == rows,
                "cli_turned_tf32_off": cli_tf32_off})
            checks.update({f"{name}:{k}": v for k, v in run_checks.items()})
            runs[name] = {"rows": rows, "batches": batches,
                          "launches": launches,
                          "features_max_err_vs_cpu": feat_err,
                          "accuracy": res.accuracy,
                          "extract_s": res.seconds,
                          "embeddings_per_s": rows / res.seconds,
                          "cpu_rows": cpu_rows}
            if name in EXTRACT_BF16_RUNS:
                f32 = res.features
                bf, bf_launches = _extract(ctx, store, model, "cuda",
                                           out + "_bf16", EXTRACT_BATCH,
                                           bf16=True)
                cos = (bf.features.astype(np.float64) * f32).sum(1) / (
                    np.linalg.norm(bf.features, axis=1)
                    * np.linalg.norm(f32, axis=1))
                read_launches_from(ctx, bf_launches)
                for k, n in EXTRACT_BF16_RUNS[name].items():
                    checks[f"{name}_bf16:{k}_launches"] = (
                        bf_launches[k] == n * batches)
                checks[f"{name}_bf16:cos_min_{BF16_COS_MIN}"] = bool(
                    cos.min() >= BF16_COS_MIN)
                runs[f"{name}_bf16"] = {
                    "rows": rows, "launches": bf_launches,
                    "cos_vs_f32_min": float(cos.min()),
                    "cos_vs_f32_mean": float(cos.mean()),
                    "extract_s": bf.seconds,
                    "embeddings_per_s": rows / bf.seconds}
    return {"ok": all(checks.values()), "checks": checks, "runs": runs,
            "tolerance": "features atol 1e-4 and equal predictions vs the "
                         f"CPU rerun; bf16 cosine >= {BF16_COS_MIN}"}


def read_launches_from(ctx, launches: dict[str, int]) -> None:
    """Record counts read from a path's run for the kernels line (the first
    run that launched each kernel)."""
    for name, n in launches.items():
        if n and ctx["kernels"][name].get("launches") is None:
            ctx["kernels"][name]["launches"] = n


PHASES = {"build": phase_build, "nms": phase_nms, "stem": phase_stem,
          "efm3": phase_efm3, "mining": phase_mining, "front9": phase_front9,
          "stem2": phase_stem2, "slice": phase_slice, "head": phase_head,
          "extract": phase_extract, "serve9": phase_serve9}


def pytorch_defaults(torch) -> None:
    """PyTorch's own TF32 settings: cuDNN's float32 convolutions in TF32,
    float32 matrix products in full float32."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


def tf32_off() -> bool:
    """Whether the CLI just run turned TF32 off for convs and matmuls."""
    import torch

    return (not torch.backends.cudnn.allow_tf32
            and not torch.backends.cuda.matmul.allow_tf32)


def full_f32() -> None:
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.device import (
        full_f32 as port_full_f32,
    )

    port_full_f32()


def main(argv: list[str]) -> int:
    """Run every phase, or only the phases named in ``argv`` (after the
    build), as ``python3 chip_smoke.py build front9`` does."""
    unknown = [a for a in argv if a not in PHASES]
    if unknown:
        print(f"chip_smoke: unknown phases {unknown}; known: "
              f"{', '.join(PHASES)}", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs "
              "only on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside chip_smoke.py; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        efm3,
        front9,
        mining,
        nms,
        stem,
    )

    pkg = os.path.join(PKG, "")
    ctx = {
        "counters": {"nms": nms.launches, "stem": stem.launches,
                     "efm3": efm3.launches, "mining": mining.launches,
                     "front9": front9.launches,
                     "front9_bf16": front9.tc_launches,
                     "stem2": stem.stem2_launches,
                     "stem_bf16": stem.bf16_launches},
        "kernels": {
            "nms": {"name": "nms", "route": "cuda",
                    "source": pkg + "csrc/nms.cu",
                    "replaces": JAX_PKG + "/ops/pallas/nms_kernel.py:118"},
            "stem": {"name": "stem", "route": "cuda",
                     "source": pkg + "csrc/stem.cu",
                     "replaces": JAX_PKG + "/ops/pallas/stem_kernel.py:130"},
            "efm3": {"name": "efm3", "route": "cuda",
                     "source": pkg + "csrc/efm3.cu",
                     "replaces": JAX_PKG + "/ops/pallas/mfm_kernel.py:32"},
            "mining": {"name": "mining", "route": "cuda",
                       "source": pkg + "csrc/mining.cu",
                       "replaces": JAX_PKG
                       + "/ops/pallas/triplet_kernel.py:83"},
            "front9": {"name": "front9", "route": "cuda",
                       "source": pkg + "csrc/front9.cu",
                       "replaces": JAX_PKG
                       + "/ops/pallas/front_kernel.py:209"},
            "front9_bf16": {"name": "front9_bf16", "route": "cuda",
                            "source": pkg + "csrc/front9_tc.cu",
                            "replaces": JAX_PKG
                            + "/ops/pallas/front_kernel.py:209"},
            "stem2": {"name": "stem2", "route": "cuda",
                      "source": pkg + "csrc/stem.cu",
                      "replaces": JAX_PKG + "/ops/pallas/stem_kernel.py:71"},
            "stem_bf16": {"name": "stem_bf16", "route": "cuda",
                          "source": pkg + "csrc/stem.cu",
                          "replaces": JAX_PKG
                          + "/ops/pallas/stem_kernel.py:130"},
        },
    }
    failed = []
    chosen = {n: f for n, f in PHASES.items()
              if not argv or n == "build" or n in argv}
    for name, fn in chosen.items():
        pytorch_defaults(torch)
        t0 = time.perf_counter()
        try:
            result = fn(ctx)
        except Exception:   # report the phase, run the rest, exit non-zero
            traceback.print_exc()
            result = {"ok": False, "error": traceback.format_exc(limit=3)}
        result.setdefault("ok", True)
        emit({"phase": name, "seconds": time.perf_counter() - t0, **result})
        if not result["ok"]:
            failed.append(name)
        if name == "build" and failed:
            break
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: kern.get(k) for k in keys}
                      for kern in ctx["kernels"].values()]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
