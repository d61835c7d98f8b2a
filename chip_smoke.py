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
  --image-size 128`` at 240x320 (B5, B6), rerun on the CPU;
- backbone training: ``train_backbone`` with LightCNN29 at 128x128,
  batch 64 pairs, 55,005 classes, f32, ``--mining semi_hard_fused``, for
  3 steps and 2 eval steps from an mmap store (B1 once a step, B2 forward
  30 times a train step and 29 an eval step, B2's backward ``efm3_bwd``
  30 times a train step, B3 in the eval forward), its B1 picks held to the
  plain version's on the same features, each of its steps rerun from the
  same state through the plain route (plain B1, plain efm3 autograd: the
  losses, and every parameter's gradient, which must be there and
  nonzero), one 8-pair step rerun on the CPU; then ``--epochs 2
  --prefetch 2 --scan-chunk 2`` and ``--resume``, the export in the
  port's extractor and ``train_final``, and 2 steps each of EFMNet342 at
  64x64, LightCNN9 at 128x128 and LightCNN29 with ``--bf16``.

The efm3 phase also holds the backward kernel ``efm3_bwd`` bit for bit to
the plain version's autograd (every shape of a LightCNN29 training step,
tie-rich inputs in four dtypes) and proves that an input that requires a
gradient gets one through ``ops.mfm.efm3`` on the card; the mining phase
also checks the backbone steps' shapes.

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

# the backbone slice: LightCNN29 at 128x128, batch 64 pairs (128 images a
# step), f32 with TF32 off, semi_hard_fused mining, an ID softmax over
# 55,005 classes: the 0.7 train split of Celeb1M's 78,579 identities
# (README.md:23-26); synthetic faces stand in for the images
BACKBONE_PAIRS, BACKBONE_CLASSES, BACKBONE_SIDE = 64, 55005, 128
# a parameter's gradient through the kernels vs the plain route, by
# relative norm (_plain_route_steps)
BACKBONE_GRAD_RTOL = 1e-4

# the kernels each path launches (the counts are read per path)
PATH_KERNELS = {"slice": ("nms", "stem", "efm3"), "head": ("mining",),
                "extract": ("front9", "front9_bf16", "stem2", "stem",
                            "stem_bf16", "efm3"),
                "serve9": ("nms", "front9"),
                "backbone": ("mining", "efm3", "efm3_bwd", "stem",
                             "front9", "stem2")}


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
    bwd = efm3_backward_checks(torch, efm3, gen)
    ctx["kernels"]["efm3_bwd"].update(
        max_abs_err=bwd["max_abs_err"], ms=bwd["step_ms"],
        plain_ms=bwd["step_plain_ms"], bound_ms=bwd["step_bound_ms"],
        bound_by=bwd["step_bound_by"], library_ms=None)
    ok = worst == 0.0 and all(all(v["exact"].values())
                              for v in shapes.values()) and bwd["ok"]
    return {"ok": ok, "tolerance": "exact (f32, bf16, f16, f64; NaN "
                                   "positions equal); backward bit-equal "
                                   "to the plain autograd in every dtype",
            "backward": bwd,
            "calls_per_forward": calls, "forward_ms": ms,
            "forward_plain_ms": plain_ms, "forward_aminmax_ms": lib_ms,
            "forward_bound_ms": bound_ms,
            "host_us_per_call": host / calls,
            "aminmax_host_us_per_call": lib_host / calls,
            "host_parts": host_parts, "shapes": shapes}


# EFM3 calls of one LightCNN29 training step at 128x128, batch BACKBONE_PAIRS
# pairs (2 x 64 = 128 images): (rows, channels) -> calls, forward and
# backward alike. The unfused stem's efm3 runs at full resolution; groups
# 2-5 at 64, 32, 16, 8; fc1's last.
def lightcnn29_train_efm3(images: int) -> dict[tuple[int, int], int]:
    b = images
    return {(b * 128 * 128, 99): 1,
            (b * 64 * 64, 66): 1, (b * 64 * 64, 99): 2,
            (b * 64 * 64, 198): 1,
            (b * 32 * 32, 132): 2, (b * 32 * 32, 198): 3,
            (b * 32 * 32, 387): 1,
            (b * 16 * 16, 258): 3, (b * 16 * 16, 387): 4,
            (b * 16 * 16, 261): 1,
            (b * 8 * 8, 174): 4, (b * 8 * 8, 261): 6,
            (b, 1026): 1}


def _bits(torch, t):
    view = {torch.float32: torch.int32, torch.float64: torch.int64,
            torch.bfloat16: torch.int16, torch.float16: torch.int16}
    return t.contiguous().view(view[t.dtype])


def efm3_backward_checks(torch, efm3, gen) -> dict:
    """Kernel ``efm3_bwd`` against the plain version's autograd
    (``efm3_rows_bwd_plain``), bit for bit: at every shape of a LightCNN29
    training step (random inputs), on tie-rich inputs (small integers,
    NaN, -0.0 gradients) in f32, bf16, f16 and f64, and the C5 proof: an
    input that requires a gradient gets one through ``ops.mfm.efm3`` on the
    card, equal to the plain autograd's. Then each path shape is timed
    (kernel and plain) and summed over a step's calls with the bound."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
        mfm,
    )

    cases, worst = {}, 0.0
    step_ms = step_plain = nbytes = ops = 0.0
    for (rows, c), n in lightcnn29_train_efm3(2 * BACKBONE_PAIRS).items():
        x = torch.randn(rows, c, generator=gen).cuda()
        g = torch.randn(rows, 2 * (c // 3), generator=gen).cuda()
        got = efm3.efm3_rows_bwd(x, g)
        want = efm3.efm3_rows_bwd_plain(x, g)
        torch.cuda.synchronize()
        worst = max(worst, float((got - want).abs().max()))
        k = time_ms(torch, lambda: efm3.efm3_rows_bwd(x, g),
                    10 if rows > 1 << 20 else 30)
        p = time_ms(torch, lambda: efm3.efm3_rows_bwd_plain(x, g),
                    3 if rows > 1 << 20 else 10, warmup=1)
        step_ms, step_plain = step_ms + n * k, step_plain + n * p
        # x and g read once, dx written once
        nbytes += n * (2 * rows * c + rows * 2 * (c // 3)) * 4
        ops += n * rows * c * 4   # ~4 compares and selects an input
        cases[f"{rows}x{c}"] = {"calls": n, "bit_equal": bool(torch.equal(
            _bits(torch, got), _bits(torch, want))), "ms": k,
            "plain_ms": p}
        del x, g, got, want
    rng = torch.Generator().manual_seed(11)
    ties = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
        for rows, c in ((4096, 99), (8192, 261), (128, 1026)):
            x = torch.randint(-2, 3, (rows, c), generator=rng).double()
            x[torch.rand(rows, c, generator=rng) < 0.02] = float("nan")
            g = torch.randn(rows, 2 * (c // 3), generator=rng).double()
            g[torch.rand(g.shape, generator=rng) < 0.1] = -0.0
            xd, gd = x.to(dt).cuda(), g.to(dt).cuda()
            got = efm3.efm3_rows_bwd(xd, gd)
            want = efm3.efm3_rows_bwd_plain(xd, gd)
            ties[f"{str(dt).split('.')[1]}_{rows}x{c}"] = bool(torch.equal(
                _bits(torch, got), _bits(torch, want)))
    # C5: a gradient through ops.mfm.efm3 on the card, from the kernel
    x = torch.randint(-2, 3, (16, 32, 32, 99), generator=rng).float().cuda()
    x.requires_grad_(True)
    g = torch.randn(16, 32, 32, 66, generator=rng).cuda()
    before = efm3.bwd_launches.count
    mfm.efm3(x).backward(g)
    launched = efm3.bwd_launches.count - before
    xp = x.detach().clone().requires_grad_(True)
    mfm.efm3_plain(xp).backward(g)
    c5 = {"grad_not_none": x.grad is not None,
          "bwd_kernel_launched": launched == 1,
          "grad_bit_equal_plain_autograd": x.grad is not None and bool(
              torch.equal(_bits(torch, x.grad), _bits(torch, xp.grad)))}
    bound_ms, bound_by = bound(nbytes, ops)
    ok = (worst == 0.0 and all(v["bit_equal"] for v in cases.values())
          and all(ties.values()) and all(c5.values()))
    return {"ok": ok, "max_abs_err": worst, "path_cases": cases,
            "tie_cases_bit_equal": ties, "c5": c5,
            "calls_per_step": sum(lightcnn29_train_efm3(1).values()),
            "step_ms": step_ms, "step_plain_ms": step_plain,
            "step_bound_ms": bound_ms, "step_bound_by": bound_by}


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
             "path_shape_int": _int_rows(torch, rng, b, n, EMB_DIM, HEAD_IDS),
             # the backbone steps' calls: B pairs, a 2B pool, the feature
             # width of LightCNN29, EFMNet342 and LightCNN9
             **{f"backbone_{bb}x{2 * bb}x{d}": _int_rows(
                 torch, rng, bb, 2 * bb, d, 40)
                for bb, d in ((BACKBONE_PAIRS, 684), (BACKBONE_PAIRS, 342),
                              (2 * BACKBONE_PAIRS, 256))}}
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


def backbone_faces(rows: int, side: int, seed: int):
    """``rows`` synthetic faces at ``side``, 4 a identity, each identity
    given a distinct class in [0, BACKBONE_CLASSES), the last class among
    them (so the CLI's class count is BACKBONE_CLASSES)."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        synthetic_faces,
    )

    faces, labels = synthetic_faces(num_ids=rows // 4, per_id=4, size=side,
                                    seed=seed)
    rng = np.random.default_rng(seed)
    classes = np.append(rng.choice(BACKBONE_CLASSES - 1, rows // 4 - 1,
                                   replace=False), BACKBONE_CLASSES - 1)
    return faces, classes[labels]


def _bb_argv(store, out, model, epochs, *extra):
    return ["--images", store, "--model", model, "--epochs", str(epochs),
            "--batch-size", str(BACKBONE_PAIRS), "--mining",
            "semi_hard_fused", "--device", "cuda", "--out-dir", out, *extra]


def _mining_agrees(torch, calls) -> tuple[int, bool]:
    """B1's picks on the steps' own features against the plain version's:
    the number of differing indices, and whether each difference is a
    near-tie (the kernel's pick within 1e-5 of the plain pick's distance,
    recomputed in float64, as phase_mining holds the path shape)."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        mining,
    )

    differing, near = 0, True
    for (anc, pos_sq, al, pool, pl), got in calls:
        want = mining.semi_hard_mining_plain(anc, pos_sq, al, pool, pl)
        diff = (got != want)
        differing += int(diff.sum())
        if diff.any():
            dist = lambda idx: ((anc.double() - pool[idx.long()].double())  # noqa: E731
                                ** 2).sum(1)
            near = near and bool(((dist(got) - dist(want)).abs()[diff]
                                  <= 1e-5).all())
    return differing, near


def _train_record_mining(ctx, argv):
    """``train_backbone.main(argv)`` with the launch counts set to 0 just
    before and read just after, and every B1 call's inputs and picks
    recorded."""
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        train_backbone,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
        steps as steps_mod,
    )

    calls, real = [], steps_mod.semi_hard_mining

    def recording(*args):
        out = real(*args)
        calls.append(([a.detach().clone() for a in args], out.clone()))
        return out

    steps_mod.semi_hard_mining = recording
    try:
        for c in ctx["counters"].values():
            c.reset()
        state, hist = train_backbone.main(argv)
        torch.cuda.synchronize()
        launches = {k: ctx["counters"][k].count
                    for k in PATH_KERNELS["backbone"]}
    finally:
        steps_mod.semi_hard_mining = real
    return state, hist, launches, calls


def _keep_grads(state) -> list:
    """Make ``state``'s next update first copy each parameter's gradient
    (None where it has none) into the returned list."""
    kept, update = [], state.apply_update

    def apply_update():
        kept[:] = [None if q.grad is None else q.grad.detach().clone()
                   for q in state.model.parameters()]
        update()

    state.apply_update = apply_update
    return kept


def _rel_gaps(torch, got, want) -> list:
    """Per parameter, ``||got - want|| / ||want||`` of two gradient
    lists."""
    return [float(torch.linalg.vector_norm((g - w).double())
                  / torch.linalg.vector_norm(w.double()))
            for g, w in zip(got, want)]


def _plain_route_steps(ctx, torch, store) -> dict:
    """The full-width steps of the run against the plain route from the
    same states: the CLI's batches (its batcher and host mirror, seed 0),
    the CLI's init and optimizer; before each step the state is copied
    twice, the step runs through the kernels (B1, B2 and ``efm3_bwd``),
    and each copy takes the same step through the plain route (B1's plain
    version, efm3's plain version with its autograd: no B1, B2 or
    ``efm3_bwd`` launch). The steps take a triplet margin of 2 so that the
    triplet term, the only path into ``fc1_bn``, is on in every step.

    Held: the forwards are the same but for B1's picks, which differ only
    at a 1e-5 near-tie, so each step's losses agree to rtol 1e-5 and the
    cosines to 1e-5; every parameter gets a nonzero gradient through the
    kernels (C5 for the whole model), and each parameter's gradient is
    within ``BACKBONE_GRAD_RTOL`` (relative norm) of the plain route's as
    the optimizer receives it. The two plain copies measure the floor of
    that comparison: cuDNN's backward sums in a run-dependent order.
    (Whole runs part after a differing pick, and the weights after the
    update say little: Adam's first updates are the sign of each gradient
    element.)"""
    import copy

    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.train_backbone import (
        MirrorBatches,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        ShardedPairBatcher,
        load_image_store_mmap,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
        mfm as mfm_mod,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        efm3,
        mining,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
        TrainState,
        backbone_optimizer,
        create_train_state,
        make_backbone_train_step,
        steps as steps_mod,
    )

    images, labels = load_image_store_mmap(store)
    batcher = ShardedPairBatcher((images, labels), BACKBONE_PAIRS, seed=0)
    model = model_by_name("lightcnn29", BACKBONE_CLASSES,
                          input_hw=(BACKBONE_SIDE, BACKBONE_SIDE),
                          generator=torch.Generator().manual_seed(0))
    spec = backbone_optimizer("adam", decay_every_steps=6 * len(batcher))
    state = create_train_state(model, spec, 0)
    step = make_backbone_train_step(mining_mode="semi_hard_fused",
                                    margin=2.0)
    names = [n for n, _ in state.model.named_parameters()]

    def twin_of(state):
        twin_model = copy.deepcopy(state.model)
        twin_opt = spec.build(twin_model.parameters())
        twin_opt.load_state_dict(copy.deepcopy(
            state.optimizer.state_dict()))
        return TrainState(model=twin_model, optimizer=twin_opt, seed=0,
                          step=state.step, spec=spec)

    gaps, plain_launches = [], 0
    for a, p, lab in MirrorBatches(batcher, True, 0):
        twins = [twin_of(state), twin_of(state)]
        kept = _keep_grads(state)
        _, mk = step(state, a, p, lab)
        del state.apply_update   # the class's method again
        saved = steps_mod.semi_hard_mining, mfm_mod.efm3_rows
        steps_mod.semi_hard_mining = mining.semi_hard_mining_plain
        mfm_mod.efm3_rows = efm3.efm3_rows_plain
        before = sum(ctx["counters"][k].count
                     for k in ("mining", "efm3", "efm3_bwd"))
        try:
            plain_kept = [_keep_grads(t) for t in twins]
            mp = [step(t, a, p, lab)[1] for t in twins][0]
        finally:
            steps_mod.semi_hard_mining, mfm_mod.efm3_rows = saved
        plain_launches += sum(ctx["counters"][k].count for k in (
            "mining", "efm3", "efm3_bwd")) - before
        gap = {k: float((mk[k] - mp[k]).abs().max()) for k in mk}
        gap["params"] = max(float((u - v).abs().max()) for u, v in zip(
            state.model.state_dict().values(),
            twins[0].model.state_dict().values()))
        missing = [n for n, g in zip(names, kept)
                   if g is None or not bool(g.abs().max() > 0)]
        rel = _rel_gaps(torch, kept, plain_kept[0]) if not missing else []
        floor = _rel_gaps(torch, plain_kept[1], plain_kept[0])
        worst = int(np.argmax(rel)) if rel else 0
        gaps.append({**gap, "loss": float(mk["loss"]),
                     "plain_loss": float(mp["loss"]),
                     "triplet_loss": float(mk["tl_loss"]),
                     "params_without_grad": missing,
                     "grad_rel_gap": max(rel, default=None),
                     "grad_rel_gap_at": names[worst] if rel else None,
                     "plain_vs_plain_grad_rel_gap": max(floor)})
        del twins, kept, plain_kept
    ok = plain_launches == 0 and all(
        abs(g["loss"] - g["plain_loss"]) <= 1e-5 * abs(g["plain_loss"])
        for g in gaps) and all(
        g["pos_cos"] <= 1e-5 and g["neg_cos"] <= 1e-5 for g in gaps)
    grads_ok = all(not g["params_without_grad"]
                   and g["grad_rel_gap"] <= BACKBONE_GRAD_RTOL
                   for g in gaps)
    return {"ok": bool(ok and grads_ok), "grads_ok": bool(grads_ok),
            "grad_rtol": BACKBONE_GRAD_RTOL, "steps": gaps,
            "plain_route_launches": plain_launches,
            "finite": bool(np.isfinite([g["loss"] for g in gaps]).all())}


def _cpu_step_agrees(torch, images, labels) -> dict:
    """One LightCNN29 train step of 8 pairs on the card and on the CPU from
    the same weights and batch (dropout off on both: the two devices'
    generators draw different masks): the metrics agree (losses rtol 1e-4,
    cosines atol 1e-3: the card's and the CPU's f32 convs sum in other
    orders, and the training BatchNorm magnifies that over 16 rows)."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        ShardedPairBatcher,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.lightcnn import (
        Dropout,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
        backbone_optimizer,
        create_train_state,
        make_backbone_train_step,
    )

    a, p, l = next(iter(ShardedPairBatcher((images, labels), 8,
                                           shuffle=False)))
    out = {}
    for dev in ("cuda", "cpu"):
        model = model_by_name("lightcnn29", BACKBONE_CLASSES,
                              input_hw=(BACKBONE_SIDE, BACKBONE_SIDE),
                              generator=torch.Generator().manual_seed(5),
                              device=dev)
        for m in model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        state = create_train_state(model, backbone_optimizer("adam"), 0)
        _, m = make_backbone_train_step(mining_mode="semi_hard_fused")(
            state, a, p, l)
        out[dev] = {k: v.cpu().numpy() for k, v in m.items()}
    gap = {k: float(np.abs(out["cuda"][k] - out["cpu"][k]).max())
           for k in out["cpu"]}
    ok = all(abs(out["cuda"][k] - out["cpu"][k]) <= 1e-4 * max(
        abs(float(out["cpu"][k])), 1.0) for k in ("loss", "id_loss",
                                                     "tl_loss"))
    ok = ok and gap["pos_cos"] <= 1e-3 and gap["neg_cos"] <= 1e-3
    return {"ok": bool(ok), "max_gap": gap,
            "cpu_loss": float(out["cpu"]["loss"])}


def phase_backbone(ctx):
    """``train_backbone`` on the card (module docstring): the full-width
    LightCNN29 run with its B1 picks held to the plain version's and its
    losses to the plain route's, one small step rerun on the CPU, the
    resumed run with prefetch and scan chunks, its export in the port's
    extractor and in ``train_final``, EFMNet342, LightCNN9 and LightCNN29
    in bf16."""
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        train_backbone,
        train_final,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        load_image_store_mmap,
        save_image_store,
        save_image_store_mmap,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
        extract_features,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        from_jax_params,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.export import (
        load_exported_params,
    )

    side, pairs = BACKBONE_SIDE, BACKBONE_PAIRS
    checks, report = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        faces, labels = backbone_faces(4 * pairs, side, seed=0)
        store = os.path.join(tmp, "train")
        save_image_store_mmap(store, faces, labels)
        evals = os.path.join(tmp, "eval.npz")
        save_image_store(evals, *backbone_faces(2 * pairs, side, seed=1))
        three = os.path.join(tmp, "three")   # 3 steps of 64 pairs
        save_image_store_mmap(three, faces[:3 * pairs], labels[:3 * pairs])

        # (1) 3 full-width steps and 2 eval steps, B1's picks recorded
        def argv_a(out):
            return _bb_argv(three, os.path.join(tmp, out), "lightcnn29", 1,
                            "--eval-images", evals)

        state, hist, launches, calls = _train_record_mining(ctx, argv_a("a"))
        read_launches_from(ctx, launches)
        checks["cli_turned_tf32_off"] = tf32_off()
        losses = [s["loss"] for s in hist[0].steps]
        train_steps, eval_steps = len(losses), 2
        checks["three_train_steps"] = train_steps == 3 == state.step
        checks["losses_finite"] = bool(np.isfinite(
            losses + list(hist[0].valid.values())).all())
        checks["b1_once_per_train_and_eval_step"] = (
            launches["mining"] == train_steps + eval_steps == len(calls))
        checks["b2_30_per_train_step_29_per_eval_step"] = (
            launches["efm3"] == 30 * train_steps + 29 * eval_steps)
        checks["efm3_bwd_30_per_train_step"] = (
            launches["efm3_bwd"] == 30 * train_steps)
        checks["b3_once_per_eval_step"] = launches["stem"] == eval_steps
        differing, near = _mining_agrees(torch, calls)
        checks["b1_picks_equal_plain_or_near_tie"] = near
        plain = _plain_route_steps(ctx, torch, three)
        checks["steps_agree_with_plain_route"] = plain["ok"] and len(
            plain["steps"]) == 3
        checks["every_param_grad_as_plain_route"] = plain["grads_ok"]
        cpu = _cpu_step_agrees(torch, *load_image_store_mmap(three))
        checks["small_step_agrees_with_cpu"] = cpu["ok"]
        report["full_width"] = {
            "model": "lightcnn29", "hw": [side, side], "pairs": pairs,
            "classes": BACKBONE_CLASSES, "launches": launches,
            "launches_per_train_step": {
                "mining": 1, "efm3": (launches["efm3"] - 29 * eval_steps)
                / train_steps, "efm3_bwd": launches["efm3_bwd"]
                / train_steps},
            "losses": losses, "valid": hist[0].valid,
            "plain_route_steps": plain,
            "b1_index_differences": differing,
            "train_step_s": [s["seconds"] for s in hist[0].steps],
            "cpu_small_step": cpu}

        # (2) main twice: 2 epochs with prefetch and scan chunks, --resume
        out = os.path.join(tmp, "b")
        argv = _bb_argv(store, out, "lightcnn29", 2, "--prefetch", "2",
                        "--scan-chunk", "2", "--eval-images", evals)
        s1, h1 = train_backbone.main(argv)
        s2, h2 = train_backbone.main(
            _bb_argv(store, out, "lightcnn29", 3, "--prefetch", "2",
                     "--scan-chunk", "2", "--eval-images", evals,
                     "--resume"))
        adam = s2.optimizer.state[next(s2.model.parameters())]
        checks["resume_continues"] = (
            s1.step == 8 and s2.step == 12 and [h.epoch for h in h2] == [2]
            and int(adam["step"]) == 12)
        checks["resumed_losses_finite"] = bool(np.isfinite(
            [s["loss"] for h in h1 + h2 for s in h.steps]).all())
        export = os.path.join(out, "export")
        params, stats, manifest = load_exported_params(export)
        net = from_jax_params(export)
        rows = faces[:pairs]
        got, _, _, _ = extract_features(net, rows)
        want, _, _, _ = extract_features(s2.model, rows)
        checks["export_extracts_as_trained_model"] = (
            manifest["model"] == "lightcnn29" and "fc1_bn" in stats
            and float(np.abs(got - want).max()) <= 1e-5)
        fin_state, fin_hist = train_final.main([
            "--images", store, "--export-dir", export, "--epochs", "1",
            "--batch-size", str(pairs), "--mining", "semi_hard_fused",
            "--device", "cuda", "--out-dir", os.path.join(tmp, "final")])
        fparams, _, _ = load_exported_params(os.path.join(tmp, "final",
                                                          "export"))
        checks["train_final_on_export"] = (
            fin_state.step == 4 and fparams["proj"]["kernel"].shape
            == (684, 342) and bool(np.isfinite(
                [s["loss"] for h in fin_hist for s in h.steps]).all()))
        report["resumed"] = {"steps": [s1.step, s2.step],
                             "losses": [s["loss"] for h in h1 + h2
                                        for s in h.steps]}

        # (3) EFMNet342 at 64x64, LightCNN9 at 128x128 and LightCNN29 with
        # --bf16 (autocast: B2 and efm3_bwd in bf16), 2 steps each
        for run, model, hw, extra, per_step in (
                ("efmnet342", "efmnet342", 64, (),
                 {"efm3": 30, "efm3_bwd": 30}),
                ("lightcnn9", "lightcnn9", 128, (),
                 {"efm3": 0, "efm3_bwd": 0, "front9": 0, "stem2": 0}),
                ("lightcnn29_bf16", "lightcnn29", 128, ("--bf16",),
                 {"efm3": 30, "efm3_bwd": 30})):
            y0 = (side - hw) // 2
            st = os.path.join(tmp, run)
            save_image_store_mmap(st, faces[:2 * pairs, y0:y0 + hw,
                                            y0:y0 + hw],
                                  labels[:2 * pairs])
            ms, mh, ml, _ = _train_record_mining(
                ctx, _bb_argv(st, os.path.join(tmp, run + "_out"), model,
                              1, *extra))
            checks[f"{run}:two_finite_steps"] = ms.step == 2 and bool(
                np.isfinite([s["loss"] for s in mh[0].steps]).all())
            checks[f"{run}:launches"] = ml["mining"] == 2 and all(
                ml[k] == n * 2 for k, n in per_step.items())
            report[run] = {"launches": ml,
                           "losses": [s["loss"] for s in mh[0].steps]}
    return {"ok": all(checks.values()), "checks": checks,
            "tolerance": "B1 picks equal the plain version's (a difference "
                         "only at a 1e-5 near-tie); each step from the same "
                         "state vs the plain route: losses rtol 1e-5, "
                         "cosines atol 1e-5, each parameter's gradient "
                         f"{BACKBONE_GRAD_RTOL} by relative norm and "
                         "nonzero; small step vs CPU: losses "
                         "rtol 1e-4, cosines atol 1e-3; export features "
                         "1e-5",
            **report}


PHASES = {"build": phase_build, "nms": phase_nms, "stem": phase_stem,
          "efm3": phase_efm3, "mining": phase_mining, "front9": phase_front9,
          "stem2": phase_stem2, "slice": phase_slice, "head": phase_head,
          "extract": phase_extract, "serve9": phase_serve9,
          "backbone": phase_backbone}


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
                     "efm3": efm3.launches,
                     "efm3_bwd": efm3.bwd_launches,
                     "mining": mining.launches,
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
            # no Pallas kernel has a backward: this is the gradient of B2
            # (the JAX step differentiates its plain jnp efm3)
            "efm3_bwd": {"name": "efm3_bwd", "route": "cuda",
                         "source": pkg + "csrc/efm3.cu",
                         "replaces": JAX_PKG
                         + "/ops/pallas/mfm_kernel.py:32"},
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
