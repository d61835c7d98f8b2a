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
  64x64, LightCNN9 at 128x128 and LightCNN29 with ``--bf16``;
- LFW (``lfw``): ``import_params --verify`` of both reference checkpoint
  layouts (bit-equal round trips), ``lfw_eval`` over 6,000 pairs at
  128x128 in bf16 with the imported LightCNN29 (B3 on the tensor cores, B2)
  and with LightCNN9 (B6 on the tensor cores), held to the protocol over
  the run's own embeddings, each kernel call of its first and last batch
  held to the plain version on the same input, and its embeddings to the
  plain route on the card and to an f32 CPU rerun; ``DeviceCascade`` over
  512 frames of 250x250 (B5), its first call rerun on the CPU; and, with
  cv2, ``align`` and ``lfw_run --align`` with ``--device-cascade``.
- live serving (``live``): a person DB of 100,000 faces of 10,000
  persons (342-d, seeded) through the port's ``PersonStore``; ``serve_demo
  --video --detect --max-faces 4 --dynamic-gallery --person-db
  --gallery-dtype int8 --register-frames 0`` over a cv2-written 64-frame
  240x320 file (B5 4, B3 1 and B2 29 times a frame; every kernel call of
  the first and last frame held to its plain version); the first frames
  through the pipeline on the card and the CPU (f32 and int8 galleries);
  frames/s, device ms by family and the idle share of the per-frame work;
  ``identify match-person`` with 1,024 probes by the host scan, ``--tpu``
  and ``--device-gallery`` in f32, bf16 and int8 (int8 bit-equal to a
  host recomputation); ``DeviceGallery`` at 131,072 x 342 in each dtype
  (in-place rows, a doubling, host us per add); and the single-camera and
  ``--video`` modes through ``RecognitionService``; and the stream
  synchronizations and host-to-device copies a frame.
- int8 inference (``int8``): ``extract_features --int8`` at batch 128
  with LightCNN9 (B4 once a batch, B6 never: B6 fuses conv2, which the
  int8 route quantizes), LightCNN29 (B3 once, B2 29 times) at 128x128 and
  EFMNet342 at 64x64, each with one int8 conv's int32 sums against the
  CPU, a whole batch against its CPU rerun and the float32 run by cosine,
  every kernel call of one batch held to its plain version, and
  embeddings/s of int8, float32 and bfloat16; the hard-coded LightCNN9
  ladder (B3 once); ``make_multistream_pipeline(..., int8_embed=True)``
  at the slice's setup (B5 4, B3 1, B2 29 a dispatch, each call held to
  its plain version; answers against a CPU rerun; frames/s against float32
  serving); and one LightCNN29 ``bwd_im2col`` train step against the
  default route (B1, B2, ``efm3_bwd``; every gradient by relative norm).
- 68-point landmarks (``landmarks``): ``landmarks68 train``,
  ``export-dat``, ``import-dat --export-native`` and ``detect`` through
  the ``python -m <port>.cli`` dispatcher, the ``.dat`` round trip
  byte-equal, the port's ``NativeErt`` over the port's export against
  ``predict``, ``mtcnn_ert_detect`` on the card against a CPU rerun.

- AOT export (``aot``): the serving cell (16 streams of 240x320, MTCNN
  and EFMNet342 at 64x64 with random seeded weights, a dynamic gallery of
  1,000 f32 rows whose ``rows`` is a runtime scalar) through ``export_aot``
  as an ExportedProgram, its AOTInductor package and kernel bundle; each
  route (ExportedProgram, AOTInductor, AOTInductor + bundle in a copy of
  the port with an empty build directory) loaded in a fresh process that refuses the port's models and detect
  (``tools/perf_aot_coldstart_torch.py``): the cold start to the first
  identified frame, B5 4, B3 1 and B2 29 launches a dispatch inside the
  artifact with every call of one dispatch held to its plain version, 8
  dispatches' answers against the eager pipeline's on the same frames
  (``found``, ``index`` and B5's masks equal, similarities within 1e-5,
  AOTInductor's within 1e-4), frames/s, device ms and the idle share beside
  the eager pipeline's; then ``export_extract`` of LightCNN9 at 112x96 (B4)
  and 128x128 (B6) at batch 128, loaded the same way, held to the eager
  extraction.
- other models (``models``): ``train_backbone --model deepface`` at
  152x152x3 with DeepFace's full widths on the JAX twin's ladder (M2
  rounding down, L5 at stride 1: not the paper's, which is
  ``--model deepface_cvpr14``), 64 pairs a step, then
  ``extract_features --model deepface``; ``train_began`` at 64x64 with
  the default widths; both ``--mining semi_hard_fused`` (B1 once a step,
  its picks held to the plain version's), losses finite and falling,
  steps/s and peak memory; B1 on exact rows at DeepFace's 4,096 width.
- data and class parallelism (``parallel``): each CLI's parallel flag run
  plainly (a process group of one, NCCL) and on several ranks under
  ``torch.distributed.run`` sharing the card over gloo, each rank a
  process of ``tools/parallel_ranks_torch.py``. ``train_head
  --data-parallel`` at the head cell on 2 ranks (8,192 local rows, B1 at
  8192 x 32768 over the gathered pool): losses within 1e-5 of the world-1
  run's, every pick against the plain version's. ``train_backbone
  --class-parallel 3`` (LightCNN29 at 128x128, 55,005 classes, 18,335 a
  rank, 3 steps) against ``--data-parallel`` run plainly: the first
  step's loss within 1e-5, its every gradient and the three ``fc2``
  blocks put together within ``BACKBONE_GRAD_RTOL``, the updated ``fc2``
  blocks within 1e-6 of the world-1 ``fc2`` (the later steps, from
  weights that differ by rounding, which Adam's sign-like first updates
  magnify, are reported). ``train_backbone --data-parallel`` on 2 ranks
  (the same LightCNN29, dropout and the triplet term on) against a
  world-1 run whose step computes what the 2 ranks compute in one
  process (each rank's half embedded on its own, with its dropout masks
  and BatchNorm statistics, then mined and lost over the concatenated
  pool: ``parallel_ranks_torch.ranks_in_one_process``) the same way,
  with the gap to the plain world-1 run reported. The slice's 16 streams through the
  gallery-sharded pipeline on 2 ranks (1,000 rows sharded) against the
  unsharded pipeline: index equal, similarity within 1e-5 of the
  unsharded pipeline run on the ranks' 8-stream batches (its gap to the
  16-stream batch, which cuDNN rounds otherwise, reported).
  ``extract_features --data-parallel`` run plainly (LightCNN29, B3 and
  B2) against the plain run. B1, B2, ``efm3_bwd``, B3 and B5 launch on
  every rank, and each rank holds its calls to the plain versions; a line
  a rank gives its backend, launches, seconds and peak GiB. Gloo on one
  shared card says nothing of NCCL's scaling.

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
                             "front9", "stem2"),
                "lfw": ("nms", "stem_bf16", "efm3", "front9_bf16"),
                "live": ("nms", "stem", "efm3"),
                "int8": ("nms", "stem", "efm3", "stem2", "mining",
                         "efm3_bwd"),
                "parallel": ("mining", "efm3", "efm3_bwd", "stem", "nms")}


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
             batch: int, bf16: bool = False, int8: bool = False,
             path: str = "extract"):
    """One ``extract_features`` run over ``store``, the launch counts of
    ``path`` read around it."""
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        extract_features,
    )

    for c in ctx["counters"].values():
        c.reset()
    res = extract_features.main(
        ["--train-images", store, "--model", model, "--batch-size",
         str(batch), "--device", device, "--out-dir", out]
        + (["--bf16"] if bf16 else []) + (["--int8"] if int8 else []))[
            "train"]
    if device == "cuda":
        torch.cuda.synchronize()
    kernels = set(PATH_KERNELS[path]) | set(PATH_KERNELS["extract"])
    return res, ({k: c.count for k, c in ctx["counters"].items()
                  if k in kernels})


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


# the LFW slice (lfw_eval, lfw_run, import_params, align): LFW's protocol,
# pairs.txt header "10\t300" = 10 folds of 300 same + 300 different pairs
# = 6,000 pairs of 12,000 images, at the published 128x128 grayscale input
# of LightCNN29 and LightCNN9, in bf16 at lfw_eval's batch of 256, 1,000
# classes (lfw_eval's default); alignment at LFW's 250x250 RGB frames, 16
# a DeviceCascade call, with the serving phase's permissive thresholds
LFW_FOLDS, LFW_PER_FOLD, LFW_SIDE, LFW_BATCH = 10, 300, 128, 256
LFW_CLASSES, LFW_IDS = 1000, 1500
ALIGN_FRAMES, ALIGN_CALL, ALIGN_HW, ALIGN_TH = 512, 16, (250, 250), 0.3
# the LFW-layout tree that align and lfw_run --align read (cv2): its
# identities x frames (the first 64 frames: the two CLIs align one image a
# call, 20-36 images/s with the cv2 I/O, so the tree is cut for time), and
# its pairs.txt's folds x (same + different)
ALIGN_TREE_IDS, ALIGN_TREE_PER_ID, ALIGN_TREE_PAIRS = 16, 4, 30
# the least centered cosine (the cosine of the parts of the embeddings
# that vary across images) of the kernel route's bf16 embeddings of the
# first and last batch to the plain route's on the card, and of the first
# batch's to the f32 CPU rerun. Random LightCNN29 embeddings vary by ~1.5%
# of their length across images and bf16 moves them by ~0.5%, and the net
# turns a one-ulp difference at its stem into as large a move for some
# images: the plain bf16 route reads 0.86 to f32 on the card, and on the
# CPU a plain stem that rounds once, as B3 bf16 does, reads 0.92 (median
# 1.0) to the plain one. Set below two readings of each on the card
# (0.877 / 0.857 LightCNN29, 0.9994 / 0.998 LightCNN9).
LFW_CENTERED_MIN = {"lightcnn29": 0.85, "lightcnn9": 0.995}
LFW_CENTERED_F32_MIN = {"lightcnn29": 0.83, "lightcnn9": 0.99}


def lfw_pairs(seed: int):
    """``(images [12000, 128, 128, 1] uint8, issame [6000])`` in LFW's
    fold layout: identity patterns from ``synthetic_faces`` (1,500 of
    them) with per-image noise; a fold's first 300 pairs are two images of
    one identity, its last 300 of two."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        synthetic_faces,
    )

    base, labels = synthetic_faces(num_ids=LFW_IDS, per_id=1, size=LFW_SIDE,
                                   seed=seed)
    base = (base[np.argsort(labels), :, :, 0] * 255).astype(np.uint8)
    rng = np.random.default_rng(seed)
    ids, issame = [], []
    for _ in range(LFW_FOLDS):
        same = rng.integers(0, LFW_IDS, LFW_PER_FOLD)
        a = rng.integers(0, LFW_IDS, LFW_PER_FOLD)
        b = (a + rng.integers(1, LFW_IDS, LFW_PER_FOLD)) % LFW_IDS
        ids += [np.stack([same, same], 1), np.stack([a, b], 1)]
        issame += [True] * LFW_PER_FOLD + [False] * LFW_PER_FOLD
    ids = np.concatenate(ids).reshape(-1)
    noise = rng.integers(-12, 13, (ids.size, LFW_SIDE, LFW_SIDE), np.int16)
    images = np.clip(base[ids].astype(np.int16) + noise, 0, 255).astype(
        np.uint8)[..., None]
    return images, np.asarray(issame)


def _export_arrays(path: str):
    import numpy as np

    with np.load(os.path.join(path, "weights.npz")) as z:
        return {k: z[k] for k in z.files}


def _bit_equal(got: dict, want: dict) -> bool:
    import numpy as np

    return sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
        for k in want)


def lfw_imports(tmp: str) -> tuple[dict, dict]:
    """The ``.params`` round trip of both reference layouts at 128x128
    and 1,000 classes, random weights from seed 0: a shared-res LightCNN29
    (and random BatchNorm statistics) written as a gluon file, an EFMNet342
    as an EFM symbol file, each also exported by the port; ``import_params
    --verify`` on the card must give the export's arrays bit for bit.
    Returns ``({model: (original, imported) export dirs}, checks)``."""
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        import_params,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.export import (
        export_params,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.utils.mxnet_import import (
        efm_params_to_mxnet,
        expand_shared_res,
        gluon_lightcnn29_to_mxnet,
        write_mxnet_params,
    )

    rng = np.random.default_rng(0)
    stats = {"fc1_bn": {"mean": rng.normal(0, 0.5, 684).astype(np.float32),
                        "var": rng.uniform(0.5, 2, 684).astype(np.float32)}}
    hw = (LFW_SIDE, LFW_SIDE)
    dirs, checks = {}, {}
    for name in ("lightcnn29", "efmnet342"):
        model = model_by_name(name, LFW_CLASSES, input_hw=hw,
                              share_weights=name == "lightcnn29",
                              generator=torch.Generator().manual_seed(0),
                              device="cpu")
        params = model.flax_params()
        orig, imp = (os.path.join(tmp, f"{name}_{k}")
                     for k in ("export", "imported"))
        ckpt = os.path.join(tmp, f"{name}.params")
        if name == "lightcnn29":
            export_params(orig, expand_shared_res(params), model_name=name,
                          feature_dim=684, input_hw=hw, batch_stats=stats)
            write_mxnet_params(ckpt, *gluon_lightcnn29_to_mxnet(params,
                                                                 stats))
        else:
            export_params(orig, params, model_name=name, feature_dim=342,
                          input_hw=hw)
            write_mxnet_params(ckpt, efm_params_to_mxnet(params))
        import_params.main([ckpt, "--out-dir", imp, "--verify"])
        checks[f"{name}:import_bit_equal"] = _bit_equal(
            _export_arrays(imp), _export_arrays(orig))
        dirs[name] = (orig, imp)
    return dirs, checks


class PathCalls:
    """Within ``with``: the embedding nets' kernel calls (B3, B4 or B6 once
    a batch, which starts the batch, and B2 through ``ops.mfm``) go through
    the kernels as on the path, and those of the batches in ``keep`` are
    kept (a copy of each input and output) to be held to the plain
    versions afterwards (:func:`hold_path_calls`); ``keep=None`` keeps
    every batch. With ``plain=True`` the same calls go through the plain
    versions instead: no kernel is launched. With ``nms=True`` B5's calls
    (through ``ops.boxes``) are kept too, and a batch is a serving frame:
    its stage-1 per-scale NMS call (threshold 0.5) starts it."""

    def __init__(self, keep=(), plain=False, nms=False):
        self.keep = None if keep is None else set(keep)
        self.plain, self.nms = plain, nms
        self.batch, self.calls = -1, []

    def _call(self, kind, fn, args, kwargs, starts_batch):
        self.batch += starts_batch
        out = fn(*args, **kwargs)
        if self.keep is None or self.batch in self.keep:
            self.calls.append((kind, self.batch, tuple(
                a.clone() if i == 0 else a for i, a in enumerate(args)),
                kwargs, out.clone()))
        return out

    def __enter__(self):
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
            lightcnn,
        )
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
            boxes,
            mfm,
        )
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
            efm3,
            front9,
            nms,
            stem,
        )

        self._mods = lightcnn, mfm, boxes
        self._saved = (lightcnn.stem_conv_maxout_pool, lightcnn.front9_chain,
                       mfm.efm3_rows, boxes._nms_batched, lightcnn.stem2_conv)
        fns = ((stem.stem_conv_maxout_pool_plain,
                lambda x, params, packed=None: front9.front9_plain(x, params),
                efm3.efm3_rows_plain, nms.nms_mask_plain,
                stem.stem2_conv_plain) if self.plain
               else self._saved)
        net_starts = 0 if self.nms else 1
        lightcnn.stem_conv_maxout_pool = lambda *a, **k: self._call(
            "stem", fns[0], a, k, net_starts)
        lightcnn.front9_chain = lambda x, params, packed=None: self._call(
            "front9", fns[1], (x, params), {"packed": packed}, net_starts)
        lightcnn.stem2_conv = lambda *a: self._call("stem2", fns[4], a, {},
                                                    net_starts)
        mfm.efm3_rows = lambda x: self._call("efm3", fns[2], (x,), {}, 0)
        if self.nms:
            boxes._nms_batched = lambda b, th, method="Union": self._call(
                "nms", fns[3], (b, th, method), {}, int(th == 0.5))
        return self

    def __exit__(self, *exc):
        lightcnn, mfm, boxes = self._mods
        (lightcnn.stem_conv_maxout_pool, lightcnn.front9_chain,
         mfm.efm3_rows, boxes._nms_batched, lightcnn.stem2_conv) = self._saved
        return False


def _plain_call(efm3, front9, stem, kind, args, kwargs):
    if kind == "efm3":
        return efm3.efm3_rows_plain(*args)
    if kind == "stem":
        return stem.stem_conv_maxout_pool_plain(*args, **kwargs)
    if kind == "stem2":
        return stem.stem2_conv_plain(*args)
    if kind == "nms":
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
            nms,
        )

        return nms.nms_mask_plain(*args)
    return front9.front9_plain(*args)


def hold_path_calls(torch, calls) -> dict:
    """Each kept kernel call against its plain version on the same input
    (the path's own inputs and shapes): B2 and B5 bit for bit, B3 within
    1e-2 and B6 within 2e-2 (the stem and front9 phases' bf16
    tolerances), with the bf16 ulps by which the roundings differ. Per
    counter name: calls, input shapes, worst error, ok."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        efm3,
        front9,
        stem,
    )

    out = {}
    for kind, batch, args, kwargs, got in calls:
        x = args[0]
        with torch.no_grad():
            want = _plain_call(efm3, front9, stem, kind, args, kwargs)
        tol, name = {"efm3": (0.0, "efm3"), "stem": (1e-2, "stem"),
                     "stem2": (1e-2, "stem2"), "front9": (2e-2, "front9"),
                     "nms": (0.0, "nms")}[kind]
        if x.dtype == torch.bfloat16 and kind in ("stem", "front9"):
            name += "_bf16"
        got_f, want_f = got.float(), want.float()
        err = float((got_f - want_f).abs().max())
        if tol:
            ok = bool(torch.allclose(got_f, want_f, rtol=tol, atol=tol)
                      and want_f.abs().mean() > 1e-2)
        else:
            ok = bool(torch.equal(got, want))
        rec = out.setdefault(name, {"calls": 0, "batches": set(),
                                    "shapes": set(), "max_abs_err": 0.0,
                                    "max_ulps": 0.0, "tolerance": tol,
                                    "ok": True})
        rec["calls"] += 1
        rec["batches"].add(batch)
        rec["shapes"].add("x".join(map(str, x.shape)))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if x.dtype == torch.bfloat16:
            rec["max_ulps"] = max(rec["max_ulps"], float(
                bf16_ulps(torch, got, want).max()))
        rec["ok"] = rec["ok"] and ok
    for rec in out.values():
        rec["batches"] = sorted(rec["batches"])
        rec["shapes"] = sorted(rec["shapes"])
    return out


def _cosines(a, b):
    import numpy as np

    return (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                             * np.linalg.norm(b, axis=1))


def lfw_eval_runs(ctx, store: str, export: str, model: str, runs: int,
                  issame) -> dict:
    """``lfw_eval --images`` through its ``main`` on the card ``runs``
    times, timed. The first run is the checked one: its launch counts are
    read around it, its embeddings kept, and its kernel calls of the first
    and last batch held to the plain versions (the extractor pads the last
    batch, 224 images, with 32 zero images: every call is at 256); its
    result must equal the protocol over its embeddings, and every later
    run's result the first's. Then the first and last batch again through
    the plain route on the card (no launch), and the first batch through
    the f32 CPU route: the kernel route's embeddings by cosine to each,
    also centered (less the reference's mean over the rows compared: the
    part of an embedding that varies across images)."""
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        lfw_eval,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        from_jax_params,
    )

    argv = ["--images", store, "--export-dir", export, "--model", model,
            "--batch-size", str(LFW_BATCH)]
    rows = 2 * issame.size
    last = (rows - 1) // LFW_BATCH * LFW_BATCH
    batches = last // LFW_BATCH + 1
    kept, results, seconds = [], [], []
    saved = lfw_eval.pair_embeddings
    lfw_eval.pair_embeddings = lambda *a: kept.append(saved(*a)) or kept[-1]
    try:
        for run in range(runs):
            for c in ctx["counters"].values():
                c.reset()
            rec = PathCalls(keep=(0, batches - 1) if run == 0 else ())
            t0 = time.perf_counter()
            with rec:
                results.append(lfw_eval.main(argv))
                torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            if run == 0:
                launches = read_launches(ctx, "lfw")
                tf32 = tf32_off()
                calls = hold_path_calls(torch, rec.calls)
                del rec
    finally:
        lfw_eval.pair_embeddings = saved
    emb = kept[0]
    args = lfw_eval.build_parser().parse_args(argv)
    own = lfw_eval.evaluate_pairs(emb[0::2], emb[1::2], issame, args)
    with np.load(store) as z:
        ends = np.concatenate([z["images"][:LFW_BATCH], z["images"][last:]])
    net = lfw_eval.build_model(args, ends.shape, torch.device("cuda"))
    before = sum(c.count for c in ctx["counters"].values())
    with PathCalls(plain=True):
        plain = lfw_eval.pair_embeddings(net, ends, LFW_BATCH)
        torch.cuda.synchronize()
    plain_launches = sum(c.count for c in ctx["counters"].values()) - before
    cpu = lfw_eval.pair_embeddings(from_jax_params(export, device="cpu"),
                                   ends[:LFW_BATCH], LFW_BATCH)
    card = np.concatenate([emb[:LFW_BATCH], emb[last:]]).astype(np.float64)
    plain = plain.astype(np.float64)
    first, plain_first = card[:LFW_BATCH], plain[:LFW_BATCH]
    f32_mean, plain_mean = cpu.mean(0), plain.mean(0)
    centered = _cosines(card - plain_mean, plain - plain_mean)
    cos = {
        "kernel_vs_plain_route_min": float(_cosines(card, plain).min()),
        "kernel_vs_plain_route_centered_min": float(centered.min()),
        "kernel_vs_plain_route_centered_median": float(np.median(centered)),
        "kernel_vs_f32_cpu_min": float(_cosines(first, cpu).min()),
        "kernel_vs_f32_cpu_centered_min": float(_cosines(
            first - f32_mean, cpu - f32_mean).min()),
        "plain_route_vs_f32_cpu_centered_min": float(_cosines(
            plain_first - f32_mean, cpu - f32_mean).min()),
        # how far the images' embeddings differ: |e - mean| / |e|
        "spread_median": float(np.median(
            np.linalg.norm(cpu - f32_mean, axis=1)
            / np.linalg.norm(cpu, axis=1)))}
    checks = {
        "cli_turned_tf32_off": tf32,
        "result_equals_evaluate_of_own_embeddings": own == results[0],
        "results_equal_across_runs": all(r == results[0] for r in results),
        "path_calls_equal_plain": all(r["ok"] for r in calls.values()),
        "plain_route_launched_nothing": plain_launches == 0,
        f"first_{LFW_BATCH}_cos_vs_f32_cpu_min_{BF16_COS_MIN}":
            cos["kernel_vs_f32_cpu_min"] >= BF16_COS_MIN,
        f"centered_cos_vs_plain_route_min_{LFW_CENTERED_MIN[model]}":
            cos["kernel_vs_plain_route_centered_min"]
            >= LFW_CENTERED_MIN[model],
        f"centered_cos_vs_f32_cpu_min_{LFW_CENTERED_F32_MIN[model]}":
            cos["kernel_vs_f32_cpu_centered_min"]
            >= LFW_CENTERED_F32_MIN[model],
        "finite": bool(np.isfinite(emb).all()),
        "shape": emb.shape[0] == rows}
    return {"checks": checks, "result": results[0], "launches": launches,
            "batches": batches, "path_calls": calls, **cos,
            "pairs_per_s": [issame.size / t for t in seconds]}


def align_frames(n: int, seed: int):
    """``n`` seeded noise frames at LFW's 250x250 RGB, uint8."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n,) + ALIGN_HW + (3,), np.uint8)


def _boxes_agree(card, cpu) -> bool:
    import numpy as np

    return all(a[0].shape == b[0].shape and a[1].shape == b[1].shape
               and np.allclose(a[0], b[0], rtol=0, atol=1e-3)
               and np.allclose(a[1], b[1], rtol=0, atol=1e-3)
               for a, b in zip(card, cpu))


def lfw_detect(ctx, frames) -> dict:
    """``DeviceCascade.detect_batch`` over the frames in calls of 16 (4 B5
    launches a call), once counted, then three timed windows; the first
    call rerun on the CPU with the same weights."""
    import warnings

    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_cascade import (
        DeviceCascade,
    )

    th = (ALIGN_TH,) * 3
    cascade = DeviceCascade(MTCNNDetector(seed=0), thresholds=th)
    calls = range(0, len(frames), ALIGN_CALL)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for c in ctx["counters"].values():
            c.reset()
        first = cascade.detect_batch(frames[:ALIGN_CALL])
        first_stats = dict(cascade.last_stats)
        for i in calls[1:]:
            cascade.detect_batch(frames[i:i + ALIGN_CALL])
        torch.cuda.synchronize()
        launches = read_launches(ctx, "lfw")
        windows = []
        for _ in range(3):
            t0 = time.perf_counter()
            for i in calls:
                cascade.detect_batch(frames[i:i + ALIGN_CALL])
            torch.cuda.synchronize()
            windows.append(len(frames) / (time.perf_counter() - t0))
        cpu = DeviceCascade(MTCNNDetector(seed=0, device="cpu"),
                            thresholds=th)
        cpu_first = cpu.detect_batch(frames[:ALIGN_CALL])
    checks = {
        "nms_launches_4_a_call": launches["nms"] == 4 * len(calls),
        "only_nms_launched": sum(launches.values()) == launches["nms"],
        "first_call_boxes_points_atol_1e-3_vs_cpu": _boxes_agree(first,
                                                                 cpu_first),
        "first_call_last_stats_equal_cpu": cpu.last_stats == first_stats,
        "detections": first_stats["detections"] > 0}
    return {"checks": checks, "launches": launches,
            "calls": len(calls), "frames_per_s": windows,
            "first_call_stats": first_stats,
            "saturation_warnings": len(caught)}


def biased_det_weights(tmp: str) -> list[str]:
    """det1-3.npy of the seed-0 detector with its face heads' biases set to
    (-3, 3): random nets score ~0.5 everywhere, so this is what lets them
    pass align's and lfw_run's default thresholds (0.6, 0.7, 0.7); the
    cascade and everything after it run as with trained weights."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
    )

    det = MTCNNDetector(seed=0, device="cpu")
    paths = []
    for i, (net, head) in enumerate(((det.pnet, "conv4-1"),
                                     (det.rnet, "conv5-1"),
                                     (det.onet, "conv6-1"))):
        params = net.params()
        params[head]["biases"] = np.asarray([-3.0, 3.0], np.float32)
        paths.append(os.path.join(tmp, f"det{i + 1}.npy"))
        np.save(paths[-1], params, allow_pickle=True)
    return paths


def lfw_tree(tmp: str, frames) -> tuple[str, str]:
    """An LFW-layout tree of the first frames written with cv2 as JPEG
    (``<Name>/<Name>_NNNN.jpg``) and a pairs.txt over it in LFW's fold
    layout (10 folds of ALIGN_TREE_PAIRS same + different pairs)."""
    import cv2
    import numpy as np

    tree = os.path.join(tmp, "lfw_tree")
    names = [f"Person_{i:04d}" for i in range(ALIGN_TREE_IDS)]
    for i, name in enumerate(names):
        os.makedirs(os.path.join(tree, name))
        for k in range(ALIGN_TREE_PER_ID):
            img = frames[i * ALIGN_TREE_PER_ID + k]
            cv2.imwrite(os.path.join(tree, name, f"{name}_{k + 1:04d}.jpg"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    rng = np.random.default_rng(3)
    lines = [f"{LFW_FOLDS}\t{ALIGN_TREE_PAIRS}"]
    for _ in range(LFW_FOLDS):
        for i in rng.integers(0, ALIGN_TREE_IDS, ALIGN_TREE_PAIRS):
            a, b = rng.choice(ALIGN_TREE_PER_ID, 2, replace=False) + 1
            lines.append(f"{names[i]}\t{a}\t{b}")
        for i in rng.integers(0, ALIGN_TREE_IDS, ALIGN_TREE_PAIRS):
            j = (i + rng.integers(1, ALIGN_TREE_IDS)) % ALIGN_TREE_IDS
            a, b = rng.integers(1, ALIGN_TREE_PER_ID + 1, 2)
            lines.append(f"{names[i]}\t{a}\t{names[j]}\t{b}")
    pairs = os.path.join(tmp, "pairs.txt")
    with open(pairs, "w") as f:
        f.write("\n".join(lines) + "\n")
    return tree, pairs


def lfw_align_clis(ctx, tmp: str, frames, export: str) -> dict:
    """``align --device-cascade`` and ``lfw_run --align --device-cascade``
    over an LFW-layout tree of the frames (cv2), with the biased detector
    weights: every image aligned, 4 B5 launches an image, every pair
    resolved and scored by the imported LightCNN29."""
    import warnings

    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        align,
        lfw_run,
    )

    tree, pairs = lfw_tree(tmp, frames)
    weights = biased_det_weights(tmp)
    images = ALIGN_TREE_IDS * ALIGN_TREE_PER_ID
    n_pairs = 2 * LFW_FOLDS * ALIGN_TREE_PAIRS
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # saturation
        for c in ctx["counters"].values():
            c.reset()
        t0 = time.perf_counter()
        res = align.main([tree, os.path.join(tmp, "aligned"),
                          "--device-cascade", "--det-weights", *weights])
        torch.cuda.synchronize()
        out["align"] = {"seconds": time.perf_counter() - t0,
                        "aligned": res.aligned, "total": res.total,
                        "launches": read_launches(ctx, "lfw")}
        for c in ctx["counters"].values():
            c.reset()
        t0 = time.perf_counter()
        rows = lfw_run.main(["--lfw", tree, "--pairs", pairs, "--align",
                             "--device-cascade", "--det-weights", *weights,
                             "--export-dir", export])
        torch.cuda.synchronize()
        out["lfw_run"] = {"seconds": time.perf_counter() - t0,
                          "row": rows[0], "launches": read_launches(ctx, "lfw")}
    batches = -(-2 * n_pairs // LFW_BATCH)
    run_launches = out["lfw_run"]["launches"]
    out["checks"] = {
        "align:all_aligned": res.total == res.aligned == images,
        "align:nms_4_an_image": out["align"]["launches"]["nms"] == 4 * images,
        "lfw_run:all_pairs": rows[0]["n_pairs"] == n_pairs,
        "lfw_run:finite": bool(np.isfinite([rows[0][k] for k in (
            "accuracy_mean", "val", "far")]).all()),
        "lfw_run:nms_4_an_image": run_launches["nms"] == 4 * images,
        "lfw_run:stem_bf16_a_batch": run_launches["stem_bf16"] == batches,
        "lfw_run:efm3_29_a_batch": run_launches["efm3"] == 29 * batches}
    return out


def phase_lfw(ctx):
    """The LFW slice on the card: ``import_params --verify`` of a gluon
    LightCNN29 and an EFM-symbol EFMNet342 (bit-equal round trips), then
    ``lfw_eval --images`` over 6,000 synthetic pairs in bf16 with the
    imported LightCNN29 (B3 bf16 once and B2 29 times a batch of 256;
    three timed runs) and with a LightCNN9 export (B6 bf16 once a batch;
    one run), each checked as :func:`lfw_eval_runs` says; then
    ``DeviceCascade.detect_batch`` over 512 frames of 250x250 (B5 four
    times a call), its first call rerun on the CPU; and, where cv2 is
    installed, ``align --device-cascade`` and ``lfw_run --align
    --device-cascade`` over an LFW-layout tree of the first frames."""
    import importlib.util

    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        build_lightcnn9,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        export_model,
    )

    report, checks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dirs, import_checks = lfw_imports(tmp)
        checks.update(import_checks)
        report["import_s"] = time.perf_counter() - t0
        images, issame = lfw_pairs(seed=0)
        store = os.path.join(tmp, "pairs.npz")
        np.savez(store, images=images, issame=issame)
        del images
        dir9 = os.path.join(tmp, "lightcnn9_export")
        export_model(dir9, build_lightcnn9(
            LFW_CLASSES, input_hw=(LFW_SIDE, LFW_SIDE),
            generator=torch.Generator().manual_seed(0), device="cpu"))
        for model, export, runs, kernels in (
                ("lightcnn29", dirs["lightcnn29"][1], 3, ("stem_bf16", 1,
                                                         "efm3", 29)),
                ("lightcnn9", dir9, 1, ("front9_bf16", 1))):
            t0 = time.perf_counter()
            run = lfw_eval_runs(ctx, store, export, model, runs, issame)
            want = dict.fromkeys(PATH_KERNELS["lfw"], 0)
            for name, per_batch in zip(kernels[::2], kernels[1::2]):
                want[name] = per_batch * run["batches"]
            checks[f"{model}:launches"] = run["launches"] == want
            checks.update({f"{model}:{k}": v
                           for k, v in run.pop("checks").items()})
            report[model] = {**run, "seconds": time.perf_counter() - t0}

        t0 = time.perf_counter()
        frames = align_frames(ALIGN_FRAMES, seed=0)
        det = lfw_detect(ctx, frames)
        checks.update({f"detect_batch:{k}": v
                       for k, v in det.pop("checks").items()})
        report["detect_batch"] = {**det, "seconds": time.perf_counter() - t0}
        if importlib.util.find_spec("cv2") is None:
            emit({"cv2": False, "not_run": ["align", "lfw_run"]})
        else:
            emit({"cv2": True})
            clis = lfw_align_clis(ctx, tmp, frames, dirs["lightcnn29"][1])
            checks.update(clis.pop("checks"))
            report.update(clis)
    emit({"lfw_eval_pairs_per_s": report["lightcnn29"]["pairs_per_s"],
          "detect_batch_frames_per_s": report["detect_batch"]["frames_per_s"]})
    return {"ok": all(checks.values()), "checks": checks, **report,
            "tolerance": "import arrays bit-equal; lfw_eval results equal "
                         "the protocol over the run's own embeddings; the "
                         "first and last batch's kernel calls: B2 bit-equal "
                         "to plain, B3 bf16 1e-2, B6 bf16 2e-2; bf16 "
                         f"embeddings cosine >= {BF16_COS_MIN} to an f32 "
                         "CPU rerun, centered cosine >= LFW_CENTERED_MIN to "
                         "the plain route on the card and >= "
                         "LFW_CENTERED_F32_MIN to the f32 CPU rerun; "
                         "cascade boxes and points atol 1e-3 vs the CPU, "
                         "counts and last_stats equal"}


# ------------------------------------------------------------ live serving

# the live cell: one camera, 240x320 frames (the slice's), EFMNet342 on
# 64x64 crops, the top 4 faces a frame, against a person DB of 100,000
# faces of 10,000 persons (the ~100k-face scale at which the JAX package
# moves the match to the device) stored as int8 rows
LIVE_FRAMES, LIVE_MAX_FACES, LIVE_CHECK_FRAMES = 64, 4, 4
LIVE_PERSONS, LIVE_FACES_PER = 10000, 10
LIVE_PROBES, LIVE_ENROLLED_SHARE = 1024, 0.9
LIVE_DG_CAPACITY, LIVE_ADDS = 131072, 1000
LIVE_TRACED = 16
# C6: stream synchronizations a live frame, of which the CLI's own are 9
# (the frame's upload and 8 output reads)
LIVE_MAX_SYNCS = 12
# one quantization step of one int8 probe element moves an int8
# similarity by at most 127 / 127^2
LIVE_INT8_SIM_ATOL = 1.0 / 127.0
LIVE_F32_SIM_ATOL = 1e-4
LIVE_FAMILIES = (("nms", "nms_"), ("stem", "stem_kernel"),
                 ("efm3", "efm3_kernel"), ("conv", "conv"),
                 ("conv", "cudnn"), ("conv", "implicit"),
                 ("conv", "winograd"), ("int8_gemm", "imma"),
                 ("int8_gemm", "i8"), ("gemm", "gemm"),
                 ("gemm", "sm90_xmma"), ("gemm", "cutlass"),
                 ("sort", "sort"), ("sort", "radix"), ("pool", "pool"),
                 ("reduce", "reduce"), ("copy", "memcpy"))


def live_argv(video: str, db: str, store: str, device: str) -> list[str]:
    """``serve_demo --video --detect`` against the person DB, identify
    only, as fast as the frames decode."""
    return ["--video", video, "--detect", "--frame-size", str(FRAME_HW[0]),
            str(FRAME_HW[1]), "--image-size", str(IMAGE), "--max-faces",
            str(LIVE_MAX_FACES), "--dynamic-gallery", "--person-db", db,
            "--gallery-dtype", "int8", "--register-frames", "0",
            "--fps-cap", "0", "--sim-threshold", "-1",
            "--det-thresholds", "0.3", "0.3", "0.3", "--store", store,
            "--device", device]


def live_db(path: str, seed: int = 0):
    """The person DB through the port's ``PersonStore``: 10,000 persons
    with 10 face rows each (342-d, seeded); returns the rows."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.person_store import (
        Person,
        PersonStore,
    )

    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(LIVE_PERSONS * LIVE_FACES_PER,
                             FEAT_DIM)).astype(np.float32)
    with PersonStore(path, FEAT_DIM) as store:
        store.db.execute("PRAGMA synchronous=OFF")
        for i in range(LIVE_PERSONS):
            store.register_person(
                Person(name=f"person_{i}", student_id=str(i)),
                feats[i * LIVE_FACES_PER:(i + 1) * LIVE_FACES_PER])
    return feats


def live_video(path: str, seed: int = 0):
    """A 64-frame MJPG file of seeded 240x320 noise (as the slice's frames:
    thresholds of 0.3 saturate every cascade stage of random nets),
    written with cv2, and the frames as the CLI decodes them
    (``VideoProducer``'s normalization to [0, 1], times 255)."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.video import (
        VideoProducer,
        write_test_video,
    )

    rng = np.random.default_rng(seed)
    write_test_video(path, rng.integers(0, 256, (LIVE_FRAMES, *FRAME_HW, 3),
                                        dtype=np.uint8))

    class Sink:
        frame_shape = (*FRAME_HW, 3)

        def __init__(self):
            self.frames = []

        def push_frame(self, frame, seq=0):
            self.frames.append(frame * 255.0)

    sink = Sink()
    VideoProducer(path, sink)._run()
    return sink.frames


def _live_pipeline(torch, args, store, dtype, device):
    """The CLI's own pipeline, detector, net and gallery service for
    ``args`` on ``device``: the same seeded weights on every device."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.gallery_service import (
        PersonGalleryService,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.pipeline import (
        make_multiface_pipeline,
    )

    model = serve_demo._embed_model(args, device)
    pipe = make_multiface_pipeline(
        serve_demo._detector(args, device), model, dynamic_gallery=True,
        frame_h=FRAME_HW[0], frame_w=FRAME_HW[1], embed_size=IMAGE,
        thresholds=tuple(args.det_thresholds),
        sim_threshold=args.sim_threshold, max_faces=LIVE_MAX_FACES,
        device=device)
    return pipe, PersonGalleryService(store, dtype=dtype, device=device)


def live_family(name: str) -> str:
    low = name.lower()
    for fam, key in LIVE_FAMILIES:
        if key in low:
            return fam
    return "elementwise/other"


def live_cli(ctx, torch, video, db, tmp) -> dict:
    """``serve_demo --video --detect`` on the card with the launch counts
    set to 0 just before and read just after, every kernel call kept;
    those of the first and last identified frame are held to the plain
    versions. Frame 0 is the CLI's warm-up frame."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )

    for c in ctx["counters"].values():
        c.reset()
    t0 = time.perf_counter()
    with PathCalls(keep=None, nms=True) as rec:
        results = serve_demo.main(live_argv(video, db, os.path.join(
            tmp, "live.fjdb"), "cuda"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    cli_tf32_off = tf32_off()
    launches = read_launches(ctx, "live")
    frames = rec.batch + 1                # the warm-up and each identified
    keep = {1, rec.batch}
    held = hold_path_calls(torch, [c for c in rec.calls if c[1] in keep])
    per_frame = {k: v / frames for k, v in launches.items()}
    checks = {
        "identified": len(results) >= 1 and frames == len(results) + 1,
        "launches_per_frame": per_frame == {"nms": 4.0, "stem": 1.0,
                                            "efm3": 29.0},
        "path_calls_held": all(r["ok"] for r in held.values())
        and set(held) == {"nms", "stem", "efm3"},
        "cli_turned_tf32_off": cli_tf32_off,
        "names_resolved": all(n is not None for _, n, _ in results),
    }
    return {"checks": checks, "cli_wall_s": wall, "frames": frames,
            "identified_seqs": [r[0] for r in results],
            "launches": launches, "launches_per_frame": per_frame,
            "path_calls": held}


def live_parity(torch, args, frames, db) -> dict:
    """The first frames through the CLI's pipeline on the card and on the
    CPU, with the DB's gallery in f32 and in int8: found and indices
    equal, boxes within 1e-3, similarities within LIVE_F32_SIM_ATOL (f32)
    or LIVE_INT8_SIM_ATOL (int8: one step of one probe element)."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.person_store import (
        PersonStore,
    )

    checks, report = {}, {}
    with PersonStore(db, FEAT_DIM) as store:
        for name, dtype, atol in (("f32", torch.float32, LIVE_F32_SIM_ATOL),
                                  ("int8", torch.int8, LIVE_INT8_SIM_ATOL)):
            outs = {}
            for dev in ("cuda", "cpu"):
                pipe, svc = _live_pipeline(torch, args, store, dtype, dev)
                outs[dev] = [serve_demo.run_frame(pipe, f, svc, dev)
                             for f in frames[:LIVE_CHECK_FRAMES]]
                del pipe, svc
            found = sum(int(o["found"].sum()) for o in outs["cpu"])
            box_err = sim_err = 0.0
            same = True
            for card, cpu in zip(outs["cuda"], outs["cpu"]):
                same &= bool(np.array_equal(card["found"], cpu["found"])
                             and np.array_equal(card["indices"],
                                                cpu["indices"]))
                f = cpu["found"]
                if f.any():
                    box_err = max(box_err, float(np.abs(
                        card["boxes"][f] - cpu["boxes"][f]).max()))
                    sim_err = max(sim_err, float(np.abs(
                        card["similarities"][f]
                        - cpu["similarities"][f]).max()))
            checks[f"{name}:found_indices_equal"] = same and found > 0
            checks[f"{name}:boxes_1e-3"] = box_err <= 1e-3
            checks[f"{name}:sims"] = sim_err <= atol
            report[name] = {"faces": found, "box_max_err": box_err,
                            "sim_max_err": sim_err, "sim_atol": atol}
    return {"checks": checks, **report}


def live_timing(torch, args, frames, db) -> dict:
    """frames/s of the CLI's per-frame work (one dispatch a frame, every
    output read back) over the 64 decoded frames, three unprofiled passes,
    then one
    traced pass over LIVE_TRACED frames: device ms a frame by family, the
    idle share against the unprofiled wall, the CUDA runtime's
    synchronizing calls a frame, and the stream synchronizations and
    host-to-device copies a frame (C6: at most LIVE_MAX_SYNCS
    synchronizations)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.person_store import (
        PersonStore,
    )

    with PersonStore(db, FEAT_DIM) as store:
        pipe, svc = _live_pipeline(torch, args, store, torch.int8,
                                   "cuda")
        for f in frames[:3]:
            serve_demo.run_frame(pipe, f, svc, "cuda")
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for f in frames:
                out = serve_demo.run_frame(pipe, f, svc, "cuda")
            walls.append((time.perf_counter() - t0) / len(frames) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for f in frames[:LIVE_TRACED]:
                serve_demo.run_frame(pipe, f, svc, "cuda")
            torch.cuda.synchronize()
    by_fam, by_name, launches = defaultdict(float), defaultdict(float), 0
    runtime, h2d = defaultdict(int), 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms = ev.time_range.elapsed_us() / 1e3 / LIVE_TRACED
            by_fam[live_family(ev.name)] += ms
            by_name[ev.name[:80]] += ms
            launches += 1
            h2d += ev.name.startswith("Memcpy HtoD")
        elif ev.name.startswith("cuda") and ("Synchronize" in ev.name
                                             or "Memcpy" in ev.name):
            runtime[ev.name] += 1
    device_ms = sum(by_fam.values())
    wall_ms = min(walls)
    syncs = runtime["cudaStreamSynchronize"] / LIVE_TRACED
    return {"checks": {f"stream_syncs_per_frame_max_{LIVE_MAX_SYNCS}":
                       syncs <= LIVE_MAX_SYNCS},
            "stream_syncs_per_frame": syncs,
            "h2d_copies_per_frame": h2d / LIVE_TRACED,
            "ms_per_frame": walls, "frames_per_s": [1e3 / w for w in walls],
            "device_ms_per_frame": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "kernel_launches_per_frame": launches / LIVE_TRACED,
            "by_family_ms": dict(sorted(by_fam.items(),
                                        key=lambda kv: -kv[1])),
            "top_kernels_ms": dict(sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:12]),
            "outputs_read_per_frame": len(out),
            "runtime_calls_per_frame": {k: v / LIVE_TRACED
                                        for k, v in runtime.items()}}


def live_identify(torch, feats, db, tmp, seed: int = 0) -> dict:
    """``identify match-person`` over the DB with 1,024 probes (90% near a
    DB row, 10% of no enrolled person), five routes: the host scan,
    ``--tpu`` and ``--device-gallery`` in f32, bf16 and int8. f32 and
    ``--tpu`` must give the host scan's persons except where the host's
    top two similarities lie within 1e-6; the int8 route's similarities
    must equal the quantized product recomputed on the host (float64 sums
    of int8 products are exact integers below 2^53), bit for bit."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        identify,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        save_feature_store,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.distances import (
        l2_normalize_np,
        narrow_gallery_np,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.gallery_service import (
        PersonGalleryService,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.person_store import (
        PersonStore,
    )

    rng = np.random.default_rng(seed + 7)
    n_near = int(LIVE_PROBES * LIVE_ENROLLED_SHARE)
    src = rng.choice(feats.shape[0], n_near, replace=False)
    probes = np.concatenate([
        feats[src] + rng.normal(size=(n_near, FEAT_DIM)).astype(np.float32),
        rng.normal(size=(LIVE_PROBES - n_near, FEAT_DIM)).astype(
            np.float32)])
    labels = np.concatenate([src // LIVE_FACES_PER,
                             np.full(LIVE_PROBES - n_near, -1)])
    npz = os.path.join(tmp, "probes.npz")
    save_feature_store(npz, probes, labels)
    routes = {"host": [], "tpu": ["--tpu"],
              "f32": ["--device-gallery"],
              "bf16": ["--device-gallery", "--gallery-dtype", "bf16"],
              "int8": ["--device-gallery", "--gallery-dtype", "int8"]}
    pids, ms = {}, {}
    int8_rows = None
    for name, extra in routes.items():
        t0 = time.perf_counter()
        out = identify.main(["match-person", "--store", db, "--features",
                             npz, "--sim-th", "-2", *extra, "--device",
                             "cuda"])
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        pids[name] = np.asarray([r["pid"] for r in out])
        if name == "int8":
            int8_rows = out
    # the host's own similarities: top-two gaps, near-ties excluded
    gal = l2_normalize_np(feats)
    sims = l2_normalize_np(probes) @ gal.T
    top2 = -np.partition(-sims, 1, axis=1)[:, :2]
    tie = (top2[:, 0] - top2[:, 1]) <= 1e-6
    checks = {f"{r}:persons_equal_host": bool(
        np.array_equal(pids[r][~tie], pids["host"][~tie]))
        for r in ("tpu", "f32")}
    # int8: the card's similarities against the host recomputation
    q = narrow_gallery_np(l2_normalize_np(probes), torch.int8).numpy()
    g = narrow_gallery_np(gal, torch.int8).numpy()
    prod = (q.astype(np.float64) @ g.astype(np.float64).T).astype(np.int64)
    best = np.argmax(prod, axis=1)
    want = (prod[np.arange(LIVE_PROBES), best].astype(np.float32)
            * np.float32(1.0 / (127.0 * 127.0)))
    with PersonStore(db, FEAT_DIM) as store:
        res = PersonGalleryService(store, dtype=torch.int8,
                                   device="cuda").match_batch(probes,
                                                              sim_th=-2.0)
        _, fids, _ = store.valid_faces()
    got = np.asarray([r.similarity for r in res], np.float32)
    checks["int8:sims_bit_equal_host"] = bool(np.array_equal(got, want))
    checks["int8:rows_equal_host"] = bool(np.array_equal(
        [r.fid for r in res], fids[best]))
    checks["int8:cli_jsonl_equal"] = [r["similarity"] for r in int8_rows] \
        == [round(float(w), 6) for w in want]
    agree = {r: float(np.mean(pids[r] == pids["f32"]))
             for r in ("bf16", "int8", "tpu", "host")}
    near = labels >= 0
    return {"checks": checks, "route_ms": ms, "top1_agreement_with_f32": agree,
            "near_ties": int(tie.sum()),
            "f32_identified_source": float(np.mean(
                pids["f32"][near] - 1 == labels[near]))}


def live_device_gallery(torch, feats) -> dict:
    """``DeviceGallery`` at 131,072 x 342 in each dtype: 100,000 rows at
    start, 1,000 adds timed (host us each), a set_row and a clear_row, the
    buffer unmoved; the stored rows equal the host normalization exactly;
    filled to capacity, one more add doubles it and moves the buffer."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.distances import (
        l2_normalize_np,
        narrow_gallery_np,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.device_gallery import (
        DeviceGallery,
    )

    rng = np.random.default_rng(3)
    extra = rng.normal(size=(LIVE_DG_CAPACITY + 1 - feats.shape[0],
                             FEAT_DIM)).astype(np.float32)
    rows = np.concatenate([feats, extra])
    checks, report = {}, {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16),
                        ("int8", torch.int8)):
        dg = DeviceGallery(FEAT_DIM, capacity=LIVE_DG_CAPACITY,
                           initial=feats, dtype=dtype, device="cuda")
        ptr = dg.gallery_n.data_ptr()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for v in extra[:LIVE_ADDS]:
            dg.add(v)
        add_us = (time.perf_counter() - t0) / LIVE_ADDS * 1e6
        torch.cuda.synchronize()
        dg.set_row(5, extra[-1])
        dg.clear_row(7)
        in_place = dg.gallery_n.data_ptr() == ptr
        want_rows = rows[:dg.rows].copy()
        want_rows[5] = extra[-1]
        want = narrow_gallery_np(l2_normalize_np(want_rows), dtype)
        want[7] = 0
        got = dg.gallery_n[:dg.rows].cpu()
        equal = bool(torch.equal(got, want))
        for v in extra[LIVE_ADDS:-1]:
            dg.add(v)
        full = dg.rows == dg.capacity == LIVE_DG_CAPACITY
        before = dg.gallery_n[:16].clone()
        dg.add(extra[-1])
        moved = (dg.gallery_n.data_ptr() != ptr
                 and dg.capacity == 2 * LIVE_DG_CAPACITY
                 and bool(torch.equal(dg.gallery_n[:16], before)))
        checks.update({f"{name}:in_place": in_place,
                       f"{name}:rows_equal_host": equal,
                       f"{name}:doubling_moves": full and moved})
        report[name] = {"add_host_us": add_us,
                        "bytes": dg.gallery_n.numel()
                        * dg.gallery_n.element_size()}
        del dg, before, got
        torch.cuda.empty_cache()
    return {"checks": checks, **report}


def live_recognition_modes(tmp) -> dict:
    """The default single-camera mode and ``--video`` through
    ``RecognitionService`` with the net on the card: synthetic identities
    identified."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.synthetic import (
        synthetic_faces,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.video import (
        write_test_video,
    )

    correct, seen = serve_demo.main([
        "--image-size", str(IMAGE), "--identities", "4", "--frames", "24",
        "--store", os.path.join(tmp, "cam.fjdb"), "--device", "cuda"])
    imgs, _ = synthetic_faces(num_ids=1, per_id=32, size=IMAGE, seed=3)
    video = os.path.join(tmp, "person.avi")
    write_test_video(video, imgs[..., 0])
    results = serve_demo.main([
        "--video", video, "--image-size", str(IMAGE), "--register-name",
        "alice", "--register-frames", "3", "--sim-threshold", "0.3",
        "--fps-cap", "25", "--store", os.path.join(tmp, "vid.fjdb"),
        "--device", "cuda"])
    alice = sum(n == "alice" for _, n, _ in results)
    return {"checks": {"camera:all_identified": seen >= 1 and correct == seen,
                       "video:identified": bool(results)
                       and alice >= 0.6 * len(results)},
            "camera": [correct, seen], "video": [alice, len(results)]}


def phase_live(ctx):
    """Live recognition on the card (module docstring): the person DB,
    ``serve_demo --video --detect`` against it (B5, B3, B2 a frame, their
    calls of the first and last frame held to the plain versions), the
    same frames through the pipeline on the card and the CPU, the frames/s
    and device profile of the per-frame work, ``identify match-person``
    five ways, ``DeviceGallery`` at 131,072 rows, and the
    ``RecognitionService`` modes."""
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        serve_demo,
    )

    report, checks, secs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "people.sqlite")
        video = os.path.join(tmp, "scene.avi")
        t0 = time.perf_counter()
        feats = live_db(db)
        frames = live_video(video)
        args = serve_demo.parse_args(live_argv(video, db, "", "cuda"))
        secs["setup"] = time.perf_counter() - t0
        for name, fn in (
                ("cli", lambda: live_cli(ctx, torch, video, db, tmp)),
                ("parity", lambda: live_parity(torch, args, frames, db)),
                ("timing", lambda: live_timing(torch, args, frames, db)),
                ("identify", lambda: live_identify(torch, feats, db, tmp)),
                ("device_gallery", lambda: live_device_gallery(torch,
                                                               feats)),
                ("recognition", lambda: live_recognition_modes(tmp))):
            t0 = time.perf_counter()
            r = fn()
            secs[name] = time.perf_counter() - t0
            checks.update({f"{name}:{k}": v
                           for k, v in r.pop("checks", {}).items()})
            report[name] = r
    emit({"live_frames_per_s": report["timing"]["frames_per_s"],
          "live_device_ms_per_frame": report["timing"]["device_ms_per_frame"],
          "live_idle_share": report["timing"]["device_idle_share"],
          "live_stream_syncs_per_frame":
              report["timing"]["stream_syncs_per_frame"],
          "live_h2d_copies_per_frame":
              report["timing"]["h2d_copies_per_frame"],
          "identify_route_ms": report["identify"]["route_ms"],
          "device_gallery_add_us": {k: report["device_gallery"][k]
                                    ["add_host_us"]
                                    for k in ("f32", "bf16", "int8")}})
    return {"ok": all(checks.values()), "checks": checks, "seconds_by_part":
            secs, **report}


# ------------------------------------------------------------------ int8

# the int8 extraction runs: model, input side, rows of the store, and the
# kernels that must launch once per batch (or never)
INT8_RUNS = {
    "lightcnn9_128": ("lightcnn9", 128,
                      {"stem2": 1, "front9": 0, "front9_bf16": 0}),
    "lightcnn29_128": ("lightcnn29", 128,
                       {"stem": 1, "stem_bf16": 0, "efm3": 29}),
    "efmnet342_64": ("efmnet342", 64, {"stem": 1, "efm3": 29}),
}
INT8_ROWS = 512
# the whole batch an int8 run holds against its CPU rerun: the activation
# scale spans the batch, so both sides run the same rows as one batch
INT8_CPU_BATCH = 16
# int8 against its CPU rerun and against the float32 forward, by cosine:
# one ulp of input moves an int8 embedding by up to 2e-4
# (tests/test_torch_quantized.py), and 1e-3 is JAX's own contract
INT8_COS_CPU, INT8_COS_F32 = 0.9995, 0.999
# embeddings/s: batches timed after two warm-up batches
INT8_TIMED_BATCHES = 10
INT8_SERVE_DISPATCHES = 8


class Int8Convs:
    """Within ``with``: every int8 conv of ``ops.quantized`` is counted,
    and the first one's int8 operands and int32 sums are kept."""

    def __enter__(self):
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
            quantized,
        )

        self._mod, self._real = quantized, quantized.int8_conv_nhwc
        self.calls, self.first = 0, None

        def counting(xq, w8, stride=(1, 1), padding=(0, 0)):
            out = self._real(xq, w8, stride, padding)
            if self.first is None:
                self.first = (xq.clone(), w8.clone(), stride, padding,
                              out.clone())
            self.calls += 1
            return out

        quantized.int8_conv_nhwc = counting
        return self

    def __exit__(self, *exc):
        self._mod.int8_conv_nhwc = self._real
        return False

    def sums_equal_cpu(self, torch) -> bool:
        """The kept conv's int32 sums against the CPU's exact product on
        the same int8 operands."""
        xq, w8, stride, padding, out = self.first
        want = self._real(xq.cpu(), w8.cpu(), stride, padding)
        return bool(out.dtype == torch.int32 and torch.equal(out.cpu(), want))


def _int8_model(model: str, side: int, dtype, device):
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )

    return model_by_name(model, 1000, input_hw=(side, side), dtype=dtype,
                         device=device,
                         generator=torch.Generator().manual_seed(0))


def int8_extract_run(ctx, torch, name) -> tuple[dict, dict]:
    """One model: ``extract_features --int8`` at batch 128 over a seeded
    store on the card (launches per batch, the int8 convs a batch, one
    conv's int32 sums against the CPU), the same store in float32 (cosine
    to it), one whole batch of INT8_CPU_BATCH rows on the card and the CPU
    (cosine), the kernel calls of one int8 batch held to their plain
    versions, and embeddings/s of int8, float32 and bfloat16 (batches of
    128 timed on the card)."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        save_image_store,
        synthetic_faces,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
        make_extract_fn,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.quantized import (
        Int8ConvRoute,
    )

    model, side, per_batch = INT8_RUNS[name]
    faces, labels = synthetic_faces(num_ids=INT8_ROWS // 8, per_id=8,
                                    size=side, seed=3)
    checks, rep = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "faces.npz")
        save_image_store(store, faces, labels)
        small = os.path.join(tmp, "small.npz")
        save_image_store(small, faces[:INT8_CPU_BATCH],
                         labels[:INT8_CPU_BATCH])
        with Int8Convs() as convs:
            res, launches = _extract(ctx, store, model, "cuda",
                                     os.path.join(tmp, "int8"),
                                     EXTRACT_BATCH, int8=True, path="int8")
        read_launches_from(ctx, launches)
        batches = -(-INT8_ROWS // EXTRACT_BATCH)
        f32, _ = _extract(ctx, store, model, "cuda", os.path.join(tmp, "f32"),
                          EXTRACT_BATCH, path="int8")
        card, _ = _extract(ctx, small, model, "cuda",
                           os.path.join(tmp, "card16"), INT8_CPU_BATCH,
                           int8=True, path="int8")
        cpu, _ = _extract(ctx, small, model, "cpu", os.path.join(tmp, "cpu16"),
                          INT8_CPU_BATCH, int8=True, path="int8")
    net = _int8_model(model, side, torch.float32, "cuda")
    route = Int8ConvRoute()
    eligible = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)
                and route.reroutes(m)]
    cos_f32 = _cosines(res.features.astype(np.float64), f32.features)
    cos_cpu = _cosines(card.features.astype(np.float64), cpu.features)
    for k, n in per_batch.items():
        checks[f"{k}_launches"] = launches[k] == n * batches
    checks.update({
        "int8_convs_a_batch": convs.calls == len(eligible) * batches,
        "int32_sums_equal_cpu": convs.sums_equal_cpu(torch),
        f"cos_vs_f32_min_{INT8_COS_F32}": bool(cos_f32.min() >= INT8_COS_F32),
        f"whole_batch_cos_vs_cpu_min_{INT8_COS_CPU}": bool(
            cos_cpu.min() >= INT8_COS_CPU),
        "finite": bool(np.isfinite(res.features).all())})
    x = torch.from_numpy(faces[:EXTRACT_BATCH]).cuda()
    with PathCalls(keep=None) as calls:
        make_extract_fn(net, int8=True)(x)
        torch.cuda.synchronize()
    held = hold_path_calls(torch, calls.calls)
    checks["kernel_calls_equal_plain"] = all(r["ok"] for r in held.values())
    rates, by_fam = {}, {}
    fn = make_extract_fn(net, int8=True)
    fn(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(x)
        torch.cuda.synchronize()
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            fam = live_family(ev.name)
            by_fam[fam] = by_fam.get(fam, 0.0) + ev.time_range.elapsed_us() / 1e3
    for label, dtype, int8 in (("int8", torch.float32, True),
                               ("f32", torch.float32, False),
                               ("bf16", torch.bfloat16, False)):
        if label == "bf16" and model == "efmnet342":
            continue
        m = net if dtype == torch.float32 else _int8_model(model, side,
                                                           dtype, "cuda")
        fn = make_extract_fn(m, int8=int8)
        ms = time_ms(torch, lambda: fn(x), INT8_TIMED_BATCHES, warmup=2)
        rates[label] = EXTRACT_BATCH / ms * 1e3
    rep.update({"launches": launches, "batches": batches,
                "int8_convs_per_batch": convs.calls / batches,
                "eligible_convs": len(eligible),
                "cos_vs_f32_min": float(cos_f32.min()),
                "cos_vs_f32_mean": float(cos_f32.mean()),
                "whole_batch_cos_vs_cpu_min": float(cos_cpu.min()),
                "held_kernel_calls": held, "embeddings_per_s": rates,
                "int8_batch_device_ms_by_family": dict(sorted(
                    by_fam.items(), key=lambda kv: -kv[1]))})
    return checks, rep


def int8_hardcoded(ctx, torch) -> tuple[dict, dict]:
    """The hard-coded LightCNN9 ladder (``make_int8_lightcnn9_extract``,
    f32 compute) on one batch of 128 at 128x128: B3 once, its output held
    to the plain version on the same input, embeddings within
    INT8_COS_F32 of the generic route's (as the JAX package holds them)."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops import (
        quantized,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        stem,
    )

    net = _int8_model("lightcnn9", 128, torch.float32, "cuda")
    x = torch.rand(EXTRACT_BATCH, 128, 128, 1, device="cuda",
                   generator=torch.Generator("cuda").manual_seed(0))
    q = quantized.quantize_lightcnn9_params(net.flax_params(), device="cuda")
    fn = quantized.make_int8_lightcnn9_extract(q, compute_dtype=torch.float32)
    for c in ctx["counters"].values():
        c.reset()
    got = fn(x)
    torch.cuda.synchronize()
    b3 = ctx["counters"]["stem"].count
    generic = quantized.make_int8_extract(net, compute_dtype=torch.float32)(x)
    w1, b1 = q["conv1"]["kernel"], q["conv1"]["bias"]
    err = float((stem.stem_conv_maxout_pool(x, w1, b1, maxout=2)
                 - stem.stem_conv_maxout_pool_plain(x, w1, b1, maxout=2))
                .abs().max())
    cos = _cosines(got.cpu().numpy().astype(np.float64),
                   generic.cpu().numpy())
    checks = {"stem_once": b3 == 1, "stem_equals_plain_1e-5": err <= 1e-5,
              f"cos_vs_generic_min_{INT8_COS_F32}": bool(
                  cos.min() >= INT8_COS_F32)}
    return checks, {"stem_launches": b3, "stem_max_abs_err": err,
                    "cos_vs_generic_min": float(cos.min())}


def _int8_serving(torch, device, int8: bool):
    """The slice's serving setup (serve_demo --streams 16 at 240x320,
    EFMNet342 at 64x64, MTCNN and the 1,000-row gallery from seed 0) with
    ``int8_embed``: ``(pipeline, frames on the device, gallery)``."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.pipeline import (
        make_multistream_pipeline,
    )

    model = _int8_model("efmnet342", IMAGE, torch.float32, device)
    rng = np.random.default_rng(1)
    gallery = rng.normal(size=(1000, 342)).astype(np.float32)
    pipe = make_multistream_pipeline(
        MTCNNDetector(seed=0, device=device), model, gallery,
        frame_h=FRAME_HW[0], frame_w=FRAME_HW[1], embed_size=IMAGE,
        thresholds=(0.3, 0.3, 0.3), sim_threshold=0.5, int8_embed=int8,
        device=device)
    frames = torch.as_tensor(rng.uniform(0, 255, (STREAMS,) + FRAME_HW + (3,)),
                             dtype=torch.float32, device=device)
    return pipe, frames, gallery


def _decided_equal(got_idx, want_idx, got_emb, want_emb, gallery) -> tuple:
    """Gallery indices equal wherever the CPU's best similarity leads the
    next by more than twice the distance between the two embeddings (a
    unit row moves a similarity by at most that distance: only such a lead
    fixes the argmax on both sides). Returns (equal, decided)."""
    import numpy as np

    g = gallery / np.linalg.norm(gallery, axis=1, keepdims=True)
    sims = np.sort(want_emb.astype(np.float64) @ g.T, axis=-1)
    lead = sims[:, -1] - sims[:, -2]
    dist = np.linalg.norm(got_emb.astype(np.float64) - want_emb, axis=-1)
    decided = lead > 2.0 * dist
    return (bool(np.array_equal(got_idx[decided], want_idx[decided])),
            int(decided.sum()))


def int8_serving(ctx, torch) -> tuple[dict, dict]:
    """``make_multistream_pipeline(..., int8_embed=True)``: one dispatch
    counted (B5 4, B3 1, B2 29) with each kernel call held to its plain
    version, the answers against a CPU rerun of the same frames (found
    equal, indices equal where decided, embeddings by cosine), frames/s of
    int8 against float32 serving in turns."""
    import numpy as np

    pipe, frames, gallery = _int8_serving(torch, "cuda", True)
    pipe(frames)
    torch.cuda.synchronize()
    for c in ctx["counters"].values():
        c.reset()
    with PathCalls(keep=None, nms=True) as calls:
        out = pipe(frames)
        torch.cuda.synchronize()
    launches = read_launches(ctx, "int8")
    held = hold_path_calls(torch, calls.calls)
    out = {k: v.cpu() for k, v in out.items()}
    cpu_pipe, cpu_frames, _ = _int8_serving(torch, "cpu", True)
    cpu = cpu_pipe(frames.cpu())
    found = out["found"].numpy()
    both = found & cpu["found"].numpy()
    cos = _cosines(out["embedding"].numpy()[both].astype(np.float64),
                   cpu["embedding"].numpy()[both])
    same, decided = _decided_equal(out["index"].numpy()[both],
                                   cpu["index"].numpy()[both],
                                   out["embedding"].numpy()[both],
                                   cpu["embedding"].numpy()[both], gallery)
    f32_pipe, _, _ = _int8_serving(torch, "cuda", False)
    f32_pipe(frames)
    rates = {"int8": [], "f32": []}
    for label in ("int8", "f32", "f32", "int8"):
        p = pipe if label == "int8" else f32_pipe
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(INT8_SERVE_DISPATCHES):
            p(frames)
        torch.cuda.synchronize()
        rates[label].append(STREAMS * INT8_SERVE_DISPATCHES
                            / (time.perf_counter() - t0))
    checks = {"nms_4": launches["nms"] == 4, "stem_1": launches["stem"] == 1,
              "efm3_29": launches["efm3"] == 29,
              "kernel_calls_equal_plain": all(r["ok"] for r in held.values()),
              "found_equal_cpu": bool(np.array_equal(
                  found, cpu["found"].numpy()) and found.any()),
              "decided_indices_equal_cpu": same,
              f"cos_vs_cpu_min_{INT8_COS_CPU}": bool(
                  cos.min() >= INT8_COS_CPU)}
    return checks, {"launches": launches, "held_kernel_calls": held,
                    "faces": int(found.sum()), "indices_decided": decided,
                    "cos_vs_cpu_min": float(cos.min()),
                    "frames_per_s": rates}


def int8_bwd_im2col(ctx, torch) -> tuple[dict, dict]:
    """One LightCNN29 train step at the backbone phase's width (128x128,
    64 pairs, 55,005 classes, Adam, ``semi_hard_fused``, margin 2) with
    ``bwd_im2col=True`` against the default route from the same state,
    TF32 off: every parameter's gradient within BACKBONE_GRAD_RTOL by
    relative norm (a second default-route copy gives cuDNN's own floor);
    B1 once, B2 30 and ``efm3_bwd`` 30 times in the im2col step."""
    import copy

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
        TrainState,
        backbone_optimizer,
        create_train_state,
        make_backbone_train_step,
    )

    full_f32()
    faces, labels = backbone_faces(2 * BACKBONE_PAIRS, BACKBONE_SIDE, 5)
    batch = (faces[0::2], faces[1::2], labels[0::2])
    model = _int8_model("lightcnn29", BACKBONE_SIDE, torch.float32, "cuda")
    model = type(model)(BACKBONE_CLASSES, (BACKBONE_SIDE,) * 2)
    model.init_weights(torch.Generator().manual_seed(0))
    model = model.cuda()
    spec = backbone_optimizer("adam")
    state = create_train_state(model, spec, 0)

    def twin():
        m = copy.deepcopy(state.model)
        opt = spec.build(m.parameters())
        return TrainState(model=m, optimizer=opt, seed=0, spec=spec)

    twins = [twin(), twin()]
    kw = dict(mining_mode="semi_hard_fused", margin=2.0)
    kept = _keep_grads(state)
    for c in ctx["counters"].values():
        c.reset()
    make_backbone_train_step(bwd_im2col=True, **kw)(state, *batch)
    torch.cuda.synchronize()
    launches = read_launches(ctx, "int8")
    plain = [_keep_grads(t) for t in twins]
    step = make_backbone_train_step(**kw)
    for t in twins:
        step(t, *batch)
    rel = _rel_gaps(torch, kept, plain[0])
    floor = _rel_gaps(torch, plain[1], plain[0])
    del state.apply_update, twins[0].apply_update
    step_ms = {}
    for label, st, fn in (("bwd_im2col", state,
                           make_backbone_train_step(bwd_im2col=True, **kw)),
                          ("default", twins[0], step)):
        fn(st, *batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            fn(st, *batch)
        torch.cuda.synchronize()
        step_ms[label] = (time.perf_counter() - t0) / 3 * 1e3
    names = [n for n, _ in state.model.named_parameters()]
    checks = {"mining_1": launches["mining"] == 1,
              "efm3_30": launches["efm3"] == 30,
              "efm3_bwd_30": launches["efm3_bwd"] == 30,
              "every_grad_nonzero": all(bool(g.abs().max() > 0)
                                        for g in kept),
              f"grad_rel_gap_max_{BACKBONE_GRAD_RTOL}": max(rel)
              <= BACKBONE_GRAD_RTOL}
    worst = max(range(len(rel)), key=rel.__getitem__)
    return checks, {"launches": launches, "step_ms": step_ms,
                    "grad_rel_gap_max": max(rel),
                    "grad_rel_gap_at": names[worst],
                    "default_vs_default_grad_rel_gap_max": max(floor)}


def phase_int8(ctx):
    """Int8 inference on the card (module docstring): ``extract_features
    --int8`` with LightCNN9, LightCNN29 and EFMNet342, the hard-coded
    LightCNN9 ladder, ``int8_embed`` serving, and a ``bwd_im2col`` train
    step."""
    import torch

    report, checks, secs = {}, {}, {}
    parts = [(name, lambda name=name: int8_extract_run(ctx, torch, name))
             for name in INT8_RUNS]
    parts += [("hardcoded_lightcnn9", lambda: int8_hardcoded(ctx, torch)),
              ("serving", lambda: int8_serving(ctx, torch)),
              ("bwd_im2col", lambda: int8_bwd_im2col(ctx, torch))]
    for name, fn in parts:
        t0 = time.perf_counter()
        c, r = fn()
        secs[name] = time.perf_counter() - t0
        checks.update({f"{name}:{k}": v for k, v in c.items()})
        report[name] = r
    emit({"int8_embeddings_per_s": {n: report[n]["embeddings_per_s"]
                                    for n in INT8_RUNS},
          "int8_serving_frames_per_s": report["serving"]["frames_per_s"]})
    return {"ok": all(checks.values()), "checks": checks,
            "seconds_by_part": secs, **report}


# ------------------------------------------------------------- landmarks

# the ERT training of the landmarks phase: seeded synthetic faces (68
# points, blobs at the five MTCNN points over noise), a training small
# enough for the phase that leaves no degenerate node (whose infinite
# threshold has no .dat encoding)
LM_FACES, LM_SIDE = 30, 64
LM_TRAIN = ["--cascades", "2", "--trees", "10", "--depth", "3",
            "--feature-pool", "60", "--oversampling", "10", "--nu", "0.3"]
# the detection frames: seeded noise at 64x64, where the seed-0 nets pass
# tens of candidates at thresholds of 0.3 (at 250x250 they pass ~500 a
# frame, whose near-ties at a threshold make card and CPU keep different
# sets); card vs CPU on the host cascade: the DeviceCascade check's 1e-3
LM_DETECT_IMAGES, LM_DETECT_HW, LM_TH = 4, (64, 64), 0.3
LM_ATOL = 1e-3


def landmark_faces(n: int, seed: int):
    """``n`` grayscale faces of LM_SIDE px: a 68-point layout at a random
    scale and place, gaussian blobs at its five MTCNN points over seeded
    noise; returns (images [n, S, S], rects [n, 4], shapes [n, 68, 2])."""
    import numpy as np

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.ert import (
        five_points_from_68,
    )

    rng = np.random.default_rng(seed)
    t = np.linspace(0, np.pi, 17)
    canon = np.zeros((68, 2), np.float32)
    canon[0:17] = np.stack([0.5 - 0.45 * np.cos(t), 0.35 + 0.55 * np.sin(t)],
                           1)
    canon[17:27] = [[0.2 + 0.1 * (i % 5) + 0.35 * (i // 5), 0.25]
                    for i in range(10)]
    canon[27:31] = np.stack([np.full(4, 0.5), np.linspace(0.3, 0.5, 4)], 1)
    canon[31:36] = np.stack([np.linspace(0.42, 0.58, 5), np.full(5, 0.55)], 1)
    th = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    for j, cx in ((36, 0.3), (42, 0.7)):
        canon[j:j + 6] = np.stack([cx + 0.06 * np.cos(th),
                                   0.35 + 0.03 * np.sin(th)], 1)
    th2 = np.linspace(0, 2 * np.pi, 20, endpoint=False)
    canon[48:68] = np.stack([0.5 + 0.12 * np.cos(th2),
                             0.75 + 0.05 * np.sin(th2)], 1)
    yy, xx = np.mgrid[0:LM_SIDE, 0:LM_SIDE].astype(np.float32)
    images, rects, shapes = [], [], []
    for _ in range(n):
        scale = rng.uniform(0.65, 0.85) * (LM_SIDE - 8)
        tx, ty = rng.uniform(2, LM_SIDE - scale - 2, 2)
        shape = (canon + rng.normal(0, 0.01, canon.shape)) * scale + [tx, ty]
        img = rng.uniform(0, 40, (LM_SIDE, LM_SIDE))
        for kx, ky in five_points_from_68(shape.astype(np.float32)):
            img += 255 * np.exp(-((xx - kx) ** 2 + (yy - ky) ** 2) / 18.0)
        s2 = scale * rng.uniform(0.95, 1.2)
        cx = tx + scale / 2 + rng.uniform(-0.1, 0.1) * scale
        cy = ty + scale / 2 + rng.uniform(-0.1, 0.1) * scale
        images.append(np.clip(img, 0, 255).astype(np.float32))
        rects.append([cx - s2 / 2, cy - s2 / 2, cx + s2 / 2, cy + s2 / 2])
        shapes.append(shape)
    return (np.stack(images), np.asarray(rects, np.float32),
            np.asarray(shapes, np.float32))


def _paired(ref_boxes, side):
    """``side``'s (boxes, landmarks) in the order of ``ref_boxes``: each
    reference box takes the nearest box of ``side`` (largest coordinate
    difference); unchanged when the counts differ or two reference boxes
    take the same one."""
    import numpy as np

    boxes, landmarks = side
    if boxes.shape != ref_boxes.shape or not len(boxes):
        return side
    dist = np.abs(ref_boxes[:, None, :4] - boxes[None, :, :4]).max(-1)
    order = dist.argmin(1)
    if len(set(order.tolist())) != len(order):
        return side
    return boxes[order], landmarks[order]


def _lm_cli(*argv) -> subprocess.CompletedProcess:
    """``python -m <port>.cli *argv`` in a new process."""
    return subprocess.run([sys.executable, "-m", f"{PKG}.cli", *argv],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300)


def phase_landmarks(ctx):
    """68-point landmarks on the card (module docstring): ``landmarks68
    train`` / ``export-dat`` / ``import-dat --export-native`` through the
    dispatcher, the ``.dat`` round trip byte-equal; ``NativeErt`` over the
    port's export against ``predict``; ``mtcnn_ert_detect`` with the
    seed-0 MTCNN nets on the card over seeded 64x64 frames (the host
    cascade: no kernel of the port), held to a CPU rerun; ``landmarks68
    detect`` over the cv2-written frames; the dispatcher's ``-h``."""
    import cv2
    import numpy as np

    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
        ShapePredictor,
        mtcnn_ert_detect,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.dlib_import import (
        read_shape_predictor_dat,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.native import (
        NativeErt,
    )

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.__main__ import (
        main as dispatch,
    )

    checks, rep, secs = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda name: os.path.join(tmp, name)  # noqa: E731
        t0 = time.perf_counter()
        images, rects, shapes = landmark_faces(LM_FACES, seed=0)
        np.savez(p("ann.npz"), images=images, rects=rects, shapes=shapes)
        dispatch(["landmarks68", "train", "--annotations", p("ann.npz"),
                  "--out", p("sp.npz"), "--export-native",
                  p("sp_native.npz"), *LM_TRAIN])
        dispatch(["landmarks68", "export-dat", p("sp.npz"), "--out",
                  p("sp.dat")])
        dispatch(["landmarks68", "import-dat", p("sp.dat"), "--out",
                  p("back.npz"), "--export-native", p("back_native.npz")])
        dispatch(["landmarks68", "export-dat", p("back.npz"), "--out",
                  p("back.dat")])
        secs["cli"] = time.perf_counter() - t0
        with open(p("sp.dat"), "rb") as f, open(p("back.dat"), "rb") as g:
            dat = f.read()
            checks["dat_round_trip_byte_equal"] = dat == g.read()
        pred = ShapePredictor.load(p("sp.npz"))
        back = read_shape_predictor_dat(p("sp.dat"))
        checks["dat_predictor_equal"] = all(
            np.array_equal(getattr(a, k), getattr(b, k))
            for a, b in zip(pred.levels, back.levels)
            for k in ("anchors", "deltas", "split_idx1", "split_idx2",
                      "split_thresh", "leaf_values"))
        with NativeErt(p("back_native.npz")) as ert:
            err = max(float(np.abs(ert.predict(images[i], rects[i])
                                   - pred.predict(images[i], rects[i])).max())
                      for i in range(8))
        checks["native_ert_matches_predict_1e-3"] = err <= 1e-3
        rep["native_ert_max_err"] = err
        rep["dat_bytes"] = len(dat)

        t0 = time.perf_counter()
        rng = np.random.default_rng(7)
        paths, frames = [], []
        for i in range(LM_DETECT_IMAGES):
            frame = rng.integers(0, 256, LM_DETECT_HW + (3,), np.uint8)
            paths.append(p(f"frame{i}.png"))
            cv2.imwrite(paths[-1], frame)
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        th = (LM_TH,) * 3
        full_f32()   # as landmarks68's main: the nets' convs in float32
        for c in ctx["counters"].values():
            c.reset()
        card = [mtcnn_ert_detect(f, pred, MTCNNDetector(seed=0),
                                 thresholds=th) for f in frames]
        torch.cuda.synchronize()
        launched = sum(c.count for c in ctx["counters"].values())
        cpu_det = MTCNNDetector(seed=0, device="cpu")
        cpu = [mtcnn_ert_detect(f, pred, cpu_det, thresholds=th)
               for f in frames]
        faces = sum(b.shape[0] for b, _ in card)
        # the host cascade lists faces by score: near-equal scores may
        # come out in another order on the two devices, so each CPU face
        # is paired with the card face whose box is nearest
        cpu = [_paired(a[0], b) for a, b in zip(card, cpu)]
        checks["faces_found"] = faces > 0
        checks["boxes_landmarks_atol_1e-3_vs_cpu"] = all(
            a[0].shape == b[0].shape and np.allclose(a[0], b[0], atol=LM_ATOL)
            and np.allclose(a[1], b[1], atol=LM_ATOL)
            for a, b in zip(card, cpu))
        checks["no_kernel_launched"] = launched == 0
        dispatch(["landmarks68", "detect", "--predictor", p("sp.npz"),
                  *paths, "--thresholds", *map(str, th), "--out",
                  p("lmk.jsonl")])
        rows = [json.loads(line) for line in open(p("lmk.jsonl"))]
        checks["detect_cli_jsonl"] = (
            len(rows) == LM_DETECT_IMAGES
            and sum(len(row["boxes"]) for row in rows) == faces)
        secs["detect"] = time.perf_counter() - t0
        same = [(a, b) for a, b in zip(card, cpu)
                if a[0].shape == b[0].shape]
        rep["box_max_err"] = max((float(np.abs(a[0] - b[0]).max())
                                  for a, b in same if a[0].size), default=0.0)
        rep["landmark_max_err"] = max((float(np.abs(a[1] - b[1]).max())
                                       for a, b in same if a[1].size),
                                      default=0.0)
        rep.update({"faces": faces, "kernel_launches": launched})
    t0 = time.perf_counter()
    helps = [_lm_cli("landmarks68", "-h"), _lm_cli("extract_features", "-h"),
             _lm_cli("-h")]
    checks["dispatcher_help_exits_0"] = all(r.returncode == 0 for r in helps)
    checks["dispatcher_export_aot_train_began_help"] = all(
        _lm_cli(c, "-h").returncode == 0 for c in ("export_aot",
                                                   "train_began"))
    secs["dispatcher"] = time.perf_counter() - t0
    return {"ok": all(checks.values()), "checks": checks,
            "seconds_by_part": secs, **rep}


# the extraction artifacts: (name, input HxW, the kernel its front takes)
AOT_EXTRACT = (("lightcnn9_112x96", (112, 96), "stem2"),
               ("lightcnn9_128", (128, 128), "front9"))
# the cold-start routes (tools/perf_aot_coldstart_torch.py also times
# "nobundle", the package in an empty build directory without its bundle)
AOT_ROUTES = ("exported", "compiled", "bundle")
# an AOTInductor artifact's answers against the eager pipeline: Inductor
# fuses and reorders float32 work, so sims move by rounding
AOTI_SIM_ATOL = 1e-4


def _coldstart_tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import perf_aot_coldstart_torch

    return perf_aot_coldstart_torch


def _aot_compare(eager_outs, eager_masks, route_out, atol) -> dict:
    """An artifact's dispatches (``route_out`` npz) against the eager
    pipeline's: ``found``, ``index`` and B5's masks of the first dispatch
    equal, ``similarity`` and ``embedding`` within ``atol``."""
    import numpy as np

    got = np.load(route_out)
    sim_err = emb_err = 0.0
    equal = True
    for i, want in enumerate(eager_outs):
        equal &= bool(np.array_equal(got[f"found_{i}"], want["found"])
                      and np.array_equal(got[f"index_{i}"], want["index"]))
        sim_err = max(sim_err, float(np.abs(got[f"similarity_{i}"]
                                            - want["similarity"]).max()))
        emb_err = max(emb_err, float(np.abs(got[f"embedding_{i}"]
                                            - want["embedding"]).max()))
    masks = [got[f"nms_mask_{j}"] for j in range(len(eager_masks))
             if f"nms_mask_{j}" in got]
    masks_equal = len(masks) == len(eager_masks) == 4 and all(
        np.array_equal(a, b) for a, b in zip(masks, eager_masks))
    return {"found_index_equal": equal, "b5_masks_equal": masks_equal,
            "sim_max_abs_err": sim_err, "emb_max_abs_err": emb_err,
            "ok": equal and masks_equal and sim_err <= atol}


def aot_extract(ctx, tool, work) -> dict:
    """``export_extract`` of LightCNN9 at 112x96 (B4) and 128x128 (B6, f32),
    batch 128, each loaded in a fresh process that refuses the port's
    models and detect, fed the state dict of the model it was exported
    from, its outputs held to the eager extraction's."""
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
        make_extract_fn,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        aot,
    )

    p = lambda name: os.path.join(work, name)  # noqa: E731
    jobs, eager, secs = [], {}, {}
    rng = np.random.default_rng(3)
    for name, hw, _ in AOT_EXTRACT:
        model = model_by_name("lightcnn9", 1000, input_hw=hw,
                              generator=torch.Generator().manual_seed(1))
        t0 = time.perf_counter()
        aot.export_extract(p(f"{name}.pt2"), model, 128, *hw)
        secs[name] = time.perf_counter() - t0
        images = rng.random((128, *hw, 1)).astype(np.float32)
        np.save(p(f"{name}_images.npy"), images)
        torch.save(model.state_dict(), p(f"{name}_state.pt"))
        logits, feat = make_extract_fn(model)(torch.from_numpy(images).cuda())
        eager[name] = (logits.cpu().numpy(), feat.cpu().numpy())
        jobs.append({"artifact": p(f"{name}.pt2"),
                     "state": p(f"{name}_state.pt"),
                     "images": p(f"{name}_images.npy"),
                     "out": p(f"{name}_out.npz"), "calls": 4})
    with open(p("extract_jobs.json"), "w") as f:
        json.dump(jobs, f)
    res = tool.run_child(["--extract-child", p("extract_jobs.json"), ROOT])
    checks, rep = {}, {"export_seconds": secs, **res}
    for (name, _, kernel), job, run in zip(AOT_EXTRACT, jobs, res["extract"]):
        got = np.load(job["out"])
        err = float(np.abs(got["features"] - eager[name][1]).max())
        rep[f"{name}_feature_max_abs_err"] = err
        checks[f"{name}_features_1e-5"] = err <= 1e-5
        checks[f"{name}_{kernel}_once_a_call"] = (
            run["launches_per_call"][kernel] == 1)
        read_launches_from(ctx, {kernel: int(run["launches_per_call"][kernel]
                                             * job["calls"])})
    checks["no_model_imports"] = not res["models_or_detect_imported"]
    return {"checks": checks, **rep}


def phase_aot(ctx):
    """AOT export on the card (module docstring): the serving cell through
    ``export_aot`` as an ExportedProgram, an AOTInductor package and its
    kernel bundle; each route loaded in a fresh process that refuses the
    port's models and detect (cold start to the first identified frame,
    B5 / B3 / B2 counted inside the artifact, every kernel call of one
    dispatch held to its plain version, frames/s, device ms and the idle
    share), its answers held to the eager pipeline's on the same frames;
    then the extraction artifacts (B4, B6)."""
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        efm3,
        nms,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        from_jax_params,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.pipeline import (
        make_multistream_pipeline,
    )

    tool = _coldstart_tool()
    checks, rep = {}, {"torch": torch.__version__, "cuda": torch.version.cuda}
    with tempfile.TemporaryDirectory() as work:
        arts = tool.export_serving(work)
        rep["export"] = {k: arts[k] for k in ("seconds", "bytes",
                                               "bundle_files")}
        inputs = tool.serving_inputs(os.path.join(work, "inputs.npz"))
        full_f32()
        pipe = make_multistream_pipeline(
            MTCNNDetector(seed=0), from_jax_params(arts["export_dir"],
                                                   dtype=torch.float32),
            None, frame_h=FRAME_HW[0], frame_w=FRAME_HW[1], embed_size=IMAGE,
            thresholds=(0.3, 0.3, 0.3), dynamic_gallery=True)
        data = np.load(inputs)
        frames = torch.from_numpy(data["frames"]).cuda()
        gallery = torch.from_numpy(data["gallery"]).cuda()
        rows = torch.tensor(tool.GALLERY_ROWS, dtype=torch.int32,
                            device="cuda")
        for c in ctx["counters"].values():
            c.reset()
        eager = [{k: v.cpu().numpy() for k, v in
                  pipe(frames[i], gallery, rows).items()}
                 for i in range(frames.shape[0])]
        torch.cuda.synchronize()
        eager_counts = {k: ctx["counters"][k].count / frames.shape[0]
                        for k in ("nms", "stem", "efm3")}
        with tool.KernelCalls() as calls:
            pipe(frames[0], gallery, rows)
            torch.cuda.synchronize()
        eager_masks = [got.cpu().numpy() for kind, _, got in calls.calls
                       if kind == "nms"]
        rep["eager"] = {"launches_per_dispatch": eager_counts,
                        "faces_found": int(sum(o["found"].sum()
                                               for o in eager)),
                        **tool.measure(torch, pipe, frames, gallery, rows)}
        # the eager wrappers' host cost a call (the efm3 and nms phases'
        # measure), with the facejax ops registered beside them
        x = torch.randn(STREAMS * 8 * 8, 387, device="cuda")
        boxes = torch.rand(STREAMS, 64, 5, device="cuda") * 100
        rep["eager_host_us"] = {
            "efm3": host_us(lambda: efm3.efm3_rows(x)),
            "nms": host_us(lambda: nms.nms_mask_batched(boxes, 0.7, "Min"),
                           calls=300)}
        checks["eager_b5_b3_b2_4_1_29"] = eager_counts == {
            "nms": 4, "stem": 1, "efm3": 29}
        checks["eager_finds_faces"] = rep["eager"]["faces_found"] > 0
        for route in AOT_ROUTES:
            res = tool.run_route(route, arts, inputs, work)
            atol = 1e-5 if route == "exported" else AOTI_SIM_ATOL
            cmp = _aot_compare(eager, eager_masks, res.pop("out"), atol)
            rep[route] = {**res, "vs_eager": cmp}
            checks[f"{route}_equals_eager"] = cmp["ok"]
            checks[f"{route}_b5_b3_b2_4_1_29"] = res[
                "launches_per_dispatch"] == {"nms": 4, "stem": 1, "efm3": 29}
            checks[f"{route}_calls_equal_plain"] = res[
                "kernel_calls_vs_plain"]["ok"]
            checks[f"{route}_no_model_imports"] = not res[
                "models_or_detect_imported"]
        read_launches_from(ctx, {k: int(v * (tool.DISPATCHES - 1))
                                 for k, v in rep["exported"][
                                     "launches_per_dispatch"].items()})
        ext = aot_extract(ctx, tool, work)
        checks.update(ext.pop("checks"))
        rep["extract"] = ext
    return {"ok": all(checks.values()), "checks": checks, **rep}


# the models phase: DeepFace at its canonical 152x152x3 with its full
# widths (LC 16, f7 4,096) on the JAX twin's ladder (C3 62, L4 54, L5 48,
# L6 44: 229 M parameters, not the paper's 118.9 M, whose L5 takes stride
# 2: ``deepface_cvpr14``), 64 pairs a step at the rate of the JAX
# package's DeepFace step test (Adam 1e-3: flax's init leaves DeepFace's
# features ~3e-7 in size, PERF.md); BEGAN-CS at 64x64 with the model's
# default widths (n = 64, h = 64), 16 pairs a step
DEEPFACE_SIDE, DEEPFACE_IDS, DEEPFACE_EPOCHS, DEEPFACE_LR = 152, 64, 5, 1e-3
BEGAN_SIDE, BEGAN_IDS, BEGAN_EPOCHS = 64, 64, 3


def _faces_store(path, ids, side, seed) -> str:
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        save_image_store,
        synthetic_faces,
    )

    faces, labels = synthetic_faces(num_ids=ids, per_id=4, size=side,
                                    channels=3, seed=seed)
    save_image_store(path, faces, labels)
    return path


def _b1_gaps(torch, calls) -> dict:
    """B1's picks against the plain version's on the same inputs: how many
    differ, the largest gap between two picks' distances (float64), how
    many differences no rounding explains, whether every pick is a
    negative, and how many anchor rows were zero."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        mining,
    )

    gap, negatives, zero_rows, unexplained, differing = 0.0, True, 0, 0, 0
    for (anc, pos_sq, al, pool, pl), got in calls:
        want = mining.semi_hard_mining_plain(anc, pos_sq, al, pool, pl)
        diff = got != want
        differing += int(diff.sum())
        zero_rows += int((anc.abs().sum(1) == 0).sum())
        negatives &= bool((pl[got.long()] != al).all())
        if diff.any():
            dist = lambda idx: ((anc.double() - pool[idx.long()].double())  # noqa: E731
                                ** 2).sum(1)
            dg, dw = dist(got), dist(want)
            ps = pos_sq.double()
            gap = max(gap, float((dg - dw).abs()[diff].max()))
            # a differing pick is explained by rounding when the two
            # picks' distances tie, or when either sits on the semi-hard
            # threshold (d > pos_sq) within rounding
            near = (((dg - dw).abs() <= 1e-5) | ((dg - ps).abs() <= 1e-5)
                    | ((dw - ps).abs() <= 1e-5))
            unexplained += int((diff & ~near).sum())
    return {"differing": differing, "max_gap": gap,
            "unexplained": unexplained, "all_negatives": negatives,
            "zero_anchor_rows": zero_rows}


def _record_b1(ctx, run):
    """``run()`` with the launch counts set to 0 just before and read just
    after, and every B1 call's inputs and picks recorded."""
    import torch

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
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: c.count for k, c in ctx["counters"].items() if c.count}
    finally:
        steps_mod.semi_hard_mining = real
    return out, calls, launches, secs, torch.cuda.max_memory_allocated()


def phase_models(ctx):
    """The other models on the card (module docstring): ``train_backbone
    --model deepface`` at 152x152x3 and full width (the JAX twin's
    ladder), then ``extract_features
    --model deepface`` over its export; ``train_began`` at 64x64 with the
    default widths; both with ``--mining semi_hard_fused`` (B1 picks held
    to the plain version's on the same features)."""
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        extract_features,
        train_backbone,
        train_began,
    )

    checks, rep = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda name: os.path.join(tmp, name)  # noqa: E731
        store = _faces_store(p("df.npz"), DEEPFACE_IDS, DEEPFACE_SIDE, 0)
        argv = ["--images", store, "--model", "deepface", "--epochs",
                str(DEEPFACE_EPOCHS), "--batch-size", "64", "--lr",
                str(DEEPFACE_LR), "--mining",
                "semi_hard_fused", "--device", "cuda", "--out-dir", p("df")]
        (state, hist), calls, launches, secs, peak = _record_b1(
            ctx, lambda: train_backbone.main(argv))
        steps = [st for h in hist for st in h.steps]
        losses = [st["loss"] for st in steps]
        read_launches_from(ctx, {"mining": launches.get("mining", 0)})
        gaps = rep["deepface_b1_gaps"] = _b1_gaps(torch, calls)
        rep["deepface"] = {
            "steps": len(steps), "launches": launches,
            "epoch_loss": [h.train["loss"] for h in hist],
            "steps_per_s": len(steps) / sum(st["seconds"] for st in steps),
            "seconds": secs, "peak_gib": peak / 2 ** 30,
            "params": sum(q.numel() for q in state.model.parameters())}
        checks["deepface_tf32_off"] = tf32_off()
        checks["deepface_b1_once_a_step"] = launches.get("mining") == len(
            steps)
        checks["deepface_b1_equals_plain"] = (gaps["unexplained"] == 0
                                              and gaps["all_negatives"])
        # B1 at DeepFace's width on exact integer rows: no rounding, so
        # every pick must equal the plain version's
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
            mining,
        )

        args = _int_rows(torch, np.random.default_rng(6), 64, 128, 4096, 16)
        checks["b1_exact_d4096"] = bool(
            (mining.semi_hard_mining(*args)
             == mining.semi_hard_mining_plain(*args)).all())
        checks["deepface_loss_finite_falling"] = (
            bool(np.isfinite(losses).all())
            and hist[-1].train["loss"] < hist[0].train["loss"])
        out = extract_features.main(["--train-images", store, "--export-dir",
                                     p("df/export"), "--batch-size", "128",
                                     "--out-dir", p("dfx"), "--device",
                                     "cuda"])
        feats = np.load(p("dfx/train.npz"))["features"]
        rep["deepface_extract"] = {"rows": int(feats.shape[0]),
                                   "dim": int(feats.shape[1])}
        checks["deepface_extract_4096_finite"] = (
            feats.shape == (DEEPFACE_IDS * 4, 4096)
            and bool(np.isfinite(feats).all()))
        del out, state

        store = _faces_store(p("bg.npz"), BEGAN_IDS, BEGAN_SIDE, 1)
        argv = ["--images", store, "--epochs", str(BEGAN_EPOCHS),
                "--batch-size", "16", "--filters", "64", "--h-dim", "64",
                "--mining", "semi_hard_fused", "--sample-every", "1",
                "--device", "cuda", "--out-dir", p("bg")]
        (gstate, conv), calls, launches, secs, peak = _record_b1(
            ctx, lambda: train_began.main(argv))
        gaps = _b1_gaps(torch, calls)
        steps = gstate.step
        rep["began"] = {"steps": steps, "launches": launches,
                        "convergence": conv, "k_t": float(gstate.k_t),
                        "steps_per_s": steps / secs, "seconds": secs,
                        "peak_gib": peak / 2 ** 30, "b1_gaps": gaps}
        checks["began_b1_once_a_step"] = launches.get("mining") == steps
        checks["began_b1_equals_plain"] = (gaps["unexplained"] == 0
                                           and gaps["all_negatives"])
        checks["began_convergence_finite_falling"] = (
            bool(np.isfinite(conv).all()) and conv[-1] < conv[0])
        checks["began_k_t_moved"] = float(gstate.k_t) > 0.0
        checks["began_samples_written"] = os.path.exists(
            p(f"bg/samples_{BEGAN_EPOCHS - 1:04d}.jpg"))
    return {"ok": all(checks.values()), "checks": checks, **rep}


# the parallel slice (``parallel``): the runs on several ranks, each rank
# a process of ``tools/parallel_ranks_torch.py`` under the launcher, all
# of them on the one card over gloo: the head's 2 data ranks, the
# class-parallel LightCNN29's data 1 x model 3 (55,005 = 3 * 5 * 19 * 193:
# 3 divides it, 2 does not), LightCNN29's 2 data ranks, the
# gallery-sharded serving's 2 gallery ranks
PARALLEL_RANKS = {"head": 2, "cp": 3, "dp": 2, "serve": 2}
# losses of a multi-rank run against the world-1 run's from the same
# state (the head's every step; a backbone run's first)
PARALLEL_LOSS_RTOL = 1e-5
# the updated fc2 after a backbone run's first step against the world-1
# run's (absolute: Adam's first update is about lr x sign(gradient))
PARALLEL_FC2_ATOL = 1e-6


def _launch_ranks(job: str, ranks: int, out: str, *args,
                  timeout: float = 600.0) -> tuple[list, bool, float]:
    """``tools/parallel_ranks_torch.py JOB`` on ``ranks`` processes under
    ``torch.distributed.run``: each rank's report (printed, one line a
    rank), whether every rank ran and passed its checks, and the wall
    seconds of the launch."""
    os.makedirs(out, exist_ok=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={ranks}",
           os.path.join(ROOT, "tools", "parallel_ranks_torch.py"), job, out,
           *args]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=timeout)
    seconds = time.perf_counter() - t0
    reports = []
    for r in range(ranks):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                reports.append(json.load(f))
    for rep in reports:
        emit({"parallel_rank": {k: rep[k] for k in (
            "job", "rank", "world", "backend", "device", "launches",
            "seconds", "peak_gib", "ok")}})
    ok = run.returncode == 0 and len(reports) == ranks and all(
        rep["ok"] for rep in reports)
    if not ok:
        print(run.stdout[-3000:], run.stderr[-6000:], file=sys.stderr)
    return reports, ok, seconds


def _trimmed(reports, keys) -> list[dict]:
    """``keys`` of each rank's report (those it has)."""
    return [{k: r[k] for k in keys if k in r} for r in reports]


def _world1_backbone(ctx, store, model, out, reference, ranks=0):
    """``train_backbone --data-parallel`` run plainly (an NCCL group of
    one) with :func:`parallel_ranks_torch.backbone_argv`'s arguments, its
    step standing in for ``ranks`` data ranks when ``ranks`` is given
    (:func:`parallel_ranks_torch.ranks_in_one_process`): its launch
    counts, and its per-step gradients, updated ``fc2`` and losses saved
    to ``reference`` for the ranks to hold theirs to."""
    import torch

    import parallel_ranks_torch as tool

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        train_backbone,
    )

    grads, fc2_after = [], []
    undo = [tool.record_grads(grads, fc2_after)]
    if ranks:
        undo.append(tool.ranks_in_one_process(ranks))
    try:
        for c in ctx["counters"].values():
            c.reset()
        state, hist = train_backbone.main(tool.backbone_argv(
            store, model, "dp", out))
        torch.cuda.synchronize()
        launches = {k: ctx["counters"][k].count
                    for k in PATH_KERNELS["parallel"]}
    finally:
        for u in undo:
            u()
    losses = [s["loss"] for h in hist for s in h.steps]
    torch.save({"grads": grads, "losses": losses, "fc2_after": fc2_after},
               reference)
    return launches, losses, state.step


def _grad_gaps(reports, parts: int) -> list[dict]:
    """Per step, the worst per-leaf relative gap over the ranks, and the
    ``fc2`` gradient's relative gap with its ``parts`` blocks put
    together."""
    out = []
    for i in range(len(reports[0]["steps"])):
        worst = max((rep["steps"][i] for rep in reports),
                    key=lambda s: s["max_grad_rel_gap"])
        step = {"max_grad_rel_gap": worst["max_grad_rel_gap"],
                "at": worst["at"]}
        if parts > 1:
            diff = sum(rep["fc2_block_sq"][i][0] for rep in reports)
            ref = sum(rep["fc2_block_sq"][i][1] for rep in reports)
            step["fc2_concat_rel_gap"] = (diff / ref) ** 0.5
        if "other_max_grad_rel_gap" in worst:
            step["other_max_grad_rel_gap"] = max(
                rep["steps"][i]["other_max_grad_rel_gap"] for rep in reports)
        out.append(step)
    return out


def phase_parallel(ctx):
    """Data and class parallelism on the card (module docstring): each
    multi-rank run held to the world-1 run of the same CLI, each rank's
    kernel calls to their plain versions, launches on every rank."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        extract_features,
        train_head,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        save_feature_store,
        save_image_store,
        save_image_store_mmap,
        split_identities,
        synthetic_features,
    )

    checks, rep = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        p = lambda *a: os.path.join(tmp, *a)  # noqa: E731

        # (1) train_head --data-parallel: world 1, then 2 ranks
        feats, labels = synthetic_features(
            num_ids=HEAD_IDS, per_id=HEAD_PER_ID, dim=FEAT_DIM, seed=0)
        train_mask, test_mask = split_identities(labels, 0.7)
        for name, mask in (("train", train_mask), ("test", test_mask)):
            save_feature_store(p(f"{name}.npz"), feats[mask], labels[mask])
        for c in ctx["counters"].values():
            c.reset()
        t0 = time.perf_counter()
        _, hist = train_head.main([
            "--features", p("train.npz"), "--test-features", p("test.npz"),
            "--batch-size", str(HEAD_BATCH), "--epochs", str(HEAD_EPOCHS),
            "--mining", "semi_hard_fused", "--device", "cuda",
            "--data-parallel", "--out-dir", p("head1")])
        torch.cuda.synchronize()
        head_w1 = {"seconds": time.perf_counter() - t0,
                   "launches": read_launches(ctx, "parallel")}
        w1 = [s["loss"] for h in hist for s in h.steps]
        heads, ok, secs = _launch_ranks("head", PARALLEL_RANKS["head"],
                                        p("head2"), p("train.npz"),
                                        p("test.npz"))
        checks["head_ranks_ran_and_held_b1"] = ok
        gaps = [max(abs(a - b) / abs(b) for a, b in zip(r["losses"], w1))
                for r in heads] or [float("inf")]
        checks["head_losses_rtol_1e-5_vs_world1"] = ok and all(
            len(r["losses"]) == len(w1) for r in heads) and max(
                gaps) <= PARALLEL_LOSS_RTOL
        checks["head_b1_on_every_rank"] = ok and all(
            r["launches"]["mining"] == r["b1_calls"] > 0 for r in heads)
        rep["head"] = {"world1": head_w1, "world1_losses": w1,
                       "launch_seconds": secs, "max_loss_rel_gap": max(gaps),
                       "ranks": _trimmed(heads, (
                           "launches", "seconds", "peak_gib", "b1_shapes",
                           "b1_differing", "b1_unexplained"))}

        # (2) --class-parallel 3 (LightCNN29, 55,005 classes) against
        # --data-parallel run plainly, the same steps of an .npz store
        # (every rank draws the world-1 run's global batches)
        faces, classes = backbone_faces(3 * BACKBONE_PAIRS, BACKBONE_SIDE,
                                        seed=0)
        save_image_store(p("bb128.npz"), faces, classes)
        ref = p("ref_lightcnn29.pt")
        w1_launches, w1_losses, w1_steps = _world1_backbone(
            ctx, p("bb128.npz"), "lightcnn29", p("bbw1"), ref)
        cps, ok, secs = _launch_ranks("backbone", PARALLEL_RANKS["cp"],
                                      p("cp"), p("bb128.npz"), "lightcnn29",
                                      f"cp{PARALLEL_RANKS['cp']}", ref)
        checks["cp_ranks_ran_and_held_b1_b2_efm3_bwd"] = ok
        rep["class_parallel"] = {"ranks": _trimmed(cps, (
            "ok", "launches", "seconds", "peak_gib", "losses",
            "fc2_max_abs_gap_after_step", "b1_differing", "b1_unexplained",
            "b2_calls_held", "b2_bit_equal", "efm3_bwd_calls_held",
            "efm3_bwd_bit_equal", "steps"))}
        if ok:
            steps = _grad_gaps(cps, PARALLEL_RANKS["cp"])
            checks["cp_first_step_grads_rtol_vs_world1"] = (
                steps[0]["max_grad_rel_gap"] <= BACKBONE_GRAD_RTOL
                and steps[0]["fc2_concat_rel_gap"] <= BACKBONE_GRAD_RTOL)
            checks["cp_fc2_blocks_concat_equal_world1_fc2"] = max(
                r["fc2_max_abs_gap_after_step"][0]
                for r in cps) <= PARALLEL_FC2_ATOL
            checks["cp_fc2_block_is_a_third"] = all(
                r["fc2_local_shape"][0] * PARALLEL_RANKS["cp"]
                == BACKBONE_CLASSES for r in cps)
            # the first step starts from the world-1 run's state; later
            # ones from weights that differ by rounding (reported)
            checks["cp_first_step_loss_rtol_1e-5_vs_world1"] = all(
                abs(r["losses"][0] - w1_losses[0])
                <= PARALLEL_LOSS_RTOL * abs(w1_losses[0]) for r in cps)
            checks["cp_b1_b2_efm3_bwd_on_every_rank"] = all(
                r["launches"]["mining"] == w1_steps
                and r["launches"]["efm3"] == w1_launches["efm3"]
                and r["launches"]["efm3_bwd"] == w1_launches["efm3_bwd"]
                for r in cps)
            rep["class_parallel"].update(
                steps=steps, world1_launches=w1_launches,
                world1_losses=w1_losses, launch_seconds=secs)
        checks["world1_lightcnn29_launched_b1_b2_efm3_bwd"] = (
            w1_launches["mining"] == w1_steps == 3
            and w1_launches["efm3"] == 30 * w1_steps
            and w1_launches["efm3_bwd"] == 30 * w1_steps)
        read_launches_from(ctx, w1_launches)

        # (3) --data-parallel over 2 ranks (the same LightCNN29 and
        # store, dropout and the triplet term on) against a world-1 run
        # whose step computes what the 2 ranks compute: each rank embeds
        # its half on its own (its dropout masks, its BatchNorm batch),
        # and mines and takes its loss over the concatenated pool; the
        # gap to the plain world-1 run (one batch of 128 through the net,
        # BatchNorm over all of it, rank 0's masks) is reported
        dp_ref = p("ref_lightcnn29_dp.pt")
        dp_w1, dp_losses, dp_steps = _world1_backbone(
            ctx, p("bb128.npz"), "lightcnn29", p("dpw1"), dp_ref,
            PARALLEL_RANKS["dp"])
        dps, ok, secs = _launch_ranks("backbone", PARALLEL_RANKS["dp"],
                                      p("dp"), p("bb128.npz"), "lightcnn29",
                                      "dp", dp_ref, ref)
        checks["dp_ranks_ran_and_held_b1_b2_efm3_bwd"] = ok
        rep["data_parallel"] = {"ranks": _trimmed(dps, (
            "ok", "launches", "seconds", "peak_gib", "losses",
            "fc2_max_abs_gap_after_step", "b1_differing", "b1_unexplained",
            "b2_calls_held", "b2_bit_equal", "efm3_bwd_calls_held",
            "efm3_bwd_bit_equal", "steps"))}
        if ok:
            steps = _grad_gaps(dps, 1)
            checks["dp_first_step_grads_rtol_vs_ranks_in_one_process"] = (
                steps[0]["max_grad_rel_gap"] <= BACKBONE_GRAD_RTOL)
            checks["dp_fc2_equal_ranks_in_one_process"] = max(
                r["fc2_max_abs_gap_after_step"][0]
                for r in dps) <= PARALLEL_FC2_ATOL
            checks["dp_first_step_loss_rtol_1e-5_vs_ranks_in_one_process"] = (
                all(abs(r["losses"][0] - dp_losses[0])
                    <= PARALLEL_LOSS_RTOL * abs(dp_losses[0]) for r in dps))
            checks["dp_b1_b2_efm3_bwd_on_every_rank"] = all(
                r["launches"]["mining"] == dp_steps
                and r["launches"]["efm3"] == w1_launches["efm3"]
                and r["launches"]["efm3_bwd"] == w1_launches["efm3_bwd"]
                for r in dps)
            rep["data_parallel"].update(
                steps=steps, world1_launches=dp_w1,
                world1_losses=dp_losses, launch_seconds=secs)
        # the stand-in mines once a rank a step
        checks["dp_world1_b1_once_a_rank_a_step"] = (
            dp_w1["mining"] == PARALLEL_RANKS["dp"] * dp_steps)

        # (4) gallery-sharded 16-stream serving over 2 ranks
        serves, ok, secs = _launch_ranks("serve", PARALLEL_RANKS["serve"],
                                         p("serve"))
        checks["serve_ranks_equal_unsharded_and_plain"] = ok
        checks["serve_b5_b3_b2_on_every_rank"] = ok and all(
            r["launches_sharded_dispatch"]["nms"] > 0
            and r["launches_sharded_dispatch"]["stem"] == 1
            and r["launches_sharded_dispatch"]["efm3"] > 0 for r in serves)
        rep["serve"] = {"launch_seconds": secs, "ranks": _trimmed(serves, (
            "launches_sharded_dispatch", "seconds", "peak_gib",
            "max_similarity_gap", "max_similarity_gap_16_stream_batch",
            "local_frames", "gallery_block", "found", "checks", "held"))}

        # (5) extract_features --data-parallel run plainly: the same rows
        # as the plain run, B3 once and B2 29 times a batch
        faces_x, labels_x = backbone_faces(2 * EXTRACT_BATCH, BACKBONE_SIDE,
                                           seed=3)
        save_image_store_mmap(p("x128"), faces_x, labels_x)
        argv = ["--train-images", p("x128"), "--model", "lightcnn29",
                "--batch-size", str(EXTRACT_BATCH), "--device", "cuda"]
        for c in ctx["counters"].values():
            c.reset()
        t0 = time.perf_counter()
        dp = extract_features.main(argv + ["--data-parallel", "--out-dir",
                                           p("xdp")])["train"]
        torch.cuda.synchronize()
        x_seconds = time.perf_counter() - t0
        x_launches = read_launches(ctx, "parallel")
        plain = extract_features.main(argv + ["--out-dir", p("xplain")])[
            "train"]
        checks["extract_dp_rows_equal_plain_run"] = bool(
            np.array_equal(dp.features, plain.features)
            and np.array_equal(dp.predictions, plain.predictions))
        checks["extract_dp_b3_b2_per_batch"] = (
            x_launches["stem"] == 2 and x_launches["efm3"] == 2 * 29)
        rep["extract"] = {"launches": x_launches, "seconds": x_seconds}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    return {"ok": all(checks.values()), "checks": checks, "card": smi,
            **rep}


PHASES = {"build": phase_build, "nms": phase_nms, "stem": phase_stem,
          "efm3": phase_efm3, "mining": phase_mining, "front9": phase_front9,
          "stem2": phase_stem2, "slice": phase_slice, "head": phase_head,
          "extract": phase_extract, "serve9": phase_serve9,
          "backbone": phase_backbone, "lfw": phase_lfw, "live": phase_live,
          "int8": phase_int8, "landmarks": phase_landmarks,
          "aot": phase_aot, "models": phase_models,
          "parallel": phase_parallel}


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
