#!/usr/bin/env python3
"""Where the time of one full-width backbone training step goes, on one
GPU (PyTorch port), with and without prefetching.

Sets up the step as ``chip_smoke.py``'s backbone phase and
``train_backbone`` run it: LightCNN29 at 128x128, batch 64 pairs (128
images), 55,005 classes, Adam on the factor schedule, f32 with TF32 off,
``--mining semi_hard_fused`` (kernel B1), every EFM3 through kernel B2 and
its backward ``efm3_bwd``; 1,024 synthetic faces held in host memory as
uint8 (as the mmap store hands them over), the streaming batcher and the
CLI's host mirror. For each pass, in the order copy, prefetch, prefetch,
copy, it times WINDOWS unprofiled windows of at least SECONDS of
back-to-back steps (each step synced on its loss, as the CLI's loop is),
then traces TRACED steps with ``torch.profiler``. ``copy``: each batch
goes to the card inside the step (a pageable copy of uint8); ``prefetch``:
``data.prefetch_to_device(size=2)`` (pinned buffers, a side stream).
Prints one JSON line per pass: wall ms per step of each window, device ms
per step by kernel family and the top kernels, B1's and B2's forward and
backward device ms per step with their launches, the device's idle share
(1 - device ms / the unprofiled wall ms per step, both from this process),
and last the card's name and power limit.

    python tools/profile_backbone_torch.py

Needs CUDA.
"""

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the first matching key names a kernel's family
FAMILIES = (("efm3_bwd", "efm3_bwd_kernel"), ("efm3", "efm3_kernel"),
            ("mining", "mining_"), ("memcpy", "memcpy"),
            ("conv", "conv"), ("conv", "cudnn"), ("conv", "implicit"),
            ("conv", "winograd"), ("conv", "xmma"), ("conv", "dgrad"),
            ("conv", "wgrad"), ("gemm", "gemm"), ("gemm", "cutlass"),
            ("optimizer", "adam"), ("optimizer", "multi_tensor"),
            ("pool", "pool"), ("softmax", "softmax"), ("reduce", "reduce"),
            ("arg", "argm"))
WINDOWS, SECONDS, TRACED, ROWS = 3, 3.0, 4, 1024
ORDER = ("copy", "prefetch", "prefetch", "copy")


def family(name: str) -> str:
    low = name.lower()
    for fam, key in FAMILIES:
        if key in low:
            return fam
    return "elementwise/other"


def main(argv: list[str]) -> int:
    import itertools

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_backbone_torch: needs CUDA", file=sys.stderr)
        return 2
    from chip_smoke import (BACKBONE_CLASSES, BACKBONE_PAIRS, BACKBONE_SIDE,
                            backbone_faces)
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli.train_backbone import (
        MirrorBatches,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        ShardedPairBatcher,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data.prefetch import (
        prefetch_to_device,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.device import (
        full_f32,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
        backbone_optimizer,
        create_train_state,
        make_backbone_train_step,
    )

    full_f32()
    faces, labels = backbone_faces(ROWS, BACKBONE_SIDE, seed=0)
    images = (faces * 255.0).clip(0, 255).astype("uint8")
    batcher = ShardedPairBatcher((images, labels), BACKBONE_PAIRS, seed=0)
    batches = MirrorBatches(batcher, True, 0)
    model = model_by_name("lightcnn29", BACKBONE_CLASSES,
                          input_hw=(BACKBONE_SIDE, BACKBONE_SIDE),
                          generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, backbone_optimizer(
        "adam", decay_every_steps=6 * len(batcher)), 0)
    step = make_backbone_train_step(mining_mode="semi_hard_fused")

    def source(mode):
        forever = itertools.chain.from_iterable(
            iter(batches) for _ in itertools.count())
        return prefetch_to_device(forever, size=2) if mode == "prefetch" \
            else forever

    def run(it, n):
        for _ in range(n):
            _, m = step(state, *next(it))
            float(m["loss"])   # the loop's sync, as train_loop reads it

    def window(it, seconds):
        n, t0 = 0, time.perf_counter()
        while True:
            run(it, 2)
            n += 2
            dt = time.perf_counter() - t0
            if dt >= seconds:
                return n, dt

    for mode in ORDER:
        it = source(mode)
        window(it, 2.0)                                    # warm-up
        wins = []
        for _ in range(WINDOWS):
            n, dt = window(it, SECONDS)
            wins.append(dt / n * 1e3)
        steady_ms = sum(wins) / len(wins)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(it, TRACED)
            torch.cuda.synchronize()
        by_name, launches = defaultdict(float), defaultdict(int)
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name] += ev.time_range.elapsed_us() / 1e3
                launches[ev.name] += 1
        device_ms = sum(by_name.values()) / TRACED
        fams, fam_launch = defaultdict(float), defaultdict(int)
        for name, ms in by_name.items():
            fams[family(name)] += ms / TRACED
            fam_launch[family(name)] += launches[name]
        short = defaultdict(float)
        for name, ms in by_name.items():
            short[name[:80]] += ms / TRACED
        top = sorted(short.items(), key=lambda kv: -kv[1])[:12]
        print(json.dumps({
            "model": "lightcnn29", "mode": mode, "pairs": BACKBONE_PAIRS,
            "hw": [BACKBONE_SIDE, BACKBONE_SIDE],
            "classes": BACKBONE_CLASSES,
            "wall_ms_per_step_windows": wins,
            "device_ms_per_step": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / steady_ms),
            "kernel_launches_per_step": sum(launches.values()) / TRACED,
            "b1_ms_per_step": fams["mining"],
            "b2_forward_ms_per_step": fams["efm3"],
            "b2_backward_ms_per_step": fams["efm3_bwd"],
            "b1_b2_launches_per_step": {
                k: fam_launch[k] / TRACED
                for k in ("mining", "efm3", "efm3_bwd")},
            "by_family_ms": dict(sorted(fams.items(),
                                        key=lambda kv: -kv[1])),
            "by_family_launches_per_step": {
                k: v / TRACED for k, v in fam_launch.items()},
            "top_kernels_ms": dict(top),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        }), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
