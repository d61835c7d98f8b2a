#!/usr/bin/env python3
"""Where the time of an LFW evaluation run and of an alignment call goes,
on one GPU (PyTorch port).

Sets up the LFW cell as ``chip_smoke.py``'s lfw phase does: 6,000
synthetic pairs in LFW's fold layout (``chip_smoke.lfw_pairs``) at
128x128, a random LightCNN29 (or ``--model lightcnn9``) from seed 0
exported by the port, ``lfw_eval --images --export-dir`` at its batch of
256 in bf16, TF32 off. It times the CLI's parts one by one (the npz
load, the host ``/255``, the embedding loop, the protocol), then traces
one ``main`` with ``torch.profiler``: device ms by kernel family, and the
card's idle share (1 - device ms / the wall of one unprofiled ``main`` in
the same process). Then the same for ``DeviceCascade.detect_batch`` over
16 frames of 250x250 a call (random seed-0 detector, thresholds 0.3):
device ms a call by family over CALLS calls, and the idle share against
one unprofiled window of CALLS calls. Prints one JSON line for each, and
last the card's name and power limit. The throughputs themselves (pairs/s,
frames/s over three windows) are ``chip_smoke.py lfw``'s.

    python tools/profile_lfw_torch.py [--model lightcnn9]

Needs CUDA.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAMILIES = (("front9_bf16", "front9_tc_kernel"), ("stem_bf16", "stem_tc"),
            ("efm3", "efm3_kernel"), ("nms", "nms"), ("memcpy", "memcpy"),
            ("conv", "conv"), ("conv", "cudnn"), ("conv", "xmma"),
            ("gemm", "gemm"), ("gemm", "cutlass"), ("pool", "pool"),
            ("sort", "sort"), ("reduce", "reduce"))
CALLS = 64


def family(name: str) -> str:
    low = name.lower()
    for fam, key in FAMILIES:
        if key in low:
            return fam
    return "elementwise/other"


def traced_ms(torch, fn) -> tuple[float, dict]:
    """Device ms of ``fn`` (summed kernel time) and ms by family."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fams = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            fams[family(ev.name)] += ev.time_range.elapsed_us() / 1e3
    return sum(fams.values()), dict(sorted(fams.items(),
                                           key=lambda kv: -kv[1]))


def profile_lfw_eval(torch, model_name: str, tmp: str) -> dict:
    import numpy as np

    from chip_smoke import LFW_BATCH, LFW_CLASSES, LFW_SIDE, lfw_pairs
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        lfw_eval,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        export_model,
    )

    images, issame = lfw_pairs(seed=0)
    store = os.path.join(tmp, "pairs.npz")
    np.savez(store, images=images, issame=issame)
    export = os.path.join(tmp, "export")
    export_model(export, model_by_name(
        model_name, LFW_CLASSES, input_hw=(LFW_SIDE, LFW_SIDE),
        generator=torch.Generator().manual_seed(0), device="cpu"))
    argv = ["--images", store, "--export-dir", export, "--model",
            model_name, "--batch-size", str(LFW_BATCH)]
    lfw_eval.main(argv)                                  # warm-up
    t0 = time.perf_counter()
    lfw_eval.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    parts = {}
    t0 = time.perf_counter()
    with np.load(store) as z:
        loaded = z["images"]
    parts["npz_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lfw_eval.scale_pair_images(loaded)
    parts["host_div_255_s"] = time.perf_counter() - t0
    args = lfw_eval.build_parser().parse_args(argv)
    net = lfw_eval.build_model(args, loaded.shape, torch.device("cuda"))
    t0 = time.perf_counter()
    emb = lfw_eval.pair_embeddings(net, loaded, LFW_BATCH)
    torch.cuda.synchronize()
    parts["embeddings_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    lfw_eval.evaluate_pairs(emb[0::2], emb[1::2], issame, args)
    parts["protocol_s"] = time.perf_counter() - t0
    device_ms, fams = traced_ms(torch, lambda: lfw_eval.main(argv))
    return {"run": "lfw_eval", "model": model_name, "pairs": int(issame.size),
            "unprofiled_wall_s": wall, "parts_s": parts, "device_ms": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / (wall * 1e3)),
            "by_family_ms": fams}


def profile_detect(torch) -> dict:
    from chip_smoke import ALIGN_CALL, ALIGN_TH, align_frames
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect import (
        MTCNNDetector,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.detect.device_cascade import (
        DeviceCascade,
    )

    frames = align_frames(ALIGN_CALL * CALLS, seed=0)
    cascade = DeviceCascade(MTCNNDetector(seed=0), thresholds=(ALIGN_TH,) * 3)

    def window():
        for i in range(0, len(frames), ALIGN_CALL):
            cascade.detect_batch(frames[i:i + ALIGN_CALL])
        torch.cuda.synchronize()

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # saturation
        window()                                           # warm-up
        t0 = time.perf_counter()
        window()
        wall = (time.perf_counter() - t0) / CALLS * 1e3
        device_ms, fams = traced_ms(torch, window)
    return {"run": "detect_batch", "frames_a_call": ALIGN_CALL,
            "unprofiled_wall_ms_a_call": wall,
            "device_ms_a_call": device_ms / CALLS,
            "device_idle_share": max(0.0, 1.0 - device_ms / CALLS / wall),
            "by_family_ms_a_call": {k: v / CALLS for k, v in fams.items()}}


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_lfw_torch: needs CUDA", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = argv[argv.index("--model") + 1] if "--model" in argv else \
        "lightcnn29"
    if name not in ("lightcnn9", "lightcnn29"):
        print(f"profile_lfw_torch: --model takes lightcnn9 or lightcnn29, "
              f"got {name}", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        print(json.dumps(profile_lfw_eval(torch, name, tmp)), flush=True)
    print(json.dumps(profile_detect(torch)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
