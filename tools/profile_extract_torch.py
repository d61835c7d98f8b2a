#!/usr/bin/env python3
"""Where the time of one LightCNN9 or LightCNN29 extraction batch goes, on
one GPU (PyTorch port), with the fused front and with the unfused one.

Sets up extraction as ``chip_smoke.py``'s extract phase runs it: batch 128
of uint8 synthetic faces (1,024 rows, held in host memory as the store
hands them over), 128x128 or, with ``--hw 112x96``, their 112x96 center
crops, random weights from seed 0, TF32 off, through
``extract.extract_features`` (per batch: a pageable copy to the card, /255
there, the forward, L2 normalization, top-1, the copy back). For each
pass, in the order fused, unfused, unfused, fused, it times WINDOWS
unprofiled windows of at least SECONDS of back-to-back batches, then traces
TRACED batches with ``torch.profiler``. The fused front is the model's own
path: for LightCNN9 kernel B6 at 128x128 or kernel B4 at 112x96; for
LightCNN29 (``--model lightcnn29``) kernel B3 (group1: the 5x5 conv, efm3
and the pool in one pass) with kernel B2 in every later efm3. The unfused
front, routed in this process only: LightCNN9's layer-by-layer path (B3's
stem, then cuDNN's conv2a and conv2, mfm2 and the pool, by replacing
``lightcnn9_front_route``); LightCNN29's ``reference_stem`` (cuDNN's conv,
efm3 and the pool, by replacing the stem kernel's wrapper that
``models/lightcnn.py`` calls). Prints one JSON line per pass: wall ms per
batch and embeddings/s of each window, device ms per batch by kernel
family and the top kernels, the device's idle share (1 - device ms / the
unprofiled wall ms per batch, both from this process), and last the card's
name and power limit. ``--bf16`` runs the same passes with the net in
bfloat16 (cuDNN and the kernels' bf16 instances on the tensor cores, f32
sums).

    python tools/profile_extract_torch.py [--model lightcnn9|lightcnn29]
                                          [--bf16] [--hw 112x96]

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

FAMILIES = (("front9", "front9_kernel"), ("front9_bf16", "front9_tc_kernel"),
            ("stem2", "stem2_kernel"), ("stem_bf16", "stem_tc_kernel"),
            ("stem", "stem_kernel"), ("efm3", "efm3_kernel"), ("memcpy", "memcpy"), ("conv", "conv"),
            ("conv", "cudnn"), ("conv", "implicit"), ("conv", "winograd"),
            ("conv", "xmma"),
            ("gemm", "gemm"), ("gemm", "cutlass"), ("pool", "pool"),
            ("reduce", "reduce"), ("arg", "argm"))
WINDOWS, SECONDS, TRACED = 3, 3.0, 8
ROWS, SIDE = 1024, 128
ORDER = ("fused", "unfused", "unfused", "fused")


def family(name: str) -> str:
    low = name.lower()
    for fam, key in FAMILIES:
        if key in low:
            return fam
    return "elementwise/other"


def main(argv: list[str]) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_extract_torch: needs CUDA", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import EXTRACT_BATCH
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        synthetic_faces,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.extract import (
        extract_features,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        lightcnn,
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.s2d_stem import (
        reference_stem,
    )

    h, w = SIDE, SIDE
    if "--hw" in argv:
        h, w = (int(v) for v in argv[argv.index("--hw") + 1].split("x"))
    faces, _ = synthetic_faces(num_ids=64, per_id=ROWS // 64, size=SIDE)
    y0, x0 = (SIDE - h) // 2, (SIDE - w) // 2
    images = (faces[:, y0:y0 + h, x0:x0 + w] * 255.0).clip(0, 255).astype(
        "uint8")
    dtype = torch.bfloat16 if "--bf16" in argv else torch.float32
    name = argv[argv.index("--model") + 1] if "--model" in argv else \
        "lightcnn9"
    if name not in ("lightcnn9", "lightcnn29"):
        print(f"profile_extract_torch: --model takes lightcnn9 or "
              f"lightcnn29, got {name}", file=sys.stderr)
        return 2
    model = model_by_name(name, 1000, input_hw=(h, w),
                          dtype=dtype,
                          generator=torch.Generator().manual_seed(0))
    route = lightcnn.lightcnn9_front_route
    fused_stem = lightcnn.stem_conv_maxout_pool

    def unfused_stem(x, w, b, *, maxout):
        return reference_stem(x, w, b, maxout=maxout)
    batches_per_call = ROWS // EXTRACT_BATCH

    def window(seconds: float) -> tuple[int, float]:
        n, t0 = 0, time.perf_counter()
        while True:
            extract_features(model, images, batch_size=EXTRACT_BATCH)
            n += batches_per_call
            dt = time.perf_counter() - t0
            if dt >= seconds:
                return n, dt

    for mode in ORDER:
        if name == "lightcnn9":
            lightcnn.lightcnn9_front_route = route if mode == "fused" else (
                lambda *a, **k: "plain")
        else:
            lightcnn.stem_conv_maxout_pool = (fused_stem if mode == "fused"
                                              else unfused_stem)
        window(1.0)                                     # warm-up
        wins = []
        for _ in range(WINDOWS):
            n, dt = window(SECONDS)
            wins.append(dt / n * 1e3)
        steady_ms = sum(wins) / len(wins)
        one = images[:EXTRACT_BATCH * TRACED]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            extract_features(model, one, batch_size=EXTRACT_BATCH)
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
        short = defaultdict(float)   # names cut to 80 characters, summed
        for name, ms in by_name.items():
            short[name[:80]] += ms / TRACED
        top = sorted(short.items(), key=lambda kv: -kv[1])[:10]
        print(json.dumps({
            "model": name, "mode": mode, "dtype": str(dtype).split(".")[1],
            "batch": EXTRACT_BATCH, "hw": [h, w],
            "wall_ms_per_batch_windows": wins,
            "embeddings_per_s_windows": [EXTRACT_BATCH / w * 1e3
                                         for w in wins],
            "device_ms_per_batch": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / steady_ms),
            "kernel_launches_per_batch": sum(launches.values()) / TRACED,
            "by_family_ms": dict(sorted(fams.items(),
                                        key=lambda kv: -kv[1])),
            "by_family_launches_per_batch": {
                k: v / TRACED for k, v in fam_launch.items()},
            "top_kernels_ms": dict(top),
        }), flush=True)
    lightcnn.lightcnn9_front_route = route
    lightcnn.stem_conv_maxout_pool = fused_stem
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
