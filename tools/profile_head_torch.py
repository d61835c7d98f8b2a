#!/usr/bin/env python3
"""Where the time of one triplet-head train step goes, on one GPU (PyTorch
port), with kernel B1 (``semi_hard_fused``) and with the plain
``semi_hard`` mining.

Sets up ``chip_smoke.py``'s head slice in one process: the 65,536-row
synthetic store of 4,096 identities (342-d), its 0.7 identity split, a
random 342->128 ``LinearHead``, SGD at the reference's rate, batches of
16384 from ``PairBatcher``. For each mode, in the order fused, plain,
plain, fused, it times WINDOWS unprofiled windows of at least SECONDS of
back-to-back steps fed numpy batches (as ``train_head`` feeds them), one
window fed batches already on the card (which leaves out the host-to-device
copy), then traces TRACED steps with ``torch.profiler``. Prints one JSON
line per pass: wall ms per step, device ms per step by kernel family and
the device's idle share (1 - device ms / the unprofiled wall ms per step,
both from this process), and last the card's name and power limit.

    python tools/profile_head_torch.py

Needs CUDA; TF32 is off as in chip_smoke.py.
"""

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# B1's three kernels: the hi / lo pre-pass, the wgmma main kernel, the merge
FAMILIES = (("mining", "mining_split"), ("mining", "mining_tc"),
            ("mining", "mining_merge"), ("memcpy", "memcpy"),
            ("gemm", "gemm"), ("gemm", "sm90_xmma"), ("gemm", "cutlass"),
            ("reduce", "reduce"), ("index", "index"), ("arg", "argm"))
WINDOWS, SECONDS, TRACED = 2, 3.0, 4
ORDER = ("semi_hard_fused", "semi_hard", "semi_hard", "semi_hard_fused")


def family(name: str) -> str:
    low = name.lower()
    for fam, key in FAMILIES:
        if key in low:
            return fam
    return "elementwise/other"


def window(torch, step, state, batches, seconds: float):
    """Steps back to back, each synced on its loss as the train loop does,
    for at least ``seconds``; returns (steps, wall seconds)."""
    n, t0 = 0, time.perf_counter()
    while True:
        _, m = step(state, *batches[n % len(batches)])
        float(m["loss"])
        n += 1
        dt = time.perf_counter() - t0
        if dt >= seconds:
            return n, dt


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_head_torch: needs CUDA", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import (
        EMB_DIM, FEAT_DIM, HEAD_BATCH, HEAD_IDS, HEAD_PER_ID,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        PairBatcher,
        split_identities,
        synthetic_features,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models.heads import (
        LinearHead,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.train import (
        create_train_state,
        make_head_train_step,
        sgd_wd,
    )

    feats, labels = synthetic_features(num_ids=HEAD_IDS, per_id=HEAD_PER_ID,
                                       dim=FEAT_DIM, seed=0)
    train, _ = split_identities(labels, 0.7)
    host = list(PairBatcher(feats[train], labels[train], HEAD_BATCH, seed=0))
    dev = [tuple(torch.as_tensor(x, device="cuda") for x in b) for b in host]
    state = create_train_state(
        LinearHead(FEAT_DIM, EMB_DIM,
                   generator=torch.Generator().manual_seed(0)).cuda(),
        sgd_wd(), 0)
    for mode in ORDER:
        step = make_head_train_step(mining_mode=mode)
        window(torch, step, state, host, 0.5)      # warm-up
        wins = []
        for _ in range(WINDOWS):
            n, dt = window(torch, step, state, host, SECONDS)
            wins.append(dt / n * 1e3)
        n, dt = window(torch, step, state, dev, SECONDS)
        on_card_ms = dt / n * 1e3
        steady_ms = sum(wins) / len(wins)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(TRACED):
                _, m = step(state, *host[i % len(host)])
                float(m["loss"])
            torch.cuda.synchronize()
        by_name, launches = defaultdict(float), defaultdict(int)
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name] += ev.time_range.elapsed_us() / 1e3
                launches[ev.name] += 1
        device_ms = sum(by_name.values()) / TRACED
        fams = defaultdict(float)
        for name, ms in by_name.items():
            fams[family(name)] += ms / TRACED
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({
            "mode": mode, "batch": HEAD_BATCH,
            "wall_ms_per_step_windows": wins,
            "wall_ms_per_step_batches_on_card": on_card_ms,
            "device_ms_per_step": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / steady_ms),
            "kernel_launches_per_step": sum(launches.values()) // TRACED,
            "by_family_ms": dict(sorted(fams.items(),
                                        key=lambda kv: -kv[1])),
            "top_kernels_ms": {k[:80]: v / TRACED for k, v in top},
        }), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
