"""Thesis rehearsal on the PyTorch/CUDA port: the reference's full
experiment chain at reference scale, with a mid-run SIGTERM preemption +
resume — the twin of ``tools/thesis_rehearsal.py``.

Reference chain (train_efm.py -> extract_feacture_v2.py ->
pre-trained_efm_v3.py -> test_efm_v2.py -> draw_cos_dis_real.py):

  pack -> backbone train (SIGTERM mid-epoch -> --resume) -> extract ->
  slice -> head train @ B=16384 -> eval_cos -> draw_cos

Every arrow is the port's CLI in a fresh subprocess (so the preemption and
the resume are the actual user journey, not an in-process simulation).
Emits one JSON line per stage (wall-clock, key facts) and a final summary
with the per-epoch pos/neg separation curve from the head's
cosine_similarity.csv, plotted to --artifacts/thesis_separation.png. The
plots need matplotlib: without it ``draw_cos`` and the plot are skipped,
and the summary says so. The store is written with the port's
``ImageStoreWriter`` and ``synthetic_faces``; nothing here imports JAX.

GPU run (defaults; the CLIs run on cuda):
  python tools/thesis_rehearsal_torch.py --artifacts runs/thesis_torch
CPU smoke (orchestration only, tiny shapes; --cpu passes --device cpu;
32 px is LightCNN29's smallest input, five 2x pools to one pixel):
  python tools/thesis_rehearsal_torch.py --cpu --rows 400 --ids 20 \\
      --size 32 --backbone-batch 16 --backbone-epochs 3 --head-batch 256 \\
      --head-epochs 3 --extract-batch 64
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

PKG = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLIs that compute, and so take --device
_DEVICE_CLIS = ("train_backbone", "extract_features", "train_head",
                "eval_cos")


def _cli_cmd(module: str, argv: list[str], cpu: bool) -> list[str]:
    """Command line for one CLI stage; --cpu runs it on the CPU."""
    dev = ["--device", "cpu"] if cpu and module in _DEVICE_CLIS else []
    return [sys.executable, "-m", f"{PKG}.cli.{module}"] + argv + dev


def build_store(root: str, rows: int, ids: int, size: int) -> str:
    """An identity-clustered uint8 mmap store of ``rows`` images: a pool of
    identity patterns (``synthetic_faces``), tiled with per-chunk noise, so
    no more than one chunk is held in RAM (``ImageStoreWriter``)."""
    sys.path.insert(0, REPO)
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.data import (
        ImageStoreWriter,
        synthetic_faces,
    )

    pool_ids = min(ids, 512)
    base, base_labels = synthetic_faces(num_ids=pool_ids, per_id=1,
                                        size=size, seed=0)
    order = np.argsort(base_labels)
    base = (base[order, :, :, 0] * 255).astype(np.uint8)  # [pool, S, S]
    rng = np.random.default_rng(1)
    store = os.path.join(root, "store")
    chunk = 4096
    t0 = time.perf_counter()
    with ImageStoreWriter(store, (size, size, 1)) as w:
        written = 0
        while written < rows:
            n = min(chunk, rows - written)
            labs = rng.integers(0, ids, n)
            imgs = base[labs % pool_ids].astype(np.int16)
            imgs = np.clip(imgs + rng.integers(-12, 13, imgs.shape), 0,
                           255).astype(np.uint8)[..., None]
            w.append(imgs, labs)
            written += n
    dt = time.perf_counter() - t0
    print(json.dumps({"stage": "pack", "rows": rows,
                      "imgs_per_sec": round(rows / dt, 1)}), flush=True)
    return store


def run_stage(name: str, cmd: list[str], log_dir: str,
              timings: dict) -> str:
    """Run one chain stage to completion; returns captured output."""
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE,
                       stderr=subprocess.STDOUT, text=True)
    dt = time.perf_counter() - t0
    out = r.stdout
    with open(os.path.join(log_dir, f"{name}.log"), "w") as f:
        f.write(out)
    if r.returncode != 0:
        print(out[-4000:], flush=True)
        raise SystemExit(f"stage {name} failed rc={r.returncode}")
    timings[name] = round(dt, 1)
    print(json.dumps({"stage": name, "secs": round(dt, 1)}), flush=True)
    return out


def run_backbone_with_preemption(cmd: list[str], log_dir: str,
                                 timings: dict) -> dict:
    """Launch the backbone trainer, SIGTERM it after the first completed
    epoch (mid-epoch-1 - a real preemption), then relaunch with --resume
    and let it finish. Checks that the PreemptionGuard checkpoint fired and
    that the resumed process picks up at epoch >= 1."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines: list[str] = []
    sent = False
    try:
        for line in proc.stdout:
            lines.append(line)
            if not sent and "Epoch 0:" in line:
                # epoch 0 is complete and (checkpoint_every=1)
                # checkpointed; we are now inside epoch 1 -> a genuine
                # mid-epoch preemption
                proc.send_signal(signal.SIGTERM)
                sent = True
        proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    first = "".join(lines)
    with open(os.path.join(log_dir, "backbone_preempted.log"), "w") as f:
        f.write(first)
    if not sent:
        raise SystemExit("backbone never reported Epoch 0 - nothing to "
                         "preempt (see backbone_preempted.log)")
    if "preemption requested" not in first:
        raise SystemExit("SIGTERM did not reach the PreemptionGuard")
    t_pre = time.perf_counter() - t0

    out = run_stage("backbone_resumed", cmd + ["--resume"], log_dir, timings)
    if "resumed at epoch" not in out:
        raise SystemExit("--resume did not restore the preemption ckpt")
    resumed_at = int(out.split("resumed at epoch", 1)[1].split()[0])
    timings["backbone_preempted"] = round(t_pre, 1)
    epochs_logged = [ln for ln in (first + out).splitlines()
                     if "Epoch " in ln and ": train" in ln]
    info = {"stage": "backbone", "preempted_after_s": round(t_pre, 1),
            "resumed_at_epoch": resumed_at,
            "epoch_lines": len(epochs_logged)}
    print(json.dumps(info), flush=True)
    for ln in epochs_logged:
        print("  " + ln.strip().split("] ")[-1], flush=True)
    return info


def separation_curve(csv_path: str, epochs: int) -> list[dict]:
    """Per-epoch pos/neg stats from the head's similarity CSV: the sink
    appends one row per evaluated pair every epoch, so equal chunks are
    epoch slices."""
    rows = np.loadtxt(csv_path)
    per = len(rows) // epochs
    curve = []
    for e in range(epochs):
        chunk = rows[e * per:(e + 1) * per]
        pos, neg = chunk[:, 0], chunk[:, 1]
        # Mann-Whitney AUC: P(pos > neg) over the epoch's pairs
        order = np.argsort(np.concatenate([pos, neg]), kind="stable")
        ranks = np.empty(len(order))
        ranks[order] = np.arange(1, len(order) + 1)
        auc = (ranks[:len(pos)].sum() - len(pos) * (len(pos) + 1) / 2) / (
            len(pos) * len(neg))
        curve.append({"epoch": e, "pos_mean": round(float(pos.mean()), 4),
                      "neg_mean": round(float(neg.mean()), 4),
                      "separation": round(float(pos.mean() - neg.mean()), 4),
                      "auc": round(float(auc), 4)})
    return curve


def plot_curve(curve: list[dict], path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ep = [c["epoch"] for c in curve]
    fig, ax = plt.subplots(figsize=(7, 4))
    ax.plot(ep, [c["pos_mean"] for c in curve], "o-", label="pos mean cos")
    ax.plot(ep, [c["neg_mean"] for c in curve], "s-", label="neg mean cos")
    ax.plot(ep, [c["separation"] for c in curve], "^--",
            label="separation (pos-neg)")
    ax.set_xlabel("head epoch")
    ax.set_ylabel("cosine")
    ax.set_title("triplet-head pos/neg separation over epochs")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def _device_name(cpu: bool) -> str:
    if cpu:
        return "cpu"
    import torch

    return torch.cuda.get_device_name(0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rows", type=int, default=50_000)
    p.add_argument("--ids", type=int, default=1_000)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--model", default="lightcnn29")
    p.add_argument("--backbone-batch", type=int, default=64,
                   help="reference config (train_efm.py batch)")
    p.add_argument("--backbone-epochs", type=int, default=3)
    p.add_argument("--scan-chunk", type=int, default=8)
    p.add_argument("--extract-batch", type=int, default=256)
    p.add_argument("--head-batch", type=int, default=16_384,
                   help="reference head batch (pre-trained_efm_v3.py)")
    p.add_argument("--head-epochs", type=int, default=8)
    p.add_argument("--mining", default="random",
                   help="the backbone's and the head's --mining "
                        "(semi_hard_fused runs kernel B1 on the card)")
    p.add_argument("--out", help="working dir (default: temp)")
    p.add_argument("--artifacts", default="runs/thesis_torch")
    p.add_argument("--cpu", action="store_true",
                   help="CPU smoke mode (orchestration test)")
    args = p.parse_args(argv)

    root = args.out or tempfile.mkdtemp(prefix="fx_thesis_torch_")
    os.makedirs(root, exist_ok=True)
    art = os.path.join(REPO, args.artifacts)
    os.makedirs(art, exist_ok=True)
    timings: dict[str, float] = {}
    plots = importlib.util.find_spec("matplotlib") is not None

    # 1. pack: identity-clustered mmap store (streaming writer)
    t0 = time.perf_counter()
    store = build_store(root, args.rows, args.ids, args.size)
    timings["pack"] = round(time.perf_counter() - t0, 1)

    # 2. backbone train with a real SIGTERM preemption + resume
    bb = os.path.join(root, "backbone")
    bb_cmd = _cli_cmd("train_backbone", [
        "--images", store, "--model", args.model,
        "--epochs", str(args.backbone_epochs),
        "--batch-size", str(args.backbone_batch),
        "--scan-chunk", str(args.scan_chunk), "--mining", args.mining,
        "--checkpoint-every", "1", "--out-dir", bb], args.cpu)
    resume_info = run_backbone_with_preemption(bb_cmd, root, timings)

    # 3. feature extraction from the trained export
    feats = os.path.join(root, "features")
    run_stage("extract", _cli_cmd("extract_features", [
        "--train-images", store, "--model", args.model,
        "--num-classes", str(args.ids),
        "--export-dir", os.path.join(bb, "export"),
        "--batch-size", str(args.extract_batch),
        "--out-dir", feats], args.cpu), root, timings)

    # 4. identity slicing (0.7/0.3)
    sliced = os.path.join(root, "sliced")
    run_stage("slice", _cli_cmd("slice_dataset", [
        "--features", os.path.join(feats, "train.npz"),
        "--out-dir", sliced], args.cpu), root, timings)

    # 5. triplet head at the reference's B=16384
    head = os.path.join(root, "head")
    run_stage("head", _cli_cmd("train_head", [
        "--features", os.path.join(sliced, "train.npz"),
        "--batch-size", str(args.head_batch),
        "--epochs", str(args.head_epochs), "--mining", args.mining,
        "--out-dir", head], args.cpu), root, timings)

    # 6. no-training cosine eval on held-out identities + 7. the plot
    ec = os.path.join(root, "eval")
    run_stage("eval_cos", _cli_cmd("eval_cos", [
        "--features", os.path.join(sliced, "test.npz"),
        "--out-dir", ec], args.cpu), root, timings)
    if plots:
        run_stage("draw_cos", _cli_cmd("draw_cos", [
            "--csv", os.path.join(ec, "cosine_similarity.csv"),
            "--out", os.path.join(art, "thesis_cdf.jpg")], args.cpu),
            root, timings)
    else:
        print(json.dumps({"stage": "draw_cos",
                          "skipped": "matplotlib is not installed"}),
              flush=True)

    curve = separation_curve(os.path.join(head, "cosine_similarity.csv"),
                             args.head_epochs)
    if plots:
        plot_curve(curve, os.path.join(art, "thesis_separation.png"))
    summary = {
        "stage": "summary", "rows": args.rows, "ids": args.ids,
        "model": args.model, "platform": "cpu" if args.cpu else "gpu",
        "device": _device_name(args.cpu), "plots": plots,
        "timings_s": timings, "resume": resume_info,
        "separation_curve": curve,
        "separation_improved": curve[-1]["separation"] > curve[0]["separation"],
    }
    with open(os.path.join(art, "thesis_rehearsal.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
