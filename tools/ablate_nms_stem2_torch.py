#!/usr/bin/env python3
"""Where kernels B5 (``csrc/nms.cu``) and B4 (``csrc/stem.cu``'s
``stem2_kernel``) spend their time, on one GPU: variants of each source
with one part removed or changed, each built with the port's nvcc flags
into a temporary directory and swapped into the port's wrapper, timed in
one process in the order base, variants..., base.

B5 is timed at the serving path's four calls (``chip_smoke.NMS_PATH``,
kernel device time from a profiler trace), B4 at B=128, 112x96 (f32 and
bf16, CUDA events over back-to-back calls). Variants:

  nms:sort_only      the kernel returns after its sort
  nms:no_build       the suppression bitmask is not built
  nms:no_sweep       the one-warp sweep is skipped
  nms:threads_128    128 threads a CTA (the base takes 1,024)
  nms:cluster_1      one CTA a set on every call
  nms:cluster_2 / cluster_8
                     2 or 8 CTAs a set where the wrapper picks 4 (the
                     cross-scale call)
  stem2:no_stage1    the 5x5 conv stage skipped
  stem2:no_stage2    the 1x1 conv stage skipped
  stem2:min_blocks_3 / min_blocks_5
                     __launch_bounds__ asks for 3 or 5 CTAs an SM
  stem2:runtime_widths
                     LightCNN9's widths read at run time, not compiled in

Only
``base`` (and variants that change no arithmetic, marked by their
mismatches, 0) gives the kernel's answers. Prints one JSON line per run
and last the card's name and power limit.

    python tools/ablate_nms_stem2_torch.py [nms:variant | stem2:variant ...]
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# nms_keep_mask's first line, after which a variant overrides the cluster
_EMPTY = "  if (sets <= 0 || n <= 0) return 0;\n"

VARIANTS = {
    "nms": {
        "base": [],
        "sort_only": [("  // 2. sorted boxes and areas, valid words\n",
                       "  return;\n")],
        "no_build": [("  for (int i = rank + csize * warp; i < n;",
                      "  for (int i = n; i < n;")],
        "no_sweep": [("  if (warp == 0) {\n    u64 rem[SLOTS];",
                      "  if (warp < 0) {\n    u64 rem[SLOTS];")],
        "threads_128": [("  cfg.blockDim = dim3(THREADS);",
                         "  cfg.blockDim = dim3(128);")],
        "cluster_1": [(_EMPTY, _EMPTY + "  cluster = 1;\n")],
        "cluster_2": [(_EMPTY, _EMPTY + "  if (cluster == 4) cluster = 2;\n")],
        "cluster_8": [(_EMPTY, _EMPTY + "  if (cluster == 4) cluster = 8;\n"),
                      ("MAX_CLUSTER = 4;", "MAX_CLUSTER = 8;")],
    },
    "stem": {
        "base": [],
        "no_stage1": [("item < (TY * TX / 2) * G;", "item < 0;")],
        "no_stage2": [("item < (TY * TX / 4) * NJ;", "item < 0;")],
        "min_blocks_3": [("__launch_bounds__(S2_THREADS)\nstem2_kernel",
                          "__launch_bounds__(S2_THREADS, 3)\nstem2_kernel")],
        "min_blocks_5": [("__launch_bounds__(S2_THREADS)\nstem2_kernel",
                          "__launch_bounds__(S2_THREADS, 5)\nstem2_kernel")],
        # gridDim.y is 1: the widths stay 96, unknown to the compiler
        "runtime_widths": [("const int C = S2_C, C2 = S2_C2;",
                            "const int C = S2_C * (int)gridDim.y, "
                            "C2 = S2_C2 * (int)gridDim.y;")],
    },
}


def build(kernel: str, names, tmp) -> dict:
    """``{variant: (library path, ptxas lines)}``, all nvcc jobs at once."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        _build,
    )

    with open(os.path.join(_build.CSRC, f"{kernel}.cu")) as f:
        src = f.read()
    jobs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[kernel][name]:
            if old not in text:
                raise RuntimeError(f"{kernel}:{name}: patch does not apply")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{kernel}_{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"lib{kernel}_{name}.so")
        cmd = [_build._nvcc(), *_build._COMMON, *_build.FLAGS[kernel], "-o",
               so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT))
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kernel}:{name}:\n{log}")
        out[name] = (so, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out


def use(kernel: str, so: str) -> None:
    """Swap the library behind the port's wrappers."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        _build,
        nms,
        stem,
    )

    _build._libs[kernel] = ctypes.CDLL(so)
    nms._lib.cache_clear()
    stem._fns.cache_clear()


def run_nms(torch, names, tmp) -> None:
    from chip_smoke import NMS_PATH, _soups, nms_device_ms

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        nms,
    )

    gen = torch.Generator().manual_seed(1)
    cases = {name: (_soups(torch, gen, s, n), th, m)
             for name, (s, n, th, m) in NMS_PATH.items()}
    want = {k: nms.nms_mask_plain(*v) for k, v in cases.items()}
    libs = build("nms", names, tmp)
    for name in [*names, "base"]:
        so, ptxas = libs[name]
        use("nms", so)
        calls, mism = {}, 0
        for call, (b, th, m) in cases.items():
            mism += int((nms.nms_mask_batched(b, th, m) != want[call]).sum())
            calls[call] = nms_device_ms(
                torch, lambda: nms.nms_mask_batched(b, th, m), 50)[0]
        rec = {"kernel": "nms", "variant": name, "device_ms": calls,
               "device_ms_total": sum(calls.values()), "mismatches": mism,
               "ptxas": ptxas}
        print(json.dumps(rec), flush=True)


def run_stem2(torch, names, tmp) -> None:
    from chip_smoke import EXTRACT_BATCH, front9_params, time_ms

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        stem,
    )

    gen = torch.Generator().manual_seed(7)
    p = front9_params(torch, gen)
    args = (p["conv1"]["kernel"], p["conv1"]["bias"], p["conv2a"]["kernel"],
            p["conv2a"]["bias"])
    x = torch.rand(EXTRACT_BATCH, 112, 96, 1, generator=gen).cuda()
    want = {dt: stem.stem2_conv_plain(x.to(dt), *args)
            for dt in (torch.float32, torch.bfloat16)}
    libs = build("stem", names, tmp)
    for name in [*names, "base"]:
        so, ptxas = libs[name]
        use("stem", so)
        rec = {"kernel": "stem2", "variant": name, "ptxas": ptxas[-4:]}
        for dt, key in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            xd = x.to(dt)
            rec[f"{key}_max_abs_err"] = float(
                (stem.stem2_conv(xd, *args).float()
                 - want[dt].float()).abs().max())
            rec[f"{key}_ms"] = time_ms(
                torch, lambda: stem.stem2_conv(xd, *args), 50)
        print(json.dumps(rec), flush=True)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_nms_stem2_torch: needs CUDA", file=sys.stderr)
        return 2
    from chip_smoke import full_f32

    full_f32()    # the plain B4 runs cuDNN
    chosen = {"nms": [], "stem": []}
    for a in argv:
        kernel, name = a.split(":")
        chosen["stem" if kernel == "stem2" else kernel].append(name)
    for k in chosen:
        if not argv:
            chosen[k] = list(VARIANTS[k])
        chosen[k] = ["base", *[n for n in chosen[k] if n != "base"]]
    with tempfile.TemporaryDirectory() as tmp:
        run_nms(torch, chosen["nms"], tmp)
        run_stem2(torch, chosen["stem"], tmp)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
