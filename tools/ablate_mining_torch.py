#!/usr/bin/env python3
"""Where kernel B1's time goes, on one GPU: variants of ``csrc/mining.cu``
with one part removed or changed, each built with the port's nvcc flags
into a temporary directory and timed at the head path's shape (chip_smoke's
``head_path_inputs``: B = 16384, N = 32768, D = 128) in one process, in the
order base, variants..., base.

Variants (text patches of the source; each patch must apply):
  one_pass     hi.hi only (a third of the tensor-core work)
  no_mma       no wgmma at all (the TMA ring and the epilogue alone)
  no_epilogue  the epilogue skipped (the ring and the wgmma alone)
  streamed_a   the anchors stream through the ring with the pool (twice the
               L2 traffic) instead of staying resident
  stages2      a ring of 2 stages instead of 3
  rotate       each CTA starts its walk at another pool tile, so the CTAs
               do not read the same tile at the same time

Only ``base`` gives the kernel's answers; the others time a broken kernel.
Prints one JSON line per run and last the card's name and power limit.

    python tools/ablate_mining_torch.py [variant ...]
"""

import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_PASSES = ("        wgmma_tf32(acc, a_hi, p_lo);\n"
           "        wgmma_tf32(acc, a_lo, p_hi);\n"
           "        wgmma_tf32(acc, a_hi, p_hi);\n")


def _rotated(indent: str):
    """The tile walk of the producer (indent 4) or the consumers (indent 2),
    started at another tile in each CTA."""
    return (f"{indent}for (int t = t_begin; t < t_end; ++t) {{\n",
            f"{indent}for (int tt = t_begin; tt < t_end; ++tt) {{\n"
            f"{indent}  const int t = t_begin + (tt - t_begin + "
            "(int)blockIdx.x) % (t_end - t_begin);\n")

VARIANTS = {
    "base": [],
    "one_pass": [(_PASSES, "        wgmma_tf32(acc, a_hi, p_hi);\n")],
    "no_mma": [(_PASSES, "")],
    "no_epilogue": [("    const int j0 = t * TN;\n",
                     "    const int j0 = t * TN;\n    if (t >= 0) continue;\n")],
    "streamed_a": [("  e = Dp <= KA_RES * KC\n", "  e = false\n")],
    "stages2": [("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "rotate": [_rotated("    "), _rotated("  ")],
}


def build(names, tmp):
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        _build,
    )

    with open(os.path.join(_build.CSRC, "mining.cu")) as f:
        src = f.read()
    jobs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: patch does not apply")
            text = text.replace(old, new)
        cu = os.path.join(tmp, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"lib{name}.so")
        cmd = [_build._nvcc(), *_build._COMMON, *_build.FLAGS["mining"],
               "-o", so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in jobs.items():
        out = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{out}")
        lib = ctypes.CDLL(so)
        lib.mining_splits.argtypes = [ctypes.c_int] * 2
        lib.mining_splits.restype = ctypes.c_int
        lib.mining_scratch_words.argtypes = [ctypes.c_int] * 4
        lib.mining_scratch_words.restype = ctypes.c_longlong
        lib.semi_hard_mining.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        lib.semi_hard_mining.restype = ctypes.c_int
        libs[name] = (lib, [ln.strip() for ln in out.splitlines()
                            if "registers" in ln or "spill" in ln][:4])
    return libs


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_mining_torch: needs CUDA", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from chip_smoke import head_path_inputs, time_ms

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        mining,
    )

    names = argv or list(VARIANTS)
    if "base" not in names:
        names = ["base", *names]
    anc, pos_sq, al, pool, pl = head_path_inputs(torch)
    b, d = anc.shape
    n = pool.shape[0]
    want = mining.semi_hard_mining_plain(anc, pos_sq, al, pool, pl)
    stream = torch.cuda.current_stream().cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, tmp)
        for name in [*names, "base"]:
            lib, ptxas = libs[name]
            splits = lib.mining_splits(b, n)
            scratch = torch.empty(lib.mining_scratch_words(b, n, d, splits),
                                  dtype=torch.float32, device="cuda")
            out = torch.empty(b, dtype=torch.int32, device="cuda")

            def call():
                rc = lib.semi_hard_mining(
                    anc.data_ptr(), pool.data_ptr(), pos_sq.data_ptr(),
                    al.data_ptr(), pl.data_ptr(), b, n, d, splits,
                    scratch.data_ptr(), out.data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"{name}: cudaError {rc}")

            ms = time_ms(torch, call, 20)
            print(json.dumps({"variant": name, "ms": ms,
                              "index_differences": int((out != want).sum()),
                              "ptxas": ptxas}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
