"""Bytes, operations and least times of the program's hand-written
kernels, from the call shapes a configuration gives them.

The peaks are NVIDIA's data sheet for the H100 SXM: HBM3 at 3.35 TB/s,
67 TFLOP/s in float32 outside the tensor cores, 495 in TF32 on the tensor
cores (dense). A call's least time is the larger of its bytes over the
memory rate and its operations over the rate of the precision it uses;
each input byte is counted read once and each output byte written once.
B5's operations depend on the boxes (greedy NMS evaluates only the pairs
still alive), so only its bytes are counted: a lower bound.

Kernel names are the CUDA functions of ``csrc/*.cu``; a traced kernel
belongs to a kernel of this table when its name contains the pattern.
"""

from __future__ import annotations

import math

from .models import EFM342_LADDER, LCNN29_LADDER, pyramid

MEM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_TC_OPS_PER_S = 495e12

# kernel -> the pattern of its traced name
KERNELS = {"nms": "nms_bitmask_kernel", "stem": "stem_kernel",
           "efm3": "efm3_kernel", "efm3_bwd": "efm3_bwd_kernel",
           "mining": "mining_"}


def least_s(nbytes: float, ops: float = 0.0,
            ops_per_s: float = F32_OPS_PER_S) -> float:
    return max(nbytes / MEM_BYTES_PER_S, ops / ops_per_s)


def efm3(rows: int, c: int) -> float:
    out = rows * 2 * (c // 3)
    return least_s((rows * c + out) * 4, out * 2)


def efm3_bwd(rows: int, c: int) -> float:
    # x and the output gradient read once, the input gradient written once
    return least_s((2 * rows * c + rows * 2 * (c // 3)) * 4, rows * c * 4)


def stem(b: int, h: int, w: int, c: int) -> float:
    """B3 in float32 with EFM3: 5x5 conv, maxout, 2x2 pool."""
    n_io = b * h * w + b * (h // 2) * (w // 2) * 2 * (c // 3)
    ops = 2 * 25 * c * b * h * w + 2 * b * h * w * c
    return least_s(n_io * 4 + 26 * c * 4, ops)


def nms(sets: int, rows: int) -> float:
    return least_s(sets * rows * 5 * 4 + sets * rows)


def mining(b: int, n: int, d: int) -> float:
    """B1: three TF32 products on the tensor cores, the epilogue and the
    norms in float32."""
    nbytes = (b * d + n * d) * 4 + b * 4 + (b + n) * 4 + b * 4
    return max(least_s(nbytes, 3 * 2 * b * n * d, TF32_TC_OPS_PER_S),
               (8 * b * n + 2 * (b + n) * d) / F32_OPS_PER_S)


def efmnet342_efm3(b: int, size: int, fc1: int = 513) -> dict:
    """(rows, channels) -> calls of B2 in one EFMNet342 forward (the stem's
    EFM3 is inside B3)."""
    calls: dict = {}

    def add(rows, c, n=1):
        calls[(rows, c)] = calls.get((rows, c), 0) + n
    hw, cin = size // 2, 66
    for num_r, num, tar in EFM342_LADDER:
        rows = b * hw * hw
        add(rows, cin, tar)
        add(rows, num_r, tar)
        add(rows, num_r)
        add(rows, num)
        hw, cin = hw // 2, num * 2 // 3
    add(b, fc1)
    return calls


def lightcnn29_efm3(b: int, hw, fc1: int = 1026, stem_fused: bool = True):
    """(rows, channels) -> calls of B2 in one LightCNN-29 forward; the
    training forward runs the stem unfused, its EFM3 on B2 too."""
    calls: dict = {}

    def add(rows, c, n=1):
        calls[(rows, c)] = calls.get((rows, c), 0) + n
    h, w = hw
    if not stem_fused:
        add(b * h * w, 99)
    h, w = h // 2, w // 2
    for nres, rf, pf, cf in LCNN29_LADDER:
        rows = b * h * w
        add(rows, rf * 2 // 3, nres)
        add(rows, rf, nres)
        add(rows, pf)
        add(rows, cf)
        h, w = h // 2, w // 2
    add(b, fc1)
    return calls


def serve_calls(cfg: dict, streams: int) -> dict:
    """kernel -> [(least seconds, calls)] of one serving dispatch."""
    c, (h, w) = cfg["cascade"], cfg["frame_hw"]
    scales = len(pyramid(h, w, c["minsize"], c["factor"]))
    k = c["k_per_scale"]
    e = cfg["embed"]
    s = e["image_size"]
    return {
        "nms": [(nms(streams * scales, k), 1),
                (nms(streams, scales * k), 1),
                (nms(streams, c["stage2_cap"]), 1),
                (nms(streams, c["out_cap"]), 1)],
        "stem": [(stem(streams, s, s, e["stem_filters"]), 1)],
        "efm3": [(efm3(r, ch), n) for (r, ch), n in
                 efmnet342_efm3(streams, s, e["fc1"]).items()]}


def extract_calls(cfg: dict, batch: int) -> dict:
    """kernel -> [(least seconds, calls)] of one extraction batch."""
    hw = tuple(cfg["input_hw"])
    return {"stem": [(stem(batch, hw[0], hw[1], cfg["stem_filters"]), 1)],
            "efm3": [(efm3(r, ch), n) for (r, ch), n in
                     lightcnn29_efm3(batch, hw, cfg["fc1"]).items()]}


def train_calls(cfg: dict, pairs: int) -> dict:
    """kernel -> [(least seconds, calls)] of one training step."""
    hw, b = tuple(cfg["input_hw"]), 2 * pairs
    shapes = lightcnn29_efm3(b, hw, cfg["fc1"], stem_fused=False)
    d = cfg["fc1"] * 2 // 3
    return {"efm3": [(efm3(r, ch), n) for (r, ch), n in shapes.items()],
            "efm3_bwd": [(efm3_bwd(r, ch), n) for (r, ch), n in
                         shapes.items()],
            "mining": [(mining(pairs, b, d), 1)]}


def launches(calls: dict) -> dict:
    """kernel -> launches a step."""
    return {k: sum(n for _, n in v) for k, v in calls.items()}


def least_total_s(calls: dict) -> float:
    return math.fsum(t * n for v in calls.values() for t, n in v)
