"""One run of one cell: set-up, the measured window, the traced stretch,
the check against the reference, and the result line.

The cell's files are found by name: ``BENCHMARK.json``'s workload entry
names its configuration (``configs/<config>.json``); ``workloads/<cell>.json``
holds the cell's traffic parameters and the ``kind`` of its driver
(``traffic/<kind>.py``); each per-layer metric is read by
``metrics/<metric>.py``. Adding a cell, a configuration or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import time
from types import SimpleNamespace

from .driver import power_limit_w

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
# top-level module names no run may load (the JAX package is compared whole:
# the program's package name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax",
             "improving_face_recognition_performance_using_triplet_loss_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_files(name: str, bench: dict) -> tuple[dict, dict, dict]:
    """``(workload entry, traffic parameters, configuration)`` of cell
    ``name``."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    with open(os.path.join(ROOT, cfg_entry["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(HERE, "workloads", f"{name}.json")) as f:
        traffic = json.load(f)
    return entry, traffic, cfg


def driver(kind: str):
    return load_module(os.path.join(HERE, "traffic", f"{kind}.py"),
                       f"perfbench_traffic_{kind}").Driver


def metric_reader(name: str):
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       "perfbench_metric_" + name.replace(".", "_")).read


def loaded_forbidden(modules) -> list[str]:
    """Forbidden top-level names among loaded module names, compared whole."""
    tops = {m.split(".", 1)[0] for m in modules}
    return sorted(tops & set(FORBIDDEN))


def window(drv, seconds: float) -> dict:
    """Steps back to back until ``seconds`` have passed; each step ends with
    its results on the host."""
    n = 0
    t0 = time.perf_counter()
    while True:
        drv.step()
        n += 1
        dt = time.perf_counter() - t0
        if dt >= seconds:
            return {"steps": n, "seconds": dt}


def run_cell(name: str, traffic: dict, cfg: dict, *, seed: int,
             seconds: float, trace: bool, device: str, t_start: float,
             bench: dict, fault: str | None = None) -> dict:
    """One run; returns the result line's object (without printing)."""
    import torch

    drv = driver(traffic["kind"])(cfg, traffic, seed, device, fault=fault)
    drv.setup()
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    win = window(drv, seconds)
    stats = drv.window_stats(win)
    traced = None
    launches = {}
    if trace:
        from .trace import profile_stretch
        before = drv.launch_counts()
        traced = profile_stretch(torch, drv.step, traffic["trace_steps"])
        after = drv.launch_counts()
        launches = {k: after[k] - before.get(k, 0) for k in after}
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    drv.close()
    checks = drv.check()
    correct = all(math.isfinite(v) and v <= lim for v, lim in
                  ((c["value"], c["limit"]) for c in checks.values()))
    if trace:
        run = SimpleNamespace(window=win, trace=traced, launches=launches,
                              driver=drv)
        metrics = {}
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            value = metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**stats, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if name in m.get("workloads", [name])}
    out = {"correct": correct, "attempted": drv.attempted,
           "failed": drv.failed, "metrics": metrics,
           "device": drv.device_info(peak)}
    if trace:
        out["device"]["busy_s"] = traced.busy_s()
        out["device"]["window_s"] = traced.wall_s
        out["breakdown"] = {"device_ops": traced.top_ops(),
                            "idle_gaps": traced.idle_gaps()}
        # beside mfu: the card's power limit bounds the rate it can reach
        out["card"] = {"power_limit_w": power_limit_w()}
    out["checks"] = checks
    return out
