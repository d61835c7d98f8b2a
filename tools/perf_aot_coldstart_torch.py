"""Cold start and throughput of the port's serving artifacts on one GPU.

The twin of ``tools/perf_aot_coldstart.py``. Exports the serving cell (16
streams of 240x320, MTCNN and EFMNet342 at their published widths with
random seeded weights, 64x64 crops, thresholds 0.3, a dynamic gallery of
1,000 f32 rows whose ``rows`` is a runtime scalar) with ``export_aot``,
then ``serve.aot.export_compiled`` (AOTInductor) and
``prime_cache_bundle``, and runs each route in its OWN fresh subprocess
whose import of the port's ``models`` and ``detect`` (and of ``jax``) is
refused:

  exported — the ExportedProgram (``load_pipeline``);
  compiled — the AOTInductor package (``load_compiled``);
  bundle   — the package from a copy of the port whose ``csrc/_build/`` is
             empty, with ``<artifact>.xcache/`` installed at load;
  nobundle — the same copy without the bundle: the first dispatch builds
             the kernel libraries with nvcc.

Each child reports the seconds from its spawn to the first identified
frame (frames uploaded, every output read back), the load seconds, the
launches of B5 / B3 / B2 a dispatch, whether every kernel call of one
dispatch equals its plain version, frames/s over three windows, and one
traced window's device ms and kernel launches a dispatch (the idle share
beside the windows' wall), and writes its first dispatch's outputs.

    python tools/perf_aot_coldstart_torch.py [--routes exported compiled
        bundle nobundle] [--work DIR]

Prints one JSON line per route, the card's name and power limit.
``chip_smoke.py aot`` runs the same functions.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "improving_face_recognition_performance_using_triplet_loss_tpu_torch"

STREAMS, FRAME_HW, IMAGE, GALLERY_ROWS, DIM = 16, (240, 320), 64, 1000, 342
THRESHOLDS = ("0.3", "0.3", "0.3")
DISPATCHES = 8          # counted, and their outputs kept
WINDOWS, WINDOW_DISPATCHES, TRACED = 3, 24, 4
ROUTES = ("exported", "compiled", "bundle", "nobundle")
# the modules a loading process must not import
REFUSED = (f"{PKG}.models", f"{PKG}.detect", "jax", "flax")


def export_serving(work: str, device: str = "cuda") -> dict:
    """The serving cell's artifacts under ``work``: a random seeded
    EFMNet342 export, ``export_aot``'s ``.pt2`` (timed), its AOTInductor
    package (timed) and the package's kernel bundle (timed). Returns the
    paths and seconds."""
    import torch

    sys.path.insert(0, ROOT)
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.cli import (
        export_aot,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.models import (
        model_by_name,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        aot,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve.convert import (
        export_model,
    )

    p = lambda name: os.path.join(work, name)  # noqa: E731
    model = model_by_name("efmnet342", 1000, input_hw=(IMAGE, IMAGE),
                          generator=torch.Generator().manual_seed(0),
                          device="cpu")
    export_model(p("export"), model)
    secs = {}
    t0 = time.perf_counter()
    export_aot.main(["--export-dir", p("export"), "--dynamic-gallery-rows",
                     str(GALLERY_ROWS), "--frame-size", *map(str, FRAME_HW),
                     "--streams", str(STREAMS), "--embed-size", str(IMAGE),
                     "--thresholds", *THRESHOLDS, "--precision", "f32",
                     "--out", p("serve.pt2"), "--device", device])
    secs["export"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    meta = aot.read_meta(p("serve.pt2"))
    aot.export_compiled(p("serve_aoti.pt2"), None, *FRAME_HW,
                        streams=STREAMS,
                        gallery_shape=(GALLERY_ROWS, DIM),
                        device=device,
                        program=torch.export.load(p("serve.pt2")))
    secs["compile"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    aot.prime_cache_bundle(p("serve_aoti.pt2"))
    secs["bundle"] = time.perf_counter() - t0
    return {"export_dir": p("export"), "exported": p("serve.pt2"),
            "compiled": p("serve_aoti.pt2"), "seconds": secs,
            "meta": meta,
            "bytes": {k: os.path.getsize(p(n)) for k, n in
                      (("exported", "serve.pt2"),
                       ("compiled", "serve_aoti.pt2"))},
            "bundle_files": sorted(os.listdir(p("serve_aoti.pt2.xcache")))}


def serving_inputs(path: str, seed: int = 0) -> str:
    """Seeded frames ``[DISPATCHES, STREAMS, H, W, 3]`` (0-255) and an
    L2-normalized ``[GALLERY_ROWS, DIM]`` f32 gallery, as an npz."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = (rng.random((DISPATCHES, STREAMS, *FRAME_HW, 3)) * 255).astype(
        np.float32)
    g = rng.standard_normal((GALLERY_ROWS, DIM)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    np.savez(path, frames=frames, gallery=g)
    return path


def measure(torch, fn, frames, gallery, rows) -> dict:
    """frames/s of ``fn`` over WINDOWS windows of WINDOW_DISPATCHES
    dispatches (frames on the card, outputs left there), then one traced
    window of TRACED dispatches: device ms and kernel launches a
    dispatch, and the idle share against the windows' wall."""
    from torch.profiler import ProfilerActivity, profile

    n = frames.shape[0]
    for i in range(2):
        fn(frames[i % n], gallery, rows)
    torch.cuda.synchronize()
    windows = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        for i in range(WINDOW_DISPATCHES):
            fn(frames[i % n], gallery, rows)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        windows.append(STREAMS * WINDOW_DISPATCHES / dt)
    wall_ms = STREAMS / (sum(windows) / len(windows)) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(TRACED):
            fn(frames[i % n], gallery, rows)
        torch.cuda.synchronize()
    device_us, kernels = 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            device_us += ev.time_range.elapsed_us()
            kernels += 1
    device_ms = device_us / 1e3 / TRACED
    return {"frames_per_s": windows, "wall_ms_per_dispatch": wall_ms,
            "device_ms_per_dispatch": device_ms,
            "cuda_kernels_per_dispatch": kernels / TRACED,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms)}


class KernelCalls:
    """Within ``with``: every launch of B5, B3 and B2 (the wrappers'
    ``_launch``, which the ``facejax`` ops' bodies call) is kept, input and
    output, to be held to its plain version (:meth:`hold`)."""

    def __enter__(self):
        from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
            efm3,
            nms,
            stem,
        )

        self.mods = {"nms": nms, "stem": stem, "efm3": efm3}
        self.saved = {k: m._launch for k, m in self.mods.items()}
        self.calls = []
        for kind, mod in self.mods.items():
            def rec(*args, _kind=kind, _real=self.saved[kind]):
                out = _real(*args)
                self.calls.append((_kind, tuple(
                    a.clone() if hasattr(a, "clone") else a for a in args),
                    out.clone()))
                return out
            mod._launch = rec
        return self

    def __exit__(self, *exc):
        for kind, mod in self.mods.items():
            mod._launch = self.saved[kind]
        return False

    def hold(self) -> dict:
        """Each kept call against its plain version on the same input:
        B5 and B2 equal, B3 within 1e-5 (f32 sums in another order)."""
        stem, nms, efm3 = (self.mods[k] for k in ("stem", "nms", "efm3"))
        counts = {"nms": 0, "stem": 0, "efm3": 0}
        equal, stem_err = True, 0.0
        for kind, args, got in self.calls:
            counts[kind] += 1
            if kind == "nms":
                boxes, th, method = args
                equal &= bool((nms.nms_mask_plain(boxes, th, method)
                               == got).all())
            elif kind == "efm3":
                equal &= bool((efm3.efm3_rows_plain(args[0]) == got).all())
            else:
                x, w, b, maxout = args
                want = stem.stem_conv_maxout_pool_plain(x, w, b,
                                                        maxout=maxout)
                stem_err = max(stem_err, float((want - got).abs().max()))
        return {"calls": counts, "b5_b2_equal": equal,
                "b3_max_abs_err": stem_err,
                "ok": equal and stem_err <= 1e-5}


def refuse_model_imports(root: str) -> None:
    """Make this process refuse REFUSED and import the port from
    ``root``."""
    import importlib.abc

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if any(name == r or name.startswith(r + ".") for r in REFUSED):
                raise ImportError(f"{name} is refused in a loading process")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, root)


def _imported_models() -> list:
    return sorted(m for m in sys.modules
                  if m.startswith((f"{PKG}.models", f"{PKG}.detect")))


def extract_child(spec: str, root: str) -> dict:
    """Each ``export_extract`` artifact of the JSON list ``spec`` ({artifact,
    state, images, out, calls}) in this (fresh) process: loaded, fed the
    state dict saved at ``state`` and the images, B4 / B6 launches a call
    counted, the first call's outputs written to ``out``."""
    refuse_model_imports(root)
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        front9,
        stem,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        aot,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counters = {"front9": front9.launches, "front9_bf16": front9.tc_launches,
                "stem2": stem.stem2_launches}
    results = []
    with open(spec) as f:
        jobs = json.load(f)
    for job in jobs:
        t0 = time.perf_counter()
        fn = aot.load_extract(job["artifact"])
        load_s = time.perf_counter() - t0
        variables = torch.load(job["state"], map_location="cuda")
        images = torch.from_numpy(np.load(job["images"])).cuda()
        logits, feat = fn(variables, images)
        torch.cuda.synchronize()
        np.savez(job["out"], logits=logits.cpu().numpy(),
                 features=feat.cpu().numpy())
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        for _ in range(job["calls"]):
            fn(variables, images)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        results.append({
            "artifact": os.path.basename(job["artifact"]), "load_s": load_s,
            "launches_per_call": {k: c.count / job["calls"]
                                  for k, c in counters.items()},
            "embeddings_per_s": images.shape[0] * job["calls"] / secs})
    return {"extract": results, "models_or_detect_imported":
            _imported_models()}


def child(route: str, artifact: str, inputs: str, out: str, root: str,
          t_spawn: float) -> dict:
    """One route in this (fresh) process; see the module docstring."""
    refuse_model_imports(root)
    import numpy as np
    import torch

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        efm3,
        nms,
        stem,
    )
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.serve import (
        aot,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    load = aot.load_pipeline if route == "exported" else aot.load_compiled
    fn = load(artifact, use_cache_bundle=route != "nobundle")
    load_s = time.perf_counter() - t0
    data = np.load(inputs)
    frames = torch.from_numpy(data["frames"]).cuda()
    gallery = torch.from_numpy(data["gallery"]).cuda()
    rows = torch.tensor(GALLERY_ROWS, dtype=torch.int32, device="cuda")
    t0 = time.perf_counter()
    first = {k: v.cpu() for k, v in fn(frames[0], gallery, rows).items()}
    first_s = time.perf_counter() - t0
    cold = time.time() - t_spawn
    counters = {"nms": nms.launches, "stem": stem.launches,
                "efm3": efm3.launches}
    for c in counters.values():
        c.reset()
    outs = [first]
    for i in range(1, DISPATCHES):
        outs.append({k: v.cpu() for k, v in
                     fn(frames[i], gallery, rows).items()})
    torch.cuda.synchronize()
    launches = {k: c.count / (DISPATCHES - 1) for k, c in counters.items()}
    with KernelCalls() as calls:
        fn(frames[0], gallery, rows)
        torch.cuda.synchronize()
    held = calls.hold()
    masks = [got for kind, _, got in calls.calls if kind == "nms"]
    np.savez(out, **{f"{k}_{i}": v.numpy() for i, o in enumerate(outs)
                     for k, v in o.items()},
             **{f"nms_mask_{j}": m.cpu().numpy() for j, m in enumerate(masks)})
    return {"route": route, "cold_start_s": cold, "load_s": load_s,
            "first_dispatch_s": first_s, "launches_per_dispatch": launches,
            "kernel_calls_vs_plain": held,
            "models_or_detect_imported": _imported_models(),
            **measure(torch, fn, frames, gallery, rows)}


def run_child(argv: list, timeout: int = 900, cwd=None) -> dict:
    """This file in a fresh subprocess with ``argv``; its result line."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), *argv],
                       capture_output=True, text=True, timeout=timeout,
                       cwd=cwd)
    line = next((ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")), None)
    if r.returncode != 0 or line is None:
        raise RuntimeError(f"{argv[:2]} failed rc={r.returncode}:\n"
                           f"{r.stderr[-3000:]}")
    return json.loads(line[len("RESULT "):])


def package_copy(tmp: str) -> str:
    """A copy of the port under ``tmp`` whose ``csrc/_build/`` is empty;
    returns the directory to put on ``sys.path``."""
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(tmp, PKG),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return tmp


def run_route(route: str, artifacts: dict, inputs: str, work: str,
              timeout: int = 900) -> dict:
    """``route`` in a fresh subprocess; its result line, with ``out`` the
    npz of its dispatches' outputs."""
    artifact = artifacts["exported" if route == "exported" else "compiled"]
    out = os.path.join(work, f"{route}_out.npz")
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        root = ROOT
        if route in ("bundle", "nobundle"):
            root = package_copy(tmp)
            if route == "nobundle":   # the same package, without its bundle
                shutil.copy2(artifact, os.path.join(tmp, "serve_aoti.pt2"))
                shutil.copy2(artifact + ".json",
                             os.path.join(tmp, "serve_aoti.pt2.json"))
                artifact = os.path.join(tmp, "serve_aoti.pt2")
        res = run_child(["--child", route, artifact, inputs, out, root,
                         repr(time.time())], timeout, cwd=tmp)
    return {**res, "out": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", nargs="+", default=list(ROUTES),
                    choices=ROUTES)
    ap.add_argument("--work", help="keep the artifacts here (default: a "
                                   "temporary directory)")
    ap.add_argument("--child", nargs=6, help=argparse.SUPPRESS)
    ap.add_argument("--extract-child", nargs=2, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child or args.extract_child:
        if args.child:
            route, artifact, inputs, out, root, t_spawn = args.child
            res = child(route, artifact, inputs, out, root, float(t_spawn))
        else:
            res = extract_child(*args.extract_child)
        print("RESULT " + json.dumps(res), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("perf_aot_coldstart_torch: needs CUDA", file=sys.stderr)
        return 2
    work = args.work or tempfile.mkdtemp()
    os.makedirs(work, exist_ok=True)
    arts = export_serving(work)
    print(json.dumps({"export": {k: arts[k] for k in ("seconds", "bytes",
                                                      "bundle_files")}}),
          flush=True)
    inputs = serving_inputs(os.path.join(work, "inputs.npz"))
    for route in args.routes:
        res = run_route(route, arts, inputs, work)
        print(json.dumps(res), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    if not args.work:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
