"""Ahead-of-time export of the recognition pipeline and of extraction:
artifacts that a later process loads and runs without the port's model
code.

Port of the JAX package's ``serve/aot.py``. The artifacts are the port's
own formats, not StableHLO or a PJRT executable:

- ``export_pipeline`` / ``load_pipeline``: ``torch.export`` of the whole
  fused program (MTCNN cascade, crop, embedding net, gallery match), saved
  with ``torch.export.save`` (``.pt2``). Weights and a baked gallery are
  constants of the program. ``gallery_shape=(G, D)`` exports a
  ``dynamic_gallery=True`` pipeline, called as ``fn(frame, gallery_n,
  rows)``: the L2-normalized ``[G, D]`` gallery (f32, bf16 or int8, as
  ``serve.pipeline.normalize_gallery`` gives it) and ``rows``, a 0-d int32
  count of enrolled rows; rows >= ``rows`` never win a match.
- ``export_compiled`` / ``load_compiled``: the same program compiled by
  AOTInductor into a package (``aoti_compile_and_package``), tied to the
  device kind and the torch version that built it.
- ``prime_cache_bundle`` / ``install_cache_bundle``: the port's compile
  cache is its kernel libraries (``ops/cuda/_build.py``, keyed by a hash of
  source and flags, so independent of the path). The bundle,
  ``<artifact>.xcache/``, holds the libraries the deploy path loaded; a
  machine that installs it skips ``nvcc``.
- ``export_extract`` / ``load_extract``: the batched extraction graph with
  the model's state dict as an argument, so one artifact serves every
  checkpoint of the architecture.

The kernels of the program (NMS, the stems, EFM3, the LightCNN9 front) are
``torch.library`` ops of the ``facejax`` namespace
(``ops/cuda/*.py``): a loading process imports the port's ``ops`` package
to register them, and nothing of ``models`` or ``detect``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from ..ops.cuda import _build
from ..ops.distances import l2_normalize

#: the directory of kernel libraries shipped next to an artifact
CACHE_BUNDLE_SUFFIX = ".xcache"
PIPELINE_FORMAT = "torch.export ExportedProgram"
COMPILED_FORMAT = "AOTInductor package"
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def _register_ops() -> None:
    """Import the kernel wrappers: each registers its ``facejax`` op."""
    from ..ops.cuda import efm3, front9, mining, nms, stem  # noqa: F401


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to export for the CPU")
    return dev


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


class _Program(torch.nn.Module):
    """A pipeline closure as the module ``torch.export`` takes."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _pipeline_inputs(frame_h, frame_w, streams, gallery_shape, gallery_dtype,
                     dev):
    shape = ((streams, frame_h, frame_w, 3) if streams
             else (frame_h, frame_w, 3))
    args = [torch.zeros(shape, dtype=torch.float32, device=dev)]
    if gallery_shape is not None:
        args.append(torch.zeros(tuple(gallery_shape),
                                dtype=_DTYPES[_dtype_name(gallery_dtype)],
                                device=dev))
        args.append(torch.ones((), dtype=torch.int32, device=dev))
    return tuple(args)


def _export(pipeline, frame_h, frame_w, streams, gallery_shape, gallery_dtype,
            dev):
    _register_ops()
    args = _pipeline_inputs(frame_h, frame_w, streams, gallery_shape,
                            gallery_dtype, dev)
    return torch.export.export(_Program(pipeline), args, strict=False)


def _save(program, out_path: str) -> None:
    """``torch.export.save`` without the example inputs (zeros, or a whole
    state dict), which the program does not need."""
    program.example_inputs = None
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    torch.export.save(program, out_path)


def _pipeline_meta(frame_h, frame_w, streams, gallery_shape, gallery_dtype,
                   dev, fmt) -> dict:
    meta = {"frame_h": frame_h, "frame_w": frame_w,
            "platforms": [dev.type], "format": fmt}
    if streams:
        meta["streams"] = streams
    if gallery_shape is not None:
        meta["gallery_rows"] = int(gallery_shape[0])
        meta["gallery_dim"] = int(gallery_shape[1])
        meta["gallery_dtype"] = _dtype_name(gallery_dtype)
        meta["dynamic_gallery"] = True
    return meta


def _write_meta(path: str, meta: dict) -> None:
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def read_meta(path: str) -> dict:
    """An artifact's sidecar ``<path>.json``."""
    with open(path + ".json") as f:
        return json.load(f)


def export_pipeline(out_path: str, pipeline, frame_h: int, frame_w: int,
                    *, streams: int = 0, gallery_shape=None,
                    gallery_dtype=torch.float32, device=None) -> str:
    """Export a pipeline fn (``make_recognition_pipeline`` /
    ``make_multiface_pipeline``, or ``make_multistream_pipeline`` with
    ``streams`` > 0 frames a call) for float32 frames ``[frame_h, frame_w,
    3]``, built on ``device`` (``cuda`` unless given).

    ``gallery_shape=(G, D)`` exports a ``dynamic_gallery=True`` pipeline:
    the artifact is called as ``fn(frame, gallery_n, rows)`` with a ``[G,
    D]`` gallery of ``gallery_dtype`` and a 0-d int32 ``rows``. Writes the
    ``.pt2`` and its sidecar ``<out_path>.json``."""
    dev = _device(device)
    program = _export(pipeline, frame_h, frame_w, streams, gallery_shape,
                      gallery_dtype, dev)
    _save(program, out_path)
    _write_meta(out_path, _pipeline_meta(frame_h, frame_w, streams,
                                         gallery_shape, gallery_dtype, dev,
                                         PIPELINE_FORMAT))
    return out_path


def _check_platform(path: str, meta: dict) -> torch.device:
    platform = (meta.get("platform") or meta["platforms"][0])
    if platform == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path}: a CUDA artifact, and CUDA is not "
                           "available here")
    return torch.device(platform)


def _caller(run, dev: torch.device):
    """``run`` taking numpy or tensor inputs (a Python int for ``rows``)."""

    def fn(*args):
        ins = []
        for a in args:
            if isinstance(a, (int, np.integer)):
                a = torch.tensor(int(a), dtype=torch.int32)
            ins.append(torch.as_tensor(a, device=dev))
        return run(*ins)

    return fn


def load_pipeline(path: str, *, use_cache_bundle: bool = True):
    """Load an ``export_pipeline`` artifact; returns fn(frame) -> the
    outputs dict (fn(frame, gallery_n, rows) for a dynamic-gallery
    artifact: see the sidecar's ``dynamic_gallery``). Imports no model
    code. A ``<path>.xcache/`` bundle is installed first (see
    :func:`install_cache_bundle`)."""
    meta = read_meta(path)
    dev = _check_platform(path, meta)
    if use_cache_bundle:
        install_cache_bundle(path)
    _register_ops()
    module = torch.export.load(path).module()
    return _caller(module, dev)


def install_cache_bundle(artifact_path: str) -> bool:
    """Copy the kernel libraries of ``<artifact>.xcache/`` into the port's
    build directory (``ops/cuda/_build.BUILD_DIR``); a library already
    there wins. Returns True if anything was installed."""
    bundle = artifact_path + CACHE_BUNDLE_SUFFIX
    if not os.path.isdir(bundle):
        return False
    build_dir = _build.BUILD_DIR
    installed = False
    for name in sorted(os.listdir(bundle)):
        if not name.endswith(".so"):
            continue
        dst = os.path.join(build_dir, name)
        if os.path.exists(dst):
            continue
        os.makedirs(build_dir, exist_ok=True)
        # a copy under a temporary name, renamed once whole
        shutil.copy2(os.path.join(bundle, name), dst + ".tmp")
        os.replace(dst + ".tmp", dst)
        installed = True
    return installed


_PRIME_SRC = r"""
import json, os, sys
sys.path.insert(0, {repo!r})
import torch
from {package}.serve import aot
path = {path!r}
meta = aot.read_meta(path)
if meta["format"] == aot.COMPILED_FORMAT:
    fn = aot.load_compiled(path, use_cache_bundle=False)
else:
    fn = aot.load_pipeline(path, use_cache_bundle=False)
fn(*aot.example_inputs(meta))
if torch.cuda.is_available():
    torch.cuda.synchronize()
from {package}.ops.cuda import _build
print("PRIMED " + json.dumps(sorted(os.path.basename(_build._target(n))
                                    for n in _build._libs)))
"""


def example_inputs(meta: dict) -> tuple:
    """Zero inputs of a pipeline artifact's call signature (``rows`` = 1),
    on its device."""
    dev = torch.device(meta.get("platform") or meta["platforms"][0])
    gallery_shape = ((meta["gallery_rows"], meta["gallery_dim"])
                     if meta.get("dynamic_gallery") else None)
    return _pipeline_inputs(meta["frame_h"], meta["frame_w"],
                            meta.get("streams", 0), gallery_shape,
                            meta.get("gallery_dtype", "float32"), dev)


def prime_cache_bundle(artifact_path: str, *, timeout: int = 3600) -> str:
    """Run the deploy path of an artifact once in a fresh subprocess
    (``load_pipeline`` or ``load_compiled``, one call on zero inputs) and
    copy the kernel libraries it loaded into ``<artifact>.xcache/``.
    Returns the bundle's path. A CPU artifact loads no kernel, so its
    bundle is empty; a CUDA artifact that loaded none raises."""
    bundle = artifact_path + CACHE_BUNDLE_SUFFIX
    os.makedirs(bundle, exist_ok=True)
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _PRIME_SRC.format(repo=os.path.dirname(pkg_dir),
                             package=os.path.basename(pkg_dir),
                             path=os.path.abspath(artifact_path))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout)
    line = next((ln for ln in r.stdout.splitlines()
                 if ln.startswith("PRIMED ")), None)
    if r.returncode != 0 or line is None:
        raise RuntimeError(f"cache-bundle priming failed rc={r.returncode}:"
                           f"\n{r.stderr[-2000:]}")
    names = json.loads(line[len("PRIMED "):])
    for name in names:
        shutil.copy2(os.path.join(_build.BUILD_DIR, name),
                     os.path.join(bundle, name))
    meta = read_meta(artifact_path)
    if (meta.get("platform") or meta["platforms"][0]) == "cuda" and not names:
        raise RuntimeError("priming ran a CUDA artifact but loaded no "
                           "kernel library")
    return bundle


def export_compiled(out_path: str, pipeline, frame_h: int, frame_w: int,
                    *, streams: int = 0, gallery_shape=None,
                    gallery_dtype=torch.float32, device=None,
                    program=None) -> str:
    """Compile the pipeline ahead of time: AOTInductor's package of the
    exported program (``program``, an ExportedProgram of this pipeline,
    or exported here), so a serving process loads a ready library.

    The package is tied to the device kind and the torch version that
    built it; the sidecar records both, the card's name and the CUDA
    version, and :func:`load_compiled` refuses another device kind, card
    or torch version."""
    dev = _device(device)
    if program is None:
        program = _export(pipeline, frame_h, frame_w, streams, gallery_shape,
                          gallery_dtype, dev)
    if program.example_inputs is None:   # a saved program has none
        program.example_inputs = (_pipeline_inputs(
            frame_h, frame_w, streams, gallery_shape, gallery_dtype, dev), {})
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if os.path.exists(out_path):
        os.remove(out_path)
    _register_ops()
    torch._inductor.aoti_compile_and_package(
        program, package_path=out_path,
        inductor_configs={"cpp.cxx": (None, openmp_cxx())})
    meta = _pipeline_meta(frame_h, frame_w, streams, gallery_shape,
                          gallery_dtype, dev, COMPILED_FORMAT)
    meta.update(platform=dev.type, torch_version=torch.__version__,
                cuda_version=torch.version.cuda,
                device_name=_device_name(dev))
    _write_meta(out_path, meta)
    return out_path


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def openmp_cxx() -> str:
    """A C++ compiler for AOTInductor's build, which takes ``-fopenmp``:
    ``$CXX`` when it builds with OpenMP, else the ``g++`` on ``PATH``."""
    for cxx in dict.fromkeys(filter(None, (os.environ.get("CXX"),
                                           shutil.which("g++")))):
        r = subprocess.run([cxx, "-x", "c++", "-fopenmp", "-shared",
                            "-fPIC", "-o", os.devnull, "-"],
                           input="int f() { return 0; }",
                           capture_output=True, text=True)
        if r.returncode == 0:
            return cxx
    raise RuntimeError("no C++ compiler here builds with -fopenmp "
                       "(AOTInductor's C++ wrapper needs one)")


def load_compiled(path: str, *, use_cache_bundle: bool = True):
    """Load an ``export_compiled`` package: fn(frame[, gallery_n, rows]) ->
    the outputs dict, no trace and no compile. Raises on another device
    kind, another card (by name) or another torch version than the
    package's."""
    meta = read_meta(path)
    if meta.get("format") != COMPILED_FORMAT:
        raise ValueError(f"{path}: not an {COMPILED_FORMAT}")
    if meta["torch_version"] != torch.__version__:
        raise RuntimeError(f"{path}: compiled by torch "
                           f"{meta['torch_version']}, this is "
                           f"{torch.__version__}")
    dev = _check_platform(path, meta)
    if meta["device_name"] != _device_name(dev):
        raise RuntimeError(f"{path}: compiled for {meta['device_name']}, "
                           f"this is {_device_name(dev)}")
    if use_cache_bundle:
        install_cache_bundle(path)
    _register_ops()
    return _caller(torch._inductor.aoti_load_package(path), dev)


class _Extract(torch.nn.Module):
    """fn(state_dict, images) -> (logits, features) over one model."""

    def __init__(self, model, normalize: bool):
        super().__init__()
        # not a submodule: its weights are the call's, not the program's
        object.__setattr__(self, "run", model)
        self.normalize = normalize

    def forward(self, variables, images):
        logits, feat = torch.func.functional_call(self.run, variables,
                                                  (images,))
        if self.normalize:
            feat = l2_normalize(feat)
        return logits, feat


def export_extract(out_path: str, model, batch_size: int, height: int,
                   width: int, channels: int = 1, *, normalize: bool = True,
                   device=None) -> str:
    """Export the batched extraction graph of an eval-mode port model:
    fn(variables, images [B, H, W, C] float32) -> (logits, features), with
    ``variables`` the model's state dict, so one artifact serves every
    checkpoint of the architecture."""
    dev = _device(device)
    _register_ops()
    model = model.eval()
    variables = {k: v.to(dev) for k, v in model.state_dict().items()}
    images = torch.zeros((batch_size, height, width, channels),
                         dtype=torch.float32, device=dev)
    with torch.no_grad():
        program = torch.export.export(_Extract(model, normalize),
                                      (variables, images), strict=False)
    _save(program, out_path)
    _write_meta(out_path, {"batch_size": batch_size, "height": height,
                           "width": width, "channels": channels,
                           "normalize": normalize, "platforms": [dev.type],
                           "format": PIPELINE_FORMAT})
    return out_path


def load_extract(path: str):
    """Returns fn(variables, images) -> (logits, features)."""
    dev = _check_platform(path, read_meta(path))
    _register_ops()
    module = torch.export.load(path).module()

    @torch.no_grad()
    def fn(variables, images):
        return module({k: torch.as_tensor(v, device=dev)
                       for k, v in variables.items()},
                      torch.as_tensor(images, device=dev))

    return fn
