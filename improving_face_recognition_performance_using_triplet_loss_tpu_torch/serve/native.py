"""ctypes bindings for the native C++ serving layer (cpp/).

The port's own copy of the JAX package's ``serve/native.py`` (numpy and
ctypes only). The C API in cpp/src/capi.cpp is consumed via ctypes.
``load_native()`` builds the shared library on first use with g++ (one
translation unit) into the port's build directory,
``csrc/_build/native/``, apart from the JAX package's ``cpp/build/``: the
two packages never write one ``.so``. A build writes a temporary file and
renames it into place, so concurrent processes never load a half-written
library. A failed build raises :class:`NativeUnavailable`.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_DIR)
_CPP_DIR = os.path.join(_REPO_ROOT, "cpp")
_LIB_PATH = os.path.join(_PKG_DIR, "csrc", "_build", "native",
                         "libfacejax_native.so")

_lib = None


class NativeUnavailable(RuntimeError):
    pass


def simd_build_flags() -> list:
    """Best SIMD flag set supported by BOTH the compiler and THIS host
    (compiler-only probes would emit AVX-512 code that SIGILLs on an
    AVX2-only machine). AVX-512+VNNI upgrades the matcher dot (16-wide,
    matcher.hpp) and the int8 qgemm (vpdpbusd, qgemm.hpp). The single
    source of build flags for every native build site (cmake mirrors it
    with check_cxx_source_runs)."""
    try:
        with open("/proc/cpuinfo") as f:
            cpu = set(f.read().replace("\n", " ").split())
    except OSError:
        cpu = set()

    def compiler_ok(flags):
        return subprocess.run(["g++", *flags, "-E", "-x", "c++",
                               "/dev/null"],
                              capture_output=True).returncode == 0

    flags = []
    base = ["-mavx2", "-mfma"]
    if {"avx2", "fma"} <= cpu and compiler_ok(base):
        flags += base
        a512 = ["-mavx512f", "-mavx512bw", "-mavx512vl", "-mavx512vnni"]
        if ({"avx512f", "avx512bw", "avx512vl", "avx512_vnni"} <= cpu
                and compiler_ok(flags + a512)):
            flags += a512
    return flags


def build_native(force: bool = False) -> str:
    """Compile the shared library (g++ -O3 -mavx2 -mfma -fopenmp)."""
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    src = os.path.join(_CPP_DIR, "src", "capi.cpp")
    if not os.path.exists(src):
        raise NativeUnavailable(f"native sources not found at {_CPP_DIR}")
    # staleness check covers the headers too (the C API is header-backed)
    hdr_dir = os.path.join(_CPP_DIR, "include", "facejax")
    newest_src = max(
        [os.path.getmtime(src)] +
        [os.path.getmtime(os.path.join(hdr_dir, h))
         for h in os.listdir(hdr_dir) if h.endswith(".hpp")])
    if not force and os.path.exists(_LIB_PATH) and (
            os.path.getmtime(_LIB_PATH) > newest_src):
        return _LIB_PATH
    fd, tmp = tempfile.mkstemp(suffix=".so",
                               dir=os.path.dirname(_LIB_PATH))
    os.close(fd)
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-Wall",
           "-I", os.path.join(_CPP_DIR, "include"), src, "-o", tmp,
           "-fopenmp"]
    cmd[1:1] = simd_build_flags()  # host+compiler-verified SIMD set
    try:
        result = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise NativeUnavailable(f"native build failed: {e}") from e
    if result.returncode != 0:
        os.unlink(tmp)
        raise NativeUnavailable(f"native build failed:\n{result.stderr}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def load_native() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    lib = ctypes.CDLL(path)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)

    lib.fx_set_num_threads.restype = ctypes.c_int
    lib.fx_set_num_threads.argtypes = [ctypes.c_int]
    lib.fx_dot.restype = ctypes.c_float
    lib.fx_dot.argtypes = [f32p, f32p, ctypes.c_int]
    lib.fx_cosine.restype = ctypes.c_float
    lib.fx_cosine.argtypes = [f32p, f32p, ctypes.c_int]
    lib.fx_match_gallery.restype = ctypes.c_int
    lib.fx_match_gallery.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int,
                                     f32p, ctypes.c_float, f32p]
    lib.fx_gallery_norms.argtypes = [f32p, ctypes.c_int, ctypes.c_int, f32p]
    lib.fx_store_open.restype = ctypes.c_void_p
    lib.fx_store_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fx_store_close.argtypes = [ctypes.c_void_p]
    lib.fx_store_size.restype = ctypes.c_int
    lib.fx_store_size.argtypes = [ctypes.c_void_p]
    lib.fx_store_exists.restype = ctypes.c_int
    lib.fx_store_exists.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fx_store_register.restype = ctypes.c_int
    lib.fx_store_register.argtypes = [ctypes.c_void_p, ctypes.c_char_p, f32p,
                                      ctypes.c_float]
    lib.fx_store_register_meta.restype = ctypes.c_int
    lib.fx_store_register_meta.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_char_p, f32p,
                                           ctypes.c_float]
    lib.fx_store_meta.restype = ctypes.c_int
    lib.fx_store_meta.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_char_p, ctypes.c_int]
    lib.fx_store_match.restype = ctypes.c_int
    lib.fx_store_match.argtypes = [ctypes.c_void_p, f32p, ctypes.c_float,
                                   ctypes.c_char_p, ctypes.c_int, f32p]
    lib.fx_nms.restype = ctypes.c_int
    lib.fx_nms.argtypes = [f32p, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                           i32p, ctypes.c_int]
    lib.fx_bbreg.argtypes = [f32p, f32p, ctypes.c_int]
    lib.fx_rerec.argtypes = [f32p, ctypes.c_int]
    lib.fx_select_representatives.restype = ctypes.c_int
    lib.fx_select_representatives.argtypes = [f32p, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_float,
                                              i32p, ctypes.c_int]
    lib.fx_queue_create.restype = ctypes.c_void_p
    lib.fx_queue_destroy.argtypes = [ctypes.c_void_p]
    lib.fx_queue_produce.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int,
                                     ctypes.c_long]
    lib.fx_queue_consume.restype = ctypes.c_int
    lib.fx_queue_consume.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int,
                                     ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_long)]
    lib.fx_sm_create.restype = ctypes.c_void_p
    lib.fx_sm_destroy.argtypes = [ctypes.c_void_p]
    lib.fx_sm_state.restype = ctypes.c_int
    lib.fx_sm_state.argtypes = [ctypes.c_void_p]
    lib.fx_sm_handle.restype = ctypes.c_int
    lib.fx_sm_handle.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.fx_net_open.restype = ctypes.c_void_p
    lib.fx_net_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_char_p, ctypes.c_int]
    lib.fx_net_open_q.restype = ctypes.c_void_p
    lib.fx_net_open_q.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_int]
    lib.fx_efmnet_open.restype = ctypes.c_void_p
    lib.fx_efmnet_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_int]
    lib.fx_efmnet_close.argtypes = [ctypes.c_void_p]
    lib.fx_efmnet_feature_dim.restype = ctypes.c_int
    lib.fx_efmnet_feature_dim.argtypes = [ctypes.c_void_p]
    lib.fx_efmnet_extract.restype = ctypes.c_int
    lib.fx_efmnet_extract.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int,
                                      ctypes.c_int, f32p, ctypes.c_char_p,
                                      ctypes.c_int]
    lib.fx_mtcnn_open.restype = ctypes.c_void_p
    lib.fx_mtcnn_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                  ctypes.c_int]
    lib.fx_mtcnn_open_q.restype = ctypes.c_void_p
    lib.fx_mtcnn_open_q.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.fx_mtcnn_close.argtypes = [ctypes.c_void_p]
    lib.fx_mtcnn_detect.restype = ctypes.c_int
    lib.fx_mtcnn_detect.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_double, f32p,
                                    ctypes.c_int, f32p, ctypes.c_char_p,
                                    ctypes.c_int]
    lib.fx_mtcnn_stage.restype = ctypes.c_int
    lib.fx_mtcnn_stage.argtypes = [ctypes.c_void_p, ctypes.c_int, f32p,
                                   ctypes.c_int, ctypes.c_int, f32p,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.fx_ert_open.restype = ctypes.c_void_p
    lib.fx_ert_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                ctypes.c_int]
    lib.fx_ert_close.argtypes = [ctypes.c_void_p]
    lib.fx_ert_num_points.restype = ctypes.c_int
    lib.fx_ert_num_points.argtypes = [ctypes.c_void_p]
    lib.fx_ert_predict.restype = ctypes.c_int
    lib.fx_ert_predict.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int,
                                   ctypes.c_int, f32p, f32p, f32p,
                                   ctypes.c_char_p, ctypes.c_int]
    lib.fx_mtcnn_ert_detect.restype = ctypes.c_int
    lib.fx_mtcnn_ert_detect.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, f32p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, f32p, ctypes.c_int, f32p,
        ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return lib


def _f32(a: np.ndarray):
    a = np.ascontiguousarray(a, np.float32)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def native_set_num_threads(n: int) -> int:
    """Cap the OpenMP team size for every native kernel in this process
    (pyramid scales, crop batches, GEMMs); n <= 0 just queries. Returns
    the resulting max team size."""
    return int(load_native().fx_set_num_threads(int(n)))


def native_cosine(a: np.ndarray, b: np.ndarray) -> float:
    lib = load_native()
    a, ap = _f32(a)
    b, bp = _f32(b)
    return float(lib.fx_cosine(ap, bp, a.size))


def native_match_gallery(gallery: np.ndarray, query: np.ndarray,
                         sim_th: float = 0.0):
    """Returns (best_index or -1, best_similarity)."""
    lib = load_native()
    g, gp = _f32(gallery)
    q, qp = _f32(query)
    n, d = g.shape
    norms = np.empty(n, np.float32)
    lib.fx_gallery_norms(gp, n, d,
                         norms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    sim = ctypes.c_float(-2.0)
    idx = lib.fx_match_gallery(
        gp, norms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d, qp,
        sim_th, ctypes.byref(sim))
    return int(idx), float(sim.value)


def native_nms(boxes: np.ndarray, threshold: float,
               method: str = "Union") -> np.ndarray:
    lib = load_native()
    b, bp = _f32(boxes)
    n = b.shape[0]
    keep = np.empty(n, np.int32)
    cnt = lib.fx_nms(bp, n, threshold, 1 if method == "Min" else 0,
                     keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n)
    return keep[:cnt].astype(np.int64)


def native_select_representatives(features: np.ndarray,
                                  sim_threshold: float) -> np.ndarray:
    lib = load_native()
    f, fp = _f32(features)
    n, d = f.shape
    out = np.empty(n, np.int32)
    cnt = lib.fx_select_representatives(
        fp, n, d, sim_threshold,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n)
    return out[:cnt].astype(np.int64)


class NativeIdentityStore:
    """Persistent identity DB backed by the C++ store (reference C19)."""

    def __init__(self, path: str, dim: int):
        self._lib = load_native()
        self._h = self._lib.fx_store_open(path.encode(), dim)
        self.dim = dim

    def __len__(self) -> int:
        return self._lib.fx_store_size(self._h)

    def register(self, name: str, fv: np.ndarray,
                 dedup_th: float = 0.99999,
                 meta: dict | str | None = None) -> int:
        """Register a feature; ``meta`` carries the person-record fields of
        the reference's PG schema (title/email/student_id/card_id/img_path,
        Feature.hpp:33-146) as JSON."""
        import json as _json

        fv, fp = _f32(fv)
        assert fv.size == self.dim
        if meta is None:
            return int(self._lib.fx_store_register(self._h, name.encode(),
                                                   fp, dedup_th))
        blob = meta if isinstance(meta, str) else _json.dumps(meta)
        return int(self._lib.fx_store_register_meta(
            self._h, name.encode(), blob.encode(), fp, dedup_th))

    def exists(self, name: str) -> bool:
        """Name already enrolled? (Register_and_Check_DB_File's skip rule,
        Feature.hpp:614-667.)"""
        return bool(self._lib.fx_store_exists(self._h, name.encode()))

    def meta(self, index: int) -> dict | None:
        """Person-record JSON for a row (empty dict when none stored)."""
        import json as _json

        buf = ctypes.create_string_buffer(1 << 16)
        if self._lib.fx_store_meta(self._h, index, buf, 1 << 16) != 0:
            return None
        raw = buf.value.decode()
        return _json.loads(raw) if raw else {}

    def match(self, fv: np.ndarray, sim_th: float = 0.5):
        """Returns (name or None, similarity)."""
        fv, fp = _f32(fv)
        buf = ctypes.create_string_buffer(256)
        sim = ctypes.c_float(-2.0)
        idx = self._lib.fx_store_match(self._h, fp, sim_th, buf, 256,
                                       ctypes.byref(sim))
        return (buf.value.decode() if idx >= 0 else None), float(sim.value)

    def close(self):
        if self._h:
            self._lib.fx_store_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NativeFrameQueue:
    """SPSC drop-stale frame queue (reference C21)."""

    def __init__(self):
        self._lib = load_native()
        self._h = self._lib.fx_queue_create()

    def produce(self, frame: np.ndarray, seq: int = 0):
        f, fp = _f32(frame)
        self._lib.fx_queue_produce(self._h, fp, f.size, seq)
        self._shape = frame.shape

    def consume(self, capacity: int, remove_old: bool = False):
        """Returns (array, seq) or None when empty."""
        out = np.empty(capacity, np.float32)
        seq = ctypes.c_long(0)
        n = self._lib.fx_queue_consume(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            capacity, 1 if remove_old else 0, ctypes.byref(seq))
        if n < 0:
            return None
        return out[:n], int(seq.value)

    def close(self):
        if self._h:
            self._lib.fx_queue_destroy(self._h)
            self._h = None


class NativeStateMachine:
    """Registration state machine (reference C22 SystemState flow)."""

    STATES = ["Identification", "EnterName", "Downcount", "RegImageAcq",
              "SelRegImage", "InputName", "Registration", "RegistFeature"]
    EVENTS = {"start_registration": 0, "name_entered": 1,
              "countdown_done": 2, "images_acquired": 3,
              "images_selected": 4, "details_entered": 5,
              "feature_stored": 6, "cancel": 7, "tick": 8}

    def __init__(self):
        self._lib = load_native()
        self._h = self._lib.fx_sm_create()

    @property
    def state(self) -> str:
        return self.STATES[self._lib.fx_sm_state(self._h)]

    def handle(self, event: str) -> bool:
        return bool(self._lib.fx_sm_handle(self._h, self.EVENTS[event]))

    def close(self):
        if self._h:
            self._lib.fx_sm_destroy(self._h)
            self._h = None


class NativeEmbedder:
    """In-process native forward over an export artifact for every
    grayscale model family — efmnet342, lightcnn9, lightcnn29 (reference
    Feature.hpp:163-205: the C++ runtime runs the embedding net itself via
    MXPredCreatePartialOut; here the engine is cpp/include/facejax/
    efmnet.hpp reading weights.npz directly — no Python compute in the
    loop).

    Accepts an export DIR (serve/export.py layout; the model family comes
    from manifest.json) or a weights.npz path + explicit ``model``.
    """

    SUPPORTED = ("efmnet342", "lightcnn9", "lightcnn29")

    def __init__(self, export_dir_or_npz: str, model: str | None = None,
                 quantized: bool = False):
        """``quantized=True`` runs the convs through the int8 AVX2 path
        (cpp/include/facejax/qgemm.hpp): per-channel saturation-safe int8
        weights, dynamic u8 activations — ~2x the f32 kernel on serving
        latency at >=0.999 embedding cosine vs f32 (tested)."""
        import os

        self._lib = load_native()
        path = export_dir_or_npz
        self.manifest = None
        if os.path.isdir(path):
            import json

            with open(os.path.join(path, "manifest.json")) as f:
                self.manifest = json.load(f)
            model = model or self.manifest.get("model")
            path = os.path.join(path, "weights.npz")
        if model not in self.SUPPORTED:
            raise NativeUnavailable(
                f"native forward supports {self.SUPPORTED}, got {model!r}")
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.fx_net_open_q(path.encode(), model.encode(),
                                          1 if quantized else 0, err, 256)
        if not self._h:
            raise NativeUnavailable(f"fx_net_open: {err.value.decode()}")
        self.model = model
        self.quantized = quantized
        self.feature_dim = self._lib.fx_efmnet_feature_dim(self._h)

    def extract(self, img: np.ndarray) -> np.ndarray:
        """Grayscale [H, W] / [H, W, 1] (or RGB [H, W, 3], converted via
        the reference's luminance rule) -> [feature_dim] floats. uint8
        inputs are scaled by 1/255 (manifest scale contract)."""
        img = np.asarray(img)
        if img.ndim == 3 and img.shape[2] == 3:
            img = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                   + 0.114 * img[..., 2]).astype(np.float32)
        elif img.ndim == 3:
            img = img[..., 0]
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        arr, ptr = _f32(img)
        out = np.empty(self.feature_dim, np.float32)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.fx_efmnet_extract(
            self._h, ptr, arr.shape[0], arr.shape[1],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256)
        if rc != 0:
            raise NativeUnavailable(
                f"fx_efmnet_extract: {err.value.decode()}")
        return out

    def close(self):
        if self._h:
            self._lib.fx_efmnet_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NativeMtcnn:
    """Full-frame MTCNN face detection with no Python compute in the
    loop (reference MTCNN.hpp:993 ``detection_MTCNN``: the C++ runtime runs
    PNet/RNet/ONet itself; here the engine is cpp/include/facejax/mtcnn.hpp
    reading an ``export_mtcnn`` .npz).

    ``detect`` mirrors ``detect.pipeline.MTCNNDetector.detect``'s contract:
    returns (boxes [N, 5], points [10, N]).
    """

    def __init__(self, weights_npz: str, quantized: bool = False):
        """``quantized=True`` runs the deep convs through the int8 AVX2
        path (same qgemm.hpp scheme as the embedder) — faster pyramid
        sweep, with detection decisions near thresholds subject to int8
        rounding (tested on fixtures)."""
        self._lib = load_native()
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.fx_mtcnn_open_q(weights_npz.encode(),
                                            1 if quantized else 0, err, 256)
        if not self._h:
            raise NativeUnavailable(f"fx_mtcnn_open: {err.value.decode()}")
        self.quantized = quantized

    def detect(self, img: np.ndarray, minsize: int = 20,
               thresholds=(0.6, 0.7, 0.7), factor: float = 0.709,
               max_faces: int = 256):
        """img: [H, W] grayscale or [H, W, 3] RGB, values in [0, 255]."""
        img = np.ascontiguousarray(np.asarray(img, np.float32))
        c = 1 if img.ndim == 2 else img.shape[2]
        boxes = np.empty((max_faces, 5), np.float32)
        # the C side writes [10, n] rows packed at stride n (n = the return
        # value), so read from a flat buffer and reshape afterwards
        points = np.empty(10 * max_faces, np.float32)
        err = ctypes.create_string_buffer(256)
        n = self._lib.fx_mtcnn_detect(
            self._h, img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            img.shape[0], img.shape[1], c, minsize,
            thresholds[0], thresholds[1], thresholds[2], factor,
            boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_faces,
            points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256)
        if n < 0:
            raise NativeUnavailable(f"fx_mtcnn_detect: {err.value.decode()}")
        return (boxes[:n].astype(np.float64),
                points[:10 * n].reshape(10, n).astype(np.float64))

    def stage_forward(self, stage: int, x: np.ndarray) -> np.ndarray:
        """Stage-level forward for parity tests. ``x`` is the normalized +
        transposed net input [h, w, 3]; returns the flat output buffer
        (PNet: h'*w'*2 prob then h'*w'*4 reg; RNet: 6; ONet: 16)."""
        x = np.ascontiguousarray(np.asarray(x, np.float32))
        h, w = x.shape[:2]
        if stage == 0:
            # PNet geometry: conv3x3 V -> pool2/2 SAME -> conv3x3 V x2
            ph = (h - 2 + 1) // 2 - 4
            pw = (w - 2 + 1) // 2 - 4
            out = np.empty(ph * pw * 6, np.float32)
        elif stage == 1:
            out = np.empty(6, np.float32)
        else:
            out = np.empty(16, np.float32)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.fx_mtcnn_stage(
            self._h, stage, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            h, w, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            err, 256)
        if rc != 0:
            raise NativeUnavailable(f"fx_mtcnn_stage: {err.value.decode()}")
        return out

    def close(self):
        if self._h:
            self._lib.fx_mtcnn_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NativeErt:
    """Native ERT 68-point shape regression (cpp/include/facejax/ert.hpp)
    over a serve.export.export_ert .npz — the landmark-refinement half of
    the reference's MTCNN_Dlib_Detection (MTCNN.hpp:1326-1421), with zero
    Python compute in the loop."""

    def __init__(self, weights_npz: str):
        self._lib = load_native()
        err = ctypes.create_string_buffer(256)
        self._h = self._lib.fx_ert_open(weights_npz.encode(), err, 256)
        if not self._h:
            raise NativeUnavailable(f"fx_ert_open: {err.value.decode()}")
        self.num_points = self._lib.fx_ert_num_points(self._h)

    def predict(self, img: np.ndarray, rect, five_xy=None) -> np.ndarray:
        """Grayscale image + rect (+ optional MTCNN 5 points [5, 2] for
        seeding) -> [num_points, 2] image coordinates (the
        full_object_detection.part() contract of ShapePredictor.predict)."""
        img = np.asarray(img)
        if img.ndim == 3:
            img = img.mean(-1)
        arr, ptr = _f32(img)
        rect_a, rect_p = _f32(np.asarray(rect, np.float32))
        five_p = None
        if five_xy is not None:
            five_a, five_p = _f32(np.asarray(five_xy, np.float32))
        out = np.empty((self.num_points, 2), np.float32)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.fx_ert_predict(
            self._h, ptr, arr.shape[0], arr.shape[1], rect_p, five_p,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256)
        if rc != 0:
            raise NativeUnavailable(f"fx_ert_predict: {err.value.decode()}")
        return out

    def close(self):
        if self._h:
            self._lib.fx_ert_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def native_mtcnn_ert_detect(mtcnn: "NativeMtcnn", ert: NativeErt,
                            img: np.ndarray, minsize: int = 20,
                            thresholds=(0.6, 0.7, 0.7),
                            factor: float = 0.709, max_faces: int = 256):
    """The complete MTCNN_Dlib_Detection flow in ONE native call
    (MTCNN.hpp:1326-1421): cascade detect, seed each face's init from its
    5 MTCNN landmarks, ERT-refine. Returns (boxes [N, 4],
    landmarks [N, num_points, 2]) — detect/ert.py::mtcnn_ert_detect's
    contract."""
    lib = load_native()
    img = np.ascontiguousarray(np.asarray(img, np.float32))
    c = 1 if img.ndim == 2 else img.shape[2]
    npts = ert.num_points
    boxes = np.empty((max_faces, 4), np.float32)
    lmk = np.empty((max_faces, npts, 2), np.float32)
    err = ctypes.create_string_buffer(256)
    n = lib.fx_mtcnn_ert_detect(
        mtcnn._h, ert._h,
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        img.shape[0], img.shape[1], c, minsize,
        thresholds[0], thresholds[1], thresholds[2], factor,
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_faces,
        lmk.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), err, 256)
    if n < 0:
        raise NativeUnavailable(
            f"fx_mtcnn_ert_detect: {err.value.decode()}")
    return boxes[:n], lmk[:n]
