"""dlib ``shape_predictor`` .dat <-> ERT converter (VERDICT r2 item 8).

A copy of the JAX package's ``detect/dlib_import.py`` (numpy only), over
the port's ``detect/ert.py``: both packages read and write the same bytes.

The reference's C++ runtime deserializes a dlib 68-point shape_predictor
.dat (``MTCNN_Dlib_Detection``, MTCNN.hpp:924-988, :1326-1421). No .dat
model exists in this environment, so this module implements dlib's binary
serialization format from its public spec (dlib/serialize.h,
dlib/float_details.h, dlib/image_processing/shape_predictor.h — all
boost-licensed public headers) so a real ``shape_predictor_68_face_
landmarks.dat`` drops straight into this framework's ERT the day one is
available. A writer for the same format enables (a) byte-level round-trip
tests and (b) exporting predictors trained here to dlib-consuming apps.

## Format spec (dlib serialization, as of dlib 19.x)

Primitives:

- **integer** (any width, signed or unsigned): one control byte
  ``size | (0x80 if negative)`` where ``size`` is the number of payload
  bytes after trailing-zero trimming (0 for the value 0), followed by
  ``size`` little-endian magnitude bytes.
- **float/double**: converted to ``float_details {int64 mantissa,
  int16 exponent}`` with value = mantissa * 2**exponent; serialized as
  the two integers, mantissa first.
- **std::vector<T>**: size (unsigned long integer) then the elements.
- **matrix<T,0,1>**: nr (long), nc (long, always 1), then nr*nc elements.
- **dlib::vector<T,2>**: x then y.

shape_predictor layout (shape_predictor.h::serialize):

1. ``version`` int, must be 1
2. ``initial_shape`` matrix<float,0,1> of 2L interleaved (x,y) coords in
   the unit square of the detection rect
3. ``forests`` vector<vector<regression_tree>> — [cascade][tree], each
   regression_tree = {vector<split_feature> splits (heap-ordered internal
   nodes: idx1 ulong, idx2 ulong, thresh float),
   vector<matrix<float,0,1>> leaf_values (2**depth leaves of 2L floats)}
4. ``anchor_idx`` vector<vector<unsigned long>> — [cascade][pixel]
   nearest-landmark index per feature pixel
5. ``deltas`` vector<vector<dlib::vector<float,2>>> — [cascade][pixel]
   offset from the anchor landmark in mean-shape coordinates

Semantic mapping to :class:`~.ert.ShapePredictor` is 1:1 (detect/ert.py
implements dlib's algorithm exactly): heap split order, the left-child
test ``pix[idx1] - pix[idx2] > thresh``, leaf index ``node - n_internal``,
and shapes normalized to the rect's unit square all coincide. The only
transformation is layout: dlib's per-tree vectors become this repo's
dense [K, 2**D-1] / [K, 2**D, 2L] arrays (all trees in a dlib cascade
share one depth; mixed depths raise).
"""

from __future__ import annotations

import math
from typing import BinaryIO

import numpy as np

from .ert import CascadeLevel, ShapePredictor

__all__ = ["read_shape_predictor_dat", "write_shape_predictor_dat"]


# --------------------------------------------------------------- primitives


def _read_int(f: BinaryIO) -> int:
    ctl = f.read(1)
    if not ctl:
        raise EOFError("truncated dlib stream")
    ctl = ctl[0]
    neg = bool(ctl & 0x80)
    size = ctl & 0x7F
    if size > 8:
        raise ValueError(f"dlib int with {size} payload bytes (corrupt?)")
    payload = f.read(size)
    if len(payload) != size:  # a short read would silently decode garbage
        raise EOFError("truncated dlib stream (int payload)")
    mag = int.from_bytes(payload, "little")
    return -mag if neg else mag


def _write_int(f: BinaryIO, v: int) -> None:
    neg = v < 0
    mag = -v if neg else v
    payload = b""
    while mag:
        payload += bytes([mag & 0xFF])
        mag >>= 8
    if len(payload) > 8:
        raise ValueError(f"integer too wide for dlib encoding: {v}")
    f.write(bytes([len(payload) | (0x80 if neg else 0)]) + payload)


def _read_float(f: BinaryIO) -> float:
    mantissa = _read_int(f)
    exponent = _read_int(f)
    # untrusted input: an 8-byte exponent would make ldexp raise
    # OverflowError (or silently produce inf). The legal range must
    # admit every finite DOUBLE the float_details encoding can carry
    # (the format doc above): a subnormal double's trimmed-mantissa
    # exponent reaches -1074, and a 53-bit-mantissa encoding of the same
    # value goes to about -1126; 2^1024-adjacent values stay within
    # +1024. |exponent| <= 1200 covers all of it with margin; beyond
    # that the .dat is corrupt.
    if abs(exponent) > 1200:
        raise ValueError(
            f"corrupt dlib .dat: float exponent {exponent} out of range")
    try:
        return math.ldexp(mantissa, exponent)
    except OverflowError:  # huge mantissa can still overflow within range
        raise ValueError(
            f"corrupt dlib .dat: float {mantissa}*2^{exponent} overflows")


def _write_float(f: BinaryIO, v: float) -> None:
    v = float(np.float32(v))  # the .dat stores float32 values
    if v == 0.0 or not math.isfinite(v):
        mantissa, exponent = (0, 0) if v == 0.0 else (0, 0x7FFF)
        if not math.isfinite(v):
            raise ValueError("non-finite float in dlib export")
    else:
        frac, exp = math.frexp(v)  # v = frac * 2**exp, frac in [0.5, 1)
        mantissa = int(frac * (1 << 53))
        exponent = exp - 53
        # trim trailing zero bits so float32 values stay compact
        while mantissa and not (mantissa & 1):
            mantissa >>= 1
            exponent += 1
    _write_int(f, mantissa)
    _write_int(f, exponent)


def _read_fcolumn(f: BinaryIO) -> np.ndarray:
    """matrix<float,0,1>: nr, nc (must be 1), then elements."""
    nr = _read_int(f)
    nc = _read_int(f)
    if nc != 1:
        raise ValueError(f"expected a column matrix, got nc={nc}")
    return np.asarray([_read_float(f) for _ in range(nr)], np.float32)


def _write_fcolumn(f: BinaryIO, col: np.ndarray) -> None:
    col = np.asarray(col, np.float32).ravel()
    _write_int(f, len(col))
    _write_int(f, 1)
    for v in col:
        _write_float(f, float(v))


# ---------------------------------------------------------------- predictor


def _check_count(n: int, f: BinaryIO, total: int, per_item_bytes: int,
                 what: str) -> int:
    """Validate a count read from an UNTRUSTED .dat before allocating with
    it: it must be non-negative and consistent with the bytes remaining in
    the file (every encoded item costs at least ``per_item_bytes``), so a
    corrupt/truncated file raises a clean parse error instead of a
    multi-TB np.empty MemoryError."""
    if n < 0 or n * per_item_bytes > total - f.tell():
        raise ValueError(
            f"implausible {what} count {n} for {total - f.tell()} bytes "
            "remaining (corrupt or truncated shape_predictor .dat?)")
    return n


def read_shape_predictor_dat(path: str) -> ShapePredictor:
    """Parse a dlib shape_predictor .dat into this repo's ShapePredictor."""
    import os

    total = os.path.getsize(path)
    with open(path, "rb") as f:
        version = _read_int(f)
        if version != 1:
            raise ValueError(f"unsupported shape_predictor version "
                             f"{version} (dlib writes 1)")
        flat = _read_fcolumn(f)  # initial_shape, 2L interleaved
        if len(flat) % 2:
            raise ValueError("odd-length initial_shape")
        mean_shape = flat.reshape(-1, 2)
        two_l = len(flat)

        # forests[cascade][tree]
        n_casc = _read_int(f)
        forests = []
        for _ in range(n_casc):
            n_trees = _read_int(f)
            trees = []
            for _ in range(n_trees):
                # each split encodes two ints + a float: >= 4 bytes
                n_splits = _check_count(_read_int(f), f, total, 4, "split")
                idx1 = np.empty(n_splits, np.int64)
                idx2 = np.empty(n_splits, np.int64)
                thr = np.empty(n_splits, np.float32)
                for s in range(n_splits):
                    idx1[s] = _read_int(f)
                    idx2[s] = _read_int(f)
                    thr[s] = _read_float(f)
                # each leaf is a 2L-float column: >= 2 bytes per float
                n_leaves = _check_count(_read_int(f), f, total,
                                        2 * two_l, "leaf")
                leaves = np.empty((n_leaves, two_l), np.float32)
                for li in range(n_leaves):
                    leaf = _read_fcolumn(f)
                    if len(leaf) != two_l:
                        raise ValueError("leaf dimension mismatch")
                    leaves[li] = leaf
                if n_leaves != n_splits + 1:
                    raise ValueError(
                        f"tree is not a complete heap: {n_splits} splits "
                        f"vs {n_leaves} leaves")
                trees.append((idx1, idx2, thr, leaves))
            forests.append(trees)

        # anchor_idx[cascade][pixel]
        if _read_int(f) != n_casc:
            raise ValueError("anchor_idx cascade count mismatch")
        anchor_idx = []
        for _ in range(n_casc):
            n_pix = _check_count(_read_int(f), f, total, 1, "anchor pixel")
            anchor_idx.append(
                np.asarray([_read_int(f) for _ in range(n_pix)], np.int64))

        # deltas[cascade][pixel] (x, y)
        if _read_int(f) != n_casc:
            raise ValueError("deltas cascade count mismatch")
        deltas = []
        for _ in range(n_casc):
            # each delta is two floats: >= 4 bytes
            n_pix = _check_count(_read_int(f), f, total, 4, "delta pixel")
            d = np.empty((n_pix, 2), np.float32)
            for pi in range(n_pix):
                d[pi, 0] = _read_float(f)
                d[pi, 1] = _read_float(f)
            deltas.append(d)

    levels = []
    for t, trees in enumerate(forests):
        n_splits = {len(tr[0]) for tr in trees}
        if len(n_splits) != 1:
            raise ValueError(f"cascade {t} mixes tree depths {n_splits} — "
                             "the dense [K, 2**D-1] layout needs one depth")
        levels.append(CascadeLevel(
            anchors=anchor_idx[t],
            deltas=deltas[t],
            split_idx1=np.stack([tr[0] for tr in trees]),
            split_idx2=np.stack([tr[1] for tr in trees]),
            split_thresh=np.stack([tr[2] for tr in trees]),
            leaf_values=np.stack([tr[3] for tr in trees]),
        ))
    return ShapePredictor(mean_shape=mean_shape, levels=levels)


def write_shape_predictor_dat(path: str, predictor: ShapePredictor) -> str:
    """Serialize a ShapePredictor in dlib's .dat format (the inverse of
    :func:`read_shape_predictor_dat`; also the round-trip test vector
    generator while no real .dat exists in this environment)."""
    with open(path, "wb") as f:
        _write_int(f, 1)  # version
        _write_fcolumn(f, np.asarray(predictor.mean_shape,
                                     np.float32).ravel())

        _write_int(f, len(predictor.levels))
        for lv in predictor.levels:
            k, n_splits = lv.split_idx1.shape
            _write_int(f, k)
            for ti in range(k):
                _write_int(f, n_splits)
                for s in range(n_splits):
                    _write_int(f, int(lv.split_idx1[ti, s]))
                    _write_int(f, int(lv.split_idx2[ti, s]))
                    _write_float(f, float(lv.split_thresh[ti, s]))
                _write_int(f, lv.leaf_values.shape[1])
                for li in range(lv.leaf_values.shape[1]):
                    _write_fcolumn(f, lv.leaf_values[ti, li])

        _write_int(f, len(predictor.levels))
        for lv in predictor.levels:
            _write_int(f, len(lv.anchors))
            for a in np.asarray(lv.anchors).ravel():
                _write_int(f, int(a))

        _write_int(f, len(predictor.levels))
        for lv in predictor.levels:
            _write_int(f, len(lv.deltas))
            for dx, dy in np.asarray(lv.deltas, np.float32):
                _write_float(f, float(dx))
                _write_float(f, float(dy))
    return path
