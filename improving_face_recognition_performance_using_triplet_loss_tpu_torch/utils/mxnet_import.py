"""Import the reference's trained MXNet checkpoints (``EFM_RES.params``).

The reference's training artifacts are MXNet symbol checkpoints — symbol
JSON + a ``.params`` NDArray file (extract_feacture_v2.py:45-51 loads them;
the C++ runtime consumes the same pair, Feature.hpp:213-219). A user
switching to this framework brings those files; this module reads the
``.params`` binary WITHOUT mxnet (the package does not depend on it) and maps
the EFM-symbol weight names onto the flax ``EFMNet342`` parameter tree, so
one command turns a reference checkpoint into a standard export usable by
extraction, serving, LFW eval, and the native C++ runtime.

Binary format: dmlc NDArray list (mxnet src/ndarray/ndarray.cc) —
  uint64 kMXAPINDArrayListMagic (0x112), uint64 reserved,
  uint64 count, count x NDArray, uint64 count, count x (uint64 len, name).
Each NDArray: uint32 magic (V1 0xF993FAC8 / V2 0xF993FAC9 / V3 0xF993FACA;
V2+ insert an int32 storage type), shape (uint32 ndim + uint32 or int64
dims by build), int32 dev_type, int32 dev_id, int32 type_flag, raw data.
Because the dim width varies across builds, the parser tries both widths
per array and accepts the hypothesis under which every field validates and
the WHOLE file is consumed exactly — a wrong layout guess cannot parse
silently. Weight-name conventions per Module.save_checkpoint: ``arg:`` /
``aux:`` prefixes.

Layout conversions (MXNet is NCHW, the flax layout is NHWC):
  conv  [Cout, Cin, KH, KW]  ->  [KH, KW, Cin, Cout]
  dense [Out, In]            ->  [In, Out]
  fc1 additionally permutes its input axis from the NCHW flatten order
  (C-major) to the NHWC flatten order (HW-major).
This module is a numpy copy of the JAX package's ``utils/mxnet_import.py``
(whose tests prove the mapping against an independent NCHW oracle; the
port's tests hold this copy to it). The trees it yields are what the
export holds, and ``serve/convert.py::from_jax_params`` carries them into
the port's modules.
"""

from __future__ import annotations

import struct

import numpy as np

_LIST_MAGIC = 0x112
_ND_MAGICS = {0xF993FAC8: 1, 0xF993FAC9: 2, 0xF993FACA: 3}
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32, 5: np.int8, 6: np.int64}


class MxParamsError(ValueError):
    pass


def _try_parse_array(buf: bytes, pos: int, dim64: bool):
    """Parse one NDArray at ``pos``; returns (array, new_pos) or None."""
    try:
        (magic,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if magic in _ND_MAGICS:
            if _ND_MAGICS[magic] >= 2:  # V2/V3 carry a storage type
                (stype,) = struct.unpack_from("<i", buf, pos)
                pos += 4
                if stype != 0:  # kDefaultStorage; sparse unsupported
                    return None
        else:
            pos -= 4  # legacy: no magic, shape follows directly
        (ndim,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        if not 0 < ndim <= 8:
            return None
        if dim64:
            dims = struct.unpack_from(f"<{ndim}q", buf, pos)
            pos += 8 * ndim
        else:
            dims = struct.unpack_from(f"<{ndim}I", buf, pos)
            pos += 4 * ndim
        if any(d <= 0 or d > 1 << 30 for d in dims):
            return None
        dev_type, dev_id, type_flag = struct.unpack_from("<iii", buf, pos)
        pos += 12
        if dev_type not in (1, 2, 3, 5) or dev_id < 0 or dev_id > 64:
            return None
        if type_flag not in _DTYPES:
            return None
        dt = np.dtype(_DTYPES[type_flag])
        n = 1
        for d in dims:  # python ints: no int64 wraparound on corrupt dims
            n *= int(d)
        nbytes = n * dt.itemsize
        if nbytes > len(buf) or pos + nbytes > len(buf):
            return None
        arr = np.frombuffer(buf, dtype=dt, count=n, offset=pos).reshape(dims)
        return arr.copy(), pos + nbytes
    except (struct.error, ValueError):
        return None


def read_mxnet_params(path: str) -> tuple[dict, dict]:
    """Read a .params file -> ({arg_name: array}, {aux_name: array})."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 24:
        raise MxParamsError("file too short for an NDArray list")
    head, reserved, count = struct.unpack_from("<QQQ", buf, 0)
    if head != _LIST_MAGIC:
        raise MxParamsError(
            f"bad list magic 0x{head:x} (expected 0x{_LIST_MAGIC:x}) — "
            "not an mx.nd.save/.params file?")
    for dim64 in (False, True):
        pos = 24
        arrays = []
        ok = True
        for _ in range(count):
            got = _try_parse_array(buf, pos, dim64)
            if got is None:
                ok = False
                break
            arr, pos = got
            arrays.append(arr)
        if not ok:
            continue
        # keys: uint64 count then (uint64 len, bytes) each
        try:
            (kcount,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            if kcount != count:
                continue
            names = []
            for _ in range(kcount):
                (ln,) = struct.unpack_from("<Q", buf, pos)
                pos += 8
                if ln > 4096 or pos + ln > len(buf):
                    names = None
                    break
                names.append(buf[pos:pos + ln].decode("utf-8"))
                pos += ln
            if names is None or pos != len(buf):
                continue
        except (struct.error, UnicodeDecodeError):
            continue
        args, aux = {}, {}
        for name, arr in zip(names, arrays):
            if name.startswith("arg:"):
                args[name[4:]] = arr
            elif name.startswith("aux:"):
                aux[name[4:]] = arr
            else:
                args[name] = arr
        return args, aux
    raise MxParamsError(
        "could not parse the NDArray list under any known layout "
        "(uint32/int64 dims, V1-V3 magics) — corrupted file or an "
        "unsupported MXNet version")


def write_mxnet_params(path: str, args: dict, aux: dict | None = None,
                       dim64: bool = False) -> str:
    """Write arrays in the documented .params layout (V2 magic) — the test
    fixture generator, and the writer of a checkpoint back into the
    reference's layout (no mxnet is needed to produce the files)."""
    entries = ([(f"arg:{k}", v) for k, v in args.items()]
               + [(f"aux:{k}", v) for k, v in (aux or {}).items()])
    out = bytearray()
    out += struct.pack("<QQQ", _LIST_MAGIC, 0, len(entries))
    inv_dtypes = {np.dtype(v): k for k, v in _DTYPES.items()}
    for _, arr in entries:
        arr = np.ascontiguousarray(arr)
        out += struct.pack("<I", 0xF993FAC9)     # V2 magic
        out += struct.pack("<i", 0)              # kDefaultStorage
        out += struct.pack("<I", arr.ndim)
        fmt = "q" if dim64 else "I"
        for d in arr.shape:
            out += struct.pack(f"<{fmt}", d)
        out += struct.pack("<iii", 1, 0, inv_dtypes[arr.dtype])  # cpu 0
        out += arr.tobytes()
    out += struct.pack("<Q", len(entries))
    for name, _ in entries:
        raw = name.encode()
        out += struct.pack("<Q", len(raw)) + raw
    with open(path, "wb") as f:
        f.write(bytes(out))
    return path


# ---------------- EFM-symbol name mapping (efm_symbol.py:22-110) ----------


def _conv(w: np.ndarray) -> np.ndarray:
    """[Cout, Cin, KH, KW] -> [KH, KW, Cin, Cout]"""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))
                                .astype(np.float32))


def map_efm_params(args: dict) -> dict:
    """MXNet EFM-symbol arg arrays -> the flax EFMNet342 ``params`` tree.

    Name inventory (reference efm_symbol.py:81-105 ``multi_gpu`` with the
    99/198/387/261/261 ladder, residual counts [0, 1, 2, 3, 4]):
    conv1; per stage si in 2..5 with L=str(si): res convs
    ``conv{L}{i or ''}_res`` / ``..._res_r`` for block i, the 1x1
    ``conv{L}_r``, the 3x3 ``conv{L}``; then fc1, fc2. MXNet appends
    ``_weight`` / ``_bias``.
    """
    def take(name):
        w = args.get(f"{name}_weight")
        b = args.get(f"{name}_bias")
        if w is None or b is None:
            raise MxParamsError(
                f"missing '{name}_weight'/'{name}_bias' — is this an "
                f"EFM_RES checkpoint? (have: {sorted(args)[:8]}...)")
        return w, b

    params: dict = {}
    w, b = take("conv1")
    params["conv1"] = {"kernel": _conv(w), "bias": b.astype(np.float32)}

    ladder = [(99, 198, 1), (198, 387, 2), (387, 261, 3), (261, 261, 4)]
    for si, (num_r, num, tar) in enumerate(ladder, start=2):
        L = str(si)
        res: dict = {}
        for i in range(tar):
            blk = L if i == 0 else f"{L}{i}"
            wa, ba = take(f"conv{blk}_res")
            wb, bb = take(f"conv{blk}_res_r")
            res[f"conv_a_{i}"] = {"kernel": _conv(wa),
                                  "bias": ba.astype(np.float32)}
            res[f"conv_b_{i}"] = {"kernel": _conv(wb),
                                  "bias": bb.astype(np.float32)}
        params[f"stage{si}_res"] = res
        w, b = take(f"conv{L}_r")
        params[f"stage{si}_conv1x1"] = {"kernel": _conv(w),
                                        "bias": b.astype(np.float32)}
        w, b = take(f"conv{L}")
        params[f"stage{si}_conv"] = {"kernel": _conv(w),
                                     "bias": b.astype(np.float32)}

    # fc1: [513, C*H*W] over the NCHW flatten -> [H*W*C, 513] over NHWC
    w, b = take("fc1")
    c = 174  # 261-filter EFM3 output of stage 5
    if w.shape[1] % c:
        raise MxParamsError(f"fc1 input {w.shape[1]} not divisible by {c}")
    hw = w.shape[1] // c
    side = int(round(hw ** 0.5))
    if side * side != hw:
        raise MxParamsError(f"fc1 spatial {hw} is not square")
    k = w.reshape(513, c, side, side).transpose(2, 3, 1, 0)
    params["fc1"] = {"kernel": np.ascontiguousarray(
        k.reshape(hw * c, 513).astype(np.float32)),
        "bias": b.astype(np.float32)}

    w, b = take("fc2")
    params["fc2"] = {"kernel": np.ascontiguousarray(
        w.T.astype(np.float32)), "bias": b.astype(np.float32)}
    return params


def infer_input_size(args: dict) -> int:
    """Input side length implied by fc1's flatten width (five 2x pools)."""
    hw = args["fc1_weight"].shape[1] // 174
    return int(round(hw ** 0.5)) * 32


def efm_params_to_mxnet(params: dict) -> dict:
    """Inverse of :func:`map_efm_params` (fixture generation + roundtrip
    tests; also lets a facejax-trained EFMNet342 be written back into the
    reference's .params layout)."""
    def conv_inv(k):
        return np.ascontiguousarray(
            np.transpose(np.asarray(k), (3, 2, 0, 1)).astype(np.float32))

    args: dict = {}

    def put(name, node):
        args[f"{name}_weight"] = conv_inv(node["kernel"])
        args[f"{name}_bias"] = np.asarray(node["bias"], np.float32)

    put("conv1", params["conv1"])
    ladder = [(99, 198, 1), (198, 387, 2), (387, 261, 3), (261, 261, 4)]
    for si, (num_r, num, tar) in enumerate(ladder, start=2):
        L = str(si)
        res = params[f"stage{si}_res"]
        for i in range(tar):
            blk = L if i == 0 else f"{L}{i}"
            put(f"conv{blk}_res", res[f"conv_a_{i}"])
            put(f"conv{blk}_res_r", res[f"conv_b_{i}"])
        put(f"conv{L}_r", params[f"stage{si}_conv1x1"])
        put(f"conv{L}", params[f"stage{si}_conv"])

    k = np.asarray(params["fc1"]["kernel"])  # [H*W*C, 513]
    c = 174
    hw = k.shape[0] // c
    side = int(round(hw ** 0.5))
    w = k.reshape(side, side, c, 513).transpose(3, 2, 0, 1)
    args["fc1_weight"] = np.ascontiguousarray(
        w.reshape(513, hw * c).astype(np.float32))
    args["fc1_bias"] = np.asarray(params["fc1"]["bias"], np.float32)
    args["fc2_weight"] = np.ascontiguousarray(
        np.asarray(params["fc2"]["kernel"]).T.astype(np.float32))
    args["fc2_bias"] = np.asarray(params["fc2"]["bias"], np.float32)
    return args


def validate_symbol_json(path: str) -> dict:
    """Cross-check an ``EFM_RES.json`` symbol file against the expected
    EFM-symbol graph: every conv in the name inventory must appear with the
    ladder's num_filter. Returns {conv_name: num_filter}. Raises
    MxParamsError with the first mismatch — catches somebody importing a
    different architecture's checkpoint.
    """
    import json

    with open(path) as f:
        sym = json.load(f)
    convs = {}
    for node in sym.get("nodes", []):
        if node.get("op") == "Convolution":
            attrs = node.get("attrs") or node.get("param") or {}
            convs[node["name"]] = int(str(attrs.get("num_filter", 0)))
    expected = {"conv1": 99}
    ladder = [(99, 198, 1), (198, 387, 2), (387, 261, 3), (261, 261, 4)]
    for si, (num_r, num, tar) in enumerate(ladder, start=2):
        L = str(si)
        for i in range(tar):
            blk = L if i == 0 else f"{L}{i}"
            expected[f"conv{blk}_res"] = num_r
            expected[f"conv{blk}_res_r"] = num_r * 2 // 3
        expected[f"conv{L}_r"] = num_r
        expected[f"conv{L}"] = num
    for name, nf in expected.items():
        if name not in convs:
            raise MxParamsError(
                f"symbol json missing conv '{name}' — not the EFM_RES "
                f"architecture? (has {sorted(convs)[:6]}...)")
        if convs[name] != nf:
            raise MxParamsError(
                f"symbol conv '{name}' has num_filter {convs[name]}, "
                f"expected {nf}")
    return convs


# ------------- gluon LightCNN_29 mapping (reference lightcnn.py:73-133) ----

# conv_net child indices in the gluon HybridSequential (construction order,
# lightcnn.py:79-111): 0 stem efm, 2/5/8/11 res_blocks, 3/6/9/12 type-1
# efms, 15 Dense(1026); fc1.0 BatchNorm; fc2.1 Dense(classes).
_GLUON_GROUPS = [  # (res_idx, efm_idx, group_number)
    (2, 3, 2), (5, 6, 3), (8, 9, 4), (11, 12, 5)]


def is_gluon_lightcnn29(args: dict) -> bool:
    return any(k.startswith("conv_net.") for k in args)


def map_gluon_lightcnn29(args: dict, aux: dict | None = None) -> tuple[
        dict, dict]:
    """Gluon ``save_parameters`` arrays (structural dot names) -> the flax
    ``LightCNN29(gluon_shared_res=True)`` trees (params, batch_stats).

    The gluon res_block REUSES one conv pair across its iterations
    (lightcnn.py:48-49), which is exactly ``gluon_shared_res=True``; the
    BatchNorm feature branch maps gamma/beta -> scale/bias and
    running_mean/var -> batch_stats.
    """
    aux = aux or {}
    merged = dict(args)
    merged.update(aux)  # gluon files may carry running stats either side

    def take(base):
        w = merged.get(f"{base}.weight")
        b = merged.get(f"{base}.bias")
        if w is None or b is None:
            raise MxParamsError(
                f"missing '{base}.weight'/'{base}.bias' — not a gluon "
                f"LightCNN_29 save_parameters file? "
                f"(have: {sorted(merged)[:6]}...)")
        return w, b

    params: dict = {}
    w, b = take("conv_net.0.conv_op_2")
    params["group1"] = {"conv": {"kernel": _conv(w),
                                 "bias": b.astype(np.float32)}}
    for res_i, efm_i, g in _GLUON_GROUPS:
        wa, ba = take(f"conv_net.{res_i}.conv_op_1")
        wb, bb = take(f"conv_net.{res_i}.conv_op_2")
        params[f"group{g}_res"] = {
            "conv_a": {"kernel": _conv(wa), "bias": ba.astype(np.float32)},
            "conv_b": {"kernel": _conv(wb), "bias": bb.astype(np.float32)},
        }
        wp, bp = take(f"conv_net.{efm_i}.conv_op_1")
        wc, bc = take(f"conv_net.{efm_i}.conv_op_2")
        params[f"group{g}_conv"] = {
            "pre_conv": {"kernel": _conv(wp),
                         "bias": bp.astype(np.float32)},
            "conv": {"kernel": _conv(wc), "bias": bc.astype(np.float32)},
        }
    # Dense(1026) over the NCHW flatten -> NHWC flatten permutation
    w, b = take("conv_net.15")
    c = 174  # group5's efm3 output channels (261 * 2 / 3)
    if w.shape[1] % c:
        raise MxParamsError(
            f"conv_net.15 input {w.shape[1]} not divisible by {c}")
    hw = w.shape[1] // c
    side = int(round(hw ** 0.5))
    if side * side != hw:
        raise MxParamsError(f"fc1 spatial {hw} is not square")
    k = w.reshape(1026, c, side, side).transpose(2, 3, 1, 0)
    params["fc1"] = {"kernel": np.ascontiguousarray(
        k.reshape(hw * c, 1026).astype(np.float32)),
        "bias": b.astype(np.float32)}
    # feature-branch BatchNorm
    gamma = merged.get("fc1.0.gamma")
    beta = merged.get("fc1.0.beta")
    mean = merged.get("fc1.0.running_mean")
    var = merged.get("fc1.0.running_var")
    if any(v is None for v in (gamma, beta, mean, var)):
        raise MxParamsError("missing fc1.0 BatchNorm arrays "
                            "(gamma/beta/running_mean/running_var)")
    params["fc1_bn"] = {"scale": gamma.astype(np.float32),
                        "bias": beta.astype(np.float32)}
    batch_stats = {"fc1_bn": {"mean": mean.astype(np.float32),
                              "var": var.astype(np.float32)}}
    w, b = take("fc2.1")
    params["fc2"] = {"kernel": np.ascontiguousarray(
        w.T.astype(np.float32)), "bias": b.astype(np.float32)}
    return params, batch_stats


def gluon_lightcnn29_to_mxnet(params: dict, batch_stats: dict) -> tuple[
        dict, dict]:
    """Inverse of :func:`map_gluon_lightcnn29` (fixtures + write-back)."""
    def conv_inv(node):
        return (np.ascontiguousarray(np.transpose(
            np.asarray(node["kernel"]), (3, 2, 0, 1)).astype(np.float32)),
            np.asarray(node["bias"], np.float32))

    args: dict = {}
    w, b = conv_inv(params["group1"]["conv"])
    args["conv_net.0.conv_op_2.weight"] = w
    args["conv_net.0.conv_op_2.bias"] = b
    for res_i, efm_i, g in _GLUON_GROUPS:
        for src, base in ((params[f"group{g}_res"]["conv_a"],
                           f"conv_net.{res_i}.conv_op_1"),
                          (params[f"group{g}_res"]["conv_b"],
                           f"conv_net.{res_i}.conv_op_2"),
                          (params[f"group{g}_conv"]["pre_conv"],
                           f"conv_net.{efm_i}.conv_op_1"),
                          (params[f"group{g}_conv"]["conv"],
                           f"conv_net.{efm_i}.conv_op_2")):
            w, b = conv_inv(src)
            args[f"{base}.weight"] = w
            args[f"{base}.bias"] = b
    k = np.asarray(params["fc1"]["kernel"])
    c = 174
    hw = k.shape[0] // c
    side = int(round(hw ** 0.5))
    w = k.reshape(side, side, c, 1026).transpose(3, 2, 0, 1)
    args["conv_net.15.weight"] = np.ascontiguousarray(
        w.reshape(1026, hw * c).astype(np.float32))
    args["conv_net.15.bias"] = np.asarray(params["fc1"]["bias"], np.float32)
    args["fc1.0.gamma"] = np.asarray(params["fc1_bn"]["scale"], np.float32)
    args["fc1.0.beta"] = np.asarray(params["fc1_bn"]["bias"], np.float32)
    aux = {"fc1.0.running_mean": np.asarray(
        batch_stats["fc1_bn"]["mean"], np.float32),
        "fc1.0.running_var": np.asarray(
            batch_stats["fc1_bn"]["var"], np.float32)}
    args["fc2.1.weight"] = np.ascontiguousarray(
        np.asarray(params["fc2"]["kernel"]).T.astype(np.float32))
    args["fc2.1.bias"] = np.asarray(params["fc2"]["bias"], np.float32)
    return args, aux


def expand_shared_res(params: dict) -> dict:
    """Replicate each group's shared conv pair into the standard
    ``conv_a_{i}/conv_b_{i}`` tree (num_blocks [1, 2, 3, 4]) — the forward
    is IDENTICAL (sharing only ties gradients), and the expanded tree loads
    into the default ``LightCNN29`` and the native C++ forward unchanged."""
    out = dict(params)
    n_blocks = {2: 1, 3: 2, 4: 3, 5: 4}
    for g, n in n_blocks.items():
        res = params.get(f"group{g}_res", {})
        if "conv_a" not in res:
            continue  # already distinct
        out[f"group{g}_res"] = {}
        for i in range(n):
            out[f"group{g}_res"][f"conv_a_{i}"] = res["conv_a"]
            out[f"group{g}_res"][f"conv_b_{i}"] = res["conv_b"]
    return out
