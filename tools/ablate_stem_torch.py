#!/usr/bin/env python3
"""Where kernel B3 (``csrc/stem.cu``: ``stem_kernel`` in f32 on the CUDA
cores, ``stem_tc_kernel`` in bf16 on the tensor cores) spends its time, on
one GPU: variants of the source with one part removed or changed, each
built with the port's nvcc flags into a temporary directory and swapped
into the port's wrapper, timed in one process in the order base,
variants..., base.

Each run times both instances at both of B3's path shapes
(``chip_smoke.STEM_PATH``: a 16-crop serving dispatch and a LightCNN29
batch, C=99, efm3): the kernel's device ms from a profiler trace and the
wrapper's ms by CUDA events, beside the largest difference from the plain
version (only ``base``, ``parent`` and variants that change no arithmetic
give the kernel's answers). Then a host pass: the host us a call of the
wrapper and of its entry point alone (the ctypes call into preallocated
buffers: what the C++ launcher costs), each call timed on its own, 5
rounds of 200 back-to-back calls a variant, the variants interleaved
round by round; the median a call is printed (the host is shared, so
single calls see other processes' bursts). Variants:

  f32:threads_96     96 threads a CTA for C=99 (the base takes 352)
  f32:no_store       the outputs are not stored
  f32:tile_4x8       tiles of 4 x 8 pooled pixels (528 items at C=99, on
                     176 threads), not 8 x 8
  bf16:no_mma        each pair of wgmma (two k16 steps) replaced by one add
  bf16:no_pipeline   the compiled widths summed one group of 8 channels a
                     wgmma, each waited for before its maxout
  bf16:no_gather     the A fragments made from their addresses, not read
  bf16:no_epilogue   the maxout and pool replaced by one max of the sums
  bf16:min_blocks_3 / min_blocks_5
                     __launch_bounds__ asks for 3 or 5 CTAs an SM, not 4
  bf16:no_copyout    the staged tile's bulk copies to device memory not
                     issued
  bf16:no_build      the B operand not built (its shared memory stays unset)
  f32:runtime_widths / bf16:runtime_widths
                     C=99/efm3 run by the instance that reads its widths
                     at run time, not the one they are compiled into

With no variant named, every variant runs; ``base`` alone runs the base
(and the parent) only. ``--parent SRC`` adds a
variant ``parent`` built from another copy of ``stem.cu`` (for example a
parent commit's, unpacked into ``_parent/``), whose B3 entry points take
the same arguments. Prints one JSON line per run and last the card's name
and power limit.

    python tools/ablate_stem_torch.py [--parent SRC] [f32:variant | bf16:variant ...]
"""

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_WGMMA = """      wgmma_bf16<N>(acc, ai[0], b_desc(bs_addr + c0 * B_SBO), 0);
      wgmma_bf16<N>(acc, ai[1], b_desc(bs_addr + (NT + c0) * B_SBO), 1);
"""

VARIANTS = {
    "base": [],
    "f32:threads_96": [("THREADS = GC ? 352", "THREADS = GC ? 96")],
    "f32:no_store": [("        o[g] = mx;\n", "        if (mx == 12345.f) o[g] = mx;\n"),
                     ("          o[G + g] = fmaxf(",
                      "          if (mx == 12345.f) o[G + g] = fmaxf(")],
    "f32:tile_4x8": [("constexpr int F32_TY = 8;", "constexpr int F32_TY = 4;"),
                     ("THREADS = GC ? 352", "THREADS = GC ? 176")],
    "f32:runtime_widths": [("  if (compiled_width(C, maxout))\n    return launch_f32",
                            "  if (C < 0)\n    return launch_f32")],
    "bf16:no_mma": [(_WGMMA, "      acc[0] = __uint_as_float(ai[0][0] + ai[1][1]);\n")],
    "bf16:no_gather": [("              v[e] = tap_off[ks][h][e] >= 0 ? "
                        "cw[r + tap_off[ks][h][e]]",
                        "              v[e] = tap_off[ks][h][e] >= 0 ? "
                        "(uint32_t)(r + tap_off[ks][h][e])")],
    "bf16:no_epilogue": [
        ("      __nv_bfloat162 mx, mn;\n#pragma unroll\n      for (int dy = 0;",
         "      __nv_bfloat162 mx = __floats2bfloat162_rn(cs[0], "
         "cs[4 * MAXOUT - 1]), mn = mx;\n#pragma unroll\n"
         "      for (int dy = 2;"),
        ("      mx = __hmax2(mx, __shfl_xor_sync(0xffffffffu, mx, 4));\n", "")],
    "bf16:no_pipeline": [("    if constexpr (GC != 0) {\n      // the compiled width: the groups",
                          "    if constexpr (GC < 0) {\n      // the compiled width: the groups")],
    "bf16:no_copyout": [("            bulk_store(o0 + (size_t)r * Wo * Cout, ",
                         "            if (r < 0) bulk_store(o0 + (size_t)r * Wo * Cout, ")],
    "bf16:no_build": [("  for (int i0 = tid; i0 < nwords; i0 += FR * TC_THREADS) {",
                       "  for (int i0 = tid; i0 < 0; i0 += FR * TC_THREADS) {")],
    "bf16:min_blocks_3": [("__launch_bounds__(TC_THREADS, 4)\nstem_tc_kernel(",
                           "__launch_bounds__(TC_THREADS, 3)\nstem_tc_kernel(")],
    "bf16:min_blocks_5": [("__launch_bounds__(TC_THREADS, 4)\nstem_tc_kernel(",
                           "__launch_bounds__(TC_THREADS, 5)\nstem_tc_kernel(")],
    "bf16:runtime_widths": [("  if (compiled_width(C, maxout))\n    return launch_tc",
                             "  if (C < 0)\n    return launch_tc")],
}


def build(names, tmp, parent=None) -> dict:
    """``{variant: (library path, ptxas lines)}``, all nvcc jobs at once."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        _build,
    )

    with open(os.path.join(_build.CSRC, "stem.cu")) as f:
        src = f.read()
    jobs = {}
    for name in names:
        if name == "parent":
            with open(parent) as f:
                text = f.read()
        else:
            text = src
            for old, new in VARIANTS[name]:
                if old not in text:
                    raise RuntimeError(f"{name}: patch does not apply")
                text = text.replace(old, new)
        tag = name.replace(":", "_")
        cu = os.path.join(tmp, f"stem_{tag}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(tmp, f"libstem_{tag}.so")
        cmd = [_build._nvcc(), *_build._COMMON, *_build.FLAGS["stem"], "-o",
               so, cu]
        jobs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT))
    out = {}
    for name, (so, proc) in jobs.items():
        log = proc.communicate()[0].decode()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (so, [ln.strip() for ln in log.splitlines()
                          if "registers" in ln or "spill" in ln])
    return out


def use(so: str) -> None:
    """Swap the library behind the port's stem wrappers."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        _build,
        stem,
    )

    _build._libs["stem"] = ctypes.CDLL(so)
    stem._fns.cache_clear()


def call_us(torch, fn, calls: int = 200) -> list:
    """Host us of each of ``calls`` back-to-back calls of ``fn``."""
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        fn()
        out.append((time.perf_counter_ns() - t0) / 1e3)
    torch.cuda.synchronize()
    return out


def host_pass(torch, libs, names, inputs, rounds: int = 5) -> dict:
    """{variant: {shape_dtype: {"wrapper_us", "launch_us"}}}: the median
    host us a call over ``rounds`` interleaved rounds."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        stem,
    )

    samples = {}
    for _ in range(rounds):
        for name in names:
            use(libs[name][0])
            for shape, (x, w, bias, maxout) in inputs.items():
                for dt, key in ((torch.float32, "f32"),
                                (torch.bfloat16, "bf16")):
                    xd = x.to(dt)
                    s = samples.setdefault(name, {}).setdefault(
                        f"{shape}_{key}", {"wrapper_us": [], "launch_us": []})
                    s["wrapper_us"] += call_us(
                        torch, lambda: stem.stem_conv_maxout_pool(
                            xd, w, bias, maxout=maxout))
                    s["launch_us"] += call_us(
                        torch, launch_only(torch, xd, w, bias, maxout))
    return {name: {k: {m: statistics.median(v) for m, v in d.items()}
                   for k, d in per.items()} for name, per in samples.items()}


def launch_only(torch, x, w, bias, maxout):
    """The entry point of the wrapper's launch, called alone on the
    buffers the wrapper would pass it."""
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        stem,
    )

    _, fns = stem._fns()
    b, h, wd, _ = x.shape
    c = w.shape[3]
    wk = w.to(x.dtype).float().reshape(25, c).contiguous()
    bk = bias.float().contiguous()
    c_out = c // 2 if maxout == 2 else 2 * (c // 3)
    out = torch.empty((b, h // 2, wd // 2, c_out), dtype=x.dtype,
                      device=x.device)
    fn = fns[x.dtype]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), out.data_ptr(), b,
            h, wd, c, maxout, stream)
    return lambda: fn(*args)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("ablate_stem_torch: needs CUDA", file=sys.stderr)
        return 2
    from chip_smoke import (STEM_PATH, full_f32, stem_device_ms, stem_inputs,
                            time_ms)

    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.ops.cuda import (
        stem,
    )

    full_f32()    # the plain version runs cuDNN
    parent = None
    if "--parent" in argv:
        i = argv.index("--parent")
        parent = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    chosen = ([a for a in argv if a != "base"] if argv
              else [n for n in VARIANTS if n != "base"])
    names = ["base", *(["parent"] if parent else []), *chosen]
    gen = torch.Generator().manual_seed(2)
    inputs = {name: stem_inputs(torch, gen, b, h, w, c) + (maxout,)
              for name, (b, h, w, c, maxout) in STEM_PATH.items()}
    want = {(shape, dt): stem.stem_conv_maxout_pool_plain(
                x.to(dt), w, bias, maxout=maxout).float()
            for shape, (x, w, bias, maxout) in inputs.items()
            for dt in (torch.float32, torch.bfloat16)}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build(names, tmp, parent)
        for name in [*names, "base"]:
            so, ptxas = libs[name]
            use(so)
            rec = {"variant": name, "ptxas": ptxas}
            for shape, (x, w, bias, maxout) in inputs.items():
                for dt, key in ((torch.float32, "f32"),
                                (torch.bfloat16, "bf16")):
                    xd = x.to(dt)

                    def call():
                        return stem.stem_conv_maxout_pool(xd, w, bias,
                                                          maxout=maxout)

                    got = call().float()
                    torch.cuda.synchronize()
                    rec[f"{shape}_{key}"] = {
                        "device_ms": stem_device_ms(torch, call)[0],
                        "ms": time_ms(torch, call, 20),
                        "max_abs_err": float((got - want[shape, dt]).abs()
                                             .max())}
            print(json.dumps(rec), flush=True)
        print(json.dumps({"host_us": host_pass(torch, libs, names, inputs)}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
