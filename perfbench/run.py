#!/usr/bin/env python3
"""Run one cell of the program's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's weights and inputs from the seed on the card, warms up
the shapes the cell uses, measures for ``--seconds`` and, with
``--trace 1``, then profiles a short stretch for the per-layer metrics.
After the window it frees the program's state, holds what the timed path
produced to the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device`` (with ``--trace 1`` also ``breakdown``) and ``checks``, each
number compared beside its limit, which also close standard error. Exits
non-zero with no result without a CUDA card (or fewer than the cell asks
for), outside a checkout of the repository, or when a JAX module was
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench.core import cell

    if not os.path.exists(os.path.join(ROOT, "BENCHMARK.json")):
        print("run.py: no BENCHMARK.json beside perfbench/", file=sys.stderr)
        return 2
    bench = cell.manifest()
    entry, traffic, cfg = cell.cell_files(args.workload, bench)
    import torch

    if not torch.cuda.is_available():
        print("run.py: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"run.py: the cell needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = cell.run_cell(args.workload, traffic, cfg, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace),
                        device="cuda", t_start=T_START, bench=bench)
    bad = cell.loaded_forbidden(sys.modules)
    if bad:
        print(f"run.py: JAX modules were loaded: {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
