#!/usr/bin/env python3
"""Readings that set a cell's check limits, on the card, in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--modes program,control,half,alter,stale] [--steps N]

For each mode and seed it builds the cell as a run does, drives ``--steps``
units of work through the timed path (at least as many as the check
needs), frees it and runs the check, printing one JSON line of the numbers
compared. ``program`` is the sound
program; ``control`` puts the plain reference, computed in TF32, in the
program's place; ``half``, ``alter`` and ``stale`` break the timed path
(half of each batch left out, an answer altered where it is produced, a
step that returns its state unchanged), and ``half_gallery`` has the
serving match scan half of the gallery. The benchmark's runs never run
this tool.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,control")
    p.add_argument("--steps", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from perfbench.core import cell

    bench = cell.manifest()
    _, traffic, cfg = cell.cell_files(args.workload, bench)
    drv_cls = cell.driver(traffic["kind"])
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            drv = drv_cls(cfg, traffic, seed, args.device,
                          fault=None if mode == "program" else mode)
            drv.setup()
            for _ in range(max(args.steps, drv.check_steps())):
                drv.step()
            drv.close()
            checks = drv.check()
            print(json.dumps({"workload": args.workload, "mode": mode,
                              "seed": seed, "seconds": time.perf_counter() - t0,
                              **{k: v["value"] for k, v in checks.items()},
                              **getattr(drv, "detail", {})}),
                  flush=True)
            del drv
            if args.device != "cpu":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
