#!/usr/bin/env python3
"""Readings for the limits of the correctness check, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--seconds 5] [--out chiprun_out/calibrate.jsonl]

For each seed, one run of the cell as the benchmark makes it (a window of
`--seconds`), in one process: its judged frames' numbers, one JSON line
per frame. For each control seed the run also puts the control in the
program's place: the reference itself with the geometry, every ray and the
colour rounded to bfloat16 (the precision below the configuration's
float32), its own chain through the warm-up frames and the program's
start states for the window's frames. The lower reading of a number is
the largest program reading, the upper the smallest control reading.
"""

import argparse
import json
import os
import sys
import time

import torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from benchmark.harness import cell, judge, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark(root)
    c = spec.cell(bench, args.workload, root)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        got = cell.run(c, bench, seed, args.seconds, False, "cuda", t0,
                       control=torch.bfloat16 if seed in controls else None)
        for r in got["rows"]:
            for side in ("program", "control"):
                if side not in r:
                    continue
                row = dict(cell=args.workload, seed=seed, k=r["k"], side=side,
                           **judge.numbers(r, side), seconds=time.perf_counter() - t0)
                print(json.dumps(row), flush=True)
                if out:
                    out.write(json.dumps(row) + "\n")
                    out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
