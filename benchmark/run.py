#!/usr/bin/env python3
"""The benchmark of the PyTorch and CUDA port of the path tracer.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json on one CUDA card, from the root of a
checkout: builds the cell's scene from its configuration, renders its
traffic through the port's Renderer (warm-up frames count as set-up), then
presents frames for `--seconds`, checks frames that the window produced
against the plain reference, and prints one JSON line as the last line of
standard output: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics, the latter
read from a profiled stretch after the window), `device`, with `--trace 1`
`breakdown`, and last `checks`, each compared number with its limit, which
also end standard error. Exits non-zero with no result when there is no
CUDA card, or too few, and when jax, jaxlib, flax or the JAX package were
loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# top-level module names that may not be loaded, compared whole: the port's
# own name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "ilgpu_raytracing_tpu")


def pin_to_one_cpu() -> None:
    """Keep every thread of the run on one CPU, the last the process may
    use. Unpinned, the host's issue of a frame ran 5-15% faster or slower
    from one process to the next; pinned, runs agree more closely. Threads
    started later (PyTorch's, the CUDA driver's) inherit the mask."""
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    pin_to_one_cpu()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch

    from benchmark.harness import cell as cell_mod
    from benchmark.harness import spec

    bench = spec.load_benchmark(root)
    c = spec.cell(bench, args.workload, root)
    need = int(c["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: cell {args.workload} needs {need} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    out = cell_mod.run(c, bench, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in out["check_lines"]:
        print(line, file=sys.stderr)
    print(json.dumps(out["line"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
