"""Where the benchmark's data lives and how it is found by name.

`BENCHMARK.json` sits at the root of the checkout, the benchmark's files
under `benchmark/`. A cell names a configuration and a traffic mix; each
lives in a file of its own (`configs/<config>.json`,
`workloads/<cell>.json`), a per-layer or end-to-end metric is read by
`metrics/<metric>.py`, a class of hand-written kernels is
`kernels/<class>.json`, and a scene generator is `scenes/<kind>.py`. A
later change adds a cell, a configuration, a metric or a kernel class by
adding such files; nothing here lists them.
"""

from __future__ import annotations

import glob
import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str, root: str = ROOT) -> dict:
    """The cell `name`: its BENCHMARK.json entry, its traffic parameters
    (`workloads/<name>.json`) and its configuration (the file the
    configuration's entry names)."""
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = _json(os.path.join(root, "benchmark", "workloads", name + ".json"))
    if traffic["config"] != entry["config"]:
        raise ValueError(f"workloads/{name}.json names config {traffic['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    return dict(name=name, entry=entry, config=config, traffic=traffic)


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones with
    `--trace 0`, the per-layer ones with `--trace 1`; a metric with a
    `workloads` list only in those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """`metrics/<name>.py`, loaded by path; its `read(ctx)` returns the
    metric's value or None when the run has nothing to read."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_classes(bench_dir: str = BENCH_DIR) -> dict[str, list[str]]:
    """{class: kernel function names} from every `kernels/<class>.json`."""
    out = {}
    for path in sorted(glob.glob(os.path.join(bench_dir, "kernels", "*.json"))):
        out[os.path.splitext(os.path.basename(path))[0]] = list(_json(path)["names"])
    return out


def scene_generator(kind: str):
    """`scenes/<kind>.py`, whose `build(params)` returns a scene spec."""
    return importlib.import_module(f"benchmark.scenes.{kind}")
