"""CPU tests of the benchmark harness: its files load, new cells,
configurations, metrics and kernel classes are found as files alone, the
import rules hold, the byte floor and the trace arithmetic give worked
answers, and a run without a CUDA card fails.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import glob
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from benchmark.harness import spec, trace
from benchmark.metrics import trace_roofline

ROOT = spec.ROOT
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "ilgpu_raytracing_tpu"}


def test_every_cell_config_metric_and_kernel_file_loads():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        c = spec.cell(bench, w["name"])
        assert c["config"]["name"] == w["config"]
        for key in ("camera", "dt", "warmup_frames", "profile_frames", "judge_frames",
                    "checks"):
            assert key in c["traffic"], (w["name"], key)
        assert spec.scene_generator(c["config"]["scene"]["kind"]).build
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read), m["name"]
    classes = spec.kernel_classes()
    assert {"trace", "sort"} <= set(classes)
    assert "trace_kernel" in classes["trace"] and "rank_kernel" in classes["sort"]


def test_scene_files_match_their_configs():
    bench = spec.load_benchmark()
    for entry in bench["configs"]:
        config = json.load(open(os.path.join(ROOT, entry["file"])))
        assert config["name"] == entry["name"] and config["source"] == entry["source"]
        assert config["reduced"] == entry["reduced"]
        s = spec.scene_generator(config["scene"]["kind"]).build(config["scene"]["params"])
        assert s["mesh"]["tris"].shape[0] == config["triangles"], entry["name"]


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        names = _imports(path)
        assert not (names & (FORBIDDEN | {"ilgpu_raytracing_tpu_torch"})), path
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.frame, "
            "benchmark.reference.accel; bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'ilgpu_raytracing_tpu', 'ilgpu_raytracing_tpu_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)" % ROOT)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_byte_floor_by_hand():
    # 1,000 closest-hit and 500 any-hit live lanes over 2 frames of 10
    # triangles: 36,000 + 14,500 + 2 * 360
    assert trace_roofline.frames_bytes(1000, 500, 10, 2) == 51_220
    # no live lanes: the triangles alone
    assert trace_roofline.frames_bytes(0, 0, 15552, 1) == 559_872


def test_roofline_share_from_a_profile():
    prof = types.SimpleNamespace(frames=2, kernels=lambda: [
        ("trace_kernel", "void trace_kernel<A>(float const*)", 2000.0),
        ("elementwise", "void at::elementwise(...)", 5000.0)])
    ctx = types.SimpleNamespace(profile=prof, kernel_classes={"trace": ["trace_kernel"]},
                                live_lanes=(4_000_000, 3_000_000), n_tris=15552)
    floor_ms = (4_000_000 * 36 + 3_000_000 * 29 + 2 * 15552 * 36) / 2 / 3.35e12 * 1e3
    assert trace_roofline.read(ctx) == pytest.approx(100.0 * floor_ms / 1.0)
    # without the reference's lane counts there is nothing to read
    assert trace_roofline.read(types.SimpleNamespace(**dict(vars(ctx), live_lanes=None))) is None


def test_reference_counts_live_lanes():
    """The reference's tracer counts the lanes each query keeps live."""
    from benchmark.reference import frame as ref

    scene = spec.scene_generator("cornell").build({"tess": 2, "sphere_tess": [4, 6]})
    tr = ref.Tracer(ref.make_scene(scene, "cpu"))
    o = torch.zeros((5, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 5)
    tr.closest(o, d)
    tr.closest(o, d, active=torch.tensor([True, False, True, False, False]))
    tr.occluded(o, d, active=torch.tensor([True, True, True, False, True]))
    assert (tr.closest_lanes, tr.anyhit_lanes) == (7, 4)


def test_interval_union_and_gaps_by_hand():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7)]
    assert trace.union_length(iv) == 4.0
    assert trace.idle_gaps(iv, 0.0, 10.0) == [(3.0, 5.0), (6.0, 10.0)]
    assert trace.idle_gaps(iv, 1.5, 5.2) == [(3.0, 5.0)]
    assert trace.union_length([]) == 0.0


def test_profile_busy_is_the_union_not_the_sum():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "void a<int>(int)", "ts": 10, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 20, "dur": 30},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 90, "dur": 5},
          {"ph": "X", "cat": "user_annotation", "name": "render", "ts": 0, "dur": 60},
          {"ph": "X", "cat": "cpu_op", "name": "aten::nonzero", "ts": 45, "dur": 30}]
    p = trace.Profile(ev, frames=1)
    assert p.busy_us() == 45.0
    assert p.window_us == 100.0
    b = p.breakdown()
    assert b["device_ops"][0] == ["void a<int>(int)", pytest.approx(30e-6)]
    # gaps (0, 10), (50, 90), (95, 100): the longest began inside `render`
    # while the host ran aten::nonzero
    assert b["idle_gaps"] == [["render/aten::nonzero", pytest.approx(40e-6)],
                              ["render", pytest.approx(10e-6)],
                              ["other", pytest.approx(5e-6)]]


@pytest.mark.parametrize("name, base", [
    ("void trace_kernel<WideReader, false>(float const*, int)", "trace_kernel"),
    ("void (anonymous namespace)::rank_kernel(int const*, int)", "rank_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::X>(int, X)",
     "vectorized_elementwise_kernel"),
    ("hist_kernel", "hist_kernel"),
])
def test_kernel_base_name(name, base):
    assert trace.kernel_base_name(name) == base


def test_run_without_a_card_exits_nonzero():
    proc = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                           "cornell-bench.orbit", "--seed", "2147483999", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                          timeout=300)
    if proc.returncode == 0:
        pytest.skip("this machine has a CUDA card")
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_from_the_benchmark_files_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "cornell-bench.orbit", "--seed", "7", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                          timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
