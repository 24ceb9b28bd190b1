"""CPU tests of the correctness check: a run of the program at a small
size comes out correct; the control (the reference in bfloat16 in the
program's place) and each fault planted under the timed path come out not
correct; and cells, configurations, metrics and kernel classes added as
files alone are run with no edit.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness import cell, judge, spec
from benchmark.harness import traffic as traffic_mod

ROOT = spec.ROOT
SEED = 2**31 + 77


def small_cell(name: str = "cornell-bench.orbit"):
    """The cell at a size a CPU test holds: a coarse Cornell box, 96x64."""
    bench = spec.load_benchmark()
    c = copy.deepcopy(spec.cell(bench, name))
    c["config"]["render"].update(out_w=96, out_h=64)
    c["config"]["scene"]["params"].update(tess=8, sphere_tess=[12, 18])
    c["traffic"].update(warmup_frames=2)
    return bench, c


def run_small(name: str = "cornell-bench.orbit", seconds: float = 8.0):
    bench, c = small_cell(name)
    return cell.run(c, bench, SEED, seconds, False, "cpu", time.perf_counter(),
                    log=lambda s: None)["line"]


@pytest.mark.parametrize("name", ["cornell-bench.orbit", "cornell-bench.animated"])
def test_program_at_a_small_size_is_correct(name):
    line = run_small(name)
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    for v in line["checks"].values():
        assert v["value"] == 0.0


def _faulty(kind):
    from ilgpu_raytracing_tpu_torch.runtime import renderer

    orig = renderer.render_frame

    def broken(scene, camera, prev_camera, state, *args, **kw):
        if kind == "state_unchanged":
            return state.taa_color, state, {"eff_rays": torch.zeros(())}
        out, new_state, aux = orig(scene, camera, prev_camera, state, *args, **kw)
        if kind == "half_left_out":
            # the second half of the pixels left out, filled with the
            # mean of the rest
            n = out.shape[0] // 2
            ch = judge._channels(out[:n]).float().mean(dim=0).round().long()
            mean = (0xFF << 24) | (ch[0] << 16) | (ch[1] << 8) | ch[2]
            out = torch.cat([out[:n], mean.expand(out.shape[0] - n)])
        elif kind == "answer_altered":
            out = out.clone()
            out[::64] ^= 0x00FF00
        return out, new_state, aux

    return renderer, broken


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
def test_faults_under_the_timed_path_are_not_correct(kind, monkeypatch):
    renderer, broken = _faulty(kind)
    monkeypatch.setattr(renderer, "render_frame", broken)
    line = run_small()
    assert not line["correct"], (kind, line["checks"])


def test_bfloat16_control_is_not_correct():
    """The reference computed in bfloat16 (geometry, rays, colour) in the
    program's place, on the first frame of a Cornell box at its full
    triangle count, 192x128: it fails a limit of the cell."""
    bench = spec.load_benchmark()
    c = spec.cell(bench, "cornell-bench.orbit")
    render = dict(c["config"]["render"], out_w=192, out_h=128)
    scene = spec.scene_generator("cornell").build(c["config"]["scene"]["params"])
    tr = traffic_mod.Traffic(c["traffic"], scene, 192, 128, SEED)
    render["rng_salt"] = tr.rng_salt
    j = judge.Judge(scene, tr, render, 192, 128, c["traffic"]["dt"], "cpu")
    jc = judge.Judge(scene, tr, render, 192, 128, c["traffic"]["dt"], "cpu",
                     round_to=torch.bfloat16)
    want = j.frame(0, 0, j.empty_state())
    got = jc.frame(0, 0, jc.empty_state())
    numbers = judge.compare(got[0], judge.ref_state_tensors(got[1]), *want)
    limits = c["traffic"]["checks"]
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


NEW_METRIC = '''"""frames_presented: frames counted in the window."""


def read(ctx):
    return float(len(ctx.window.done))
'''


def test_new_cell_config_metric_and_kernel_class_are_found_as_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    config = json.load(open(b / "configs" / "cornell-bench.json"))
    config.update(name="tiny-box", triangles=1392)
    config["render"].update(out_w=96, out_h=64)
    config["scene"]["params"].update(tess=8, sphere_tess=[12, 18])
    json.dump(config, open(b / "configs" / "tiny-box.json", "w"))
    traffic = json.load(open(b / "workloads" / "cornell-bench.orbit.json"))
    traffic.update(config="tiny-box", warmup_frames=1)
    json.dump(traffic, open(b / "workloads" / "tiny-box.orbit.json", "w"))
    (b / "metrics" / "frames_presented.py").write_text(NEW_METRIC)
    json.dump({"why": "a new kernel class", "names": ["fused_shade_kernel"]},
              open(b / "kernels" / "shade.json", "w"))
    bench = json.load(open(tmp_path / "BENCHMARK.json"))
    bench["configs"].append({"name": "tiny-box", "source": "https://example.org/box",
                             "file": "benchmark/configs/tiny-box.json", "reduced": [],
                             "why": "a test cell"})
    bench["workloads"].append({"name": "tiny-box.orbit", "config": "tiny-box",
                               "traffic": "orbit", "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "frames_presented", "unit": "frames",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["tiny-box.orbit"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = (
        "import json, sys, time; sys.path[:0] = [%r, %r]\n"
        "from benchmark.harness import cell, spec\n"
        "assert spec.BENCH_DIR == %r\n"
        "bench = spec.load_benchmark()\n"
        "c = spec.cell(bench, 'tiny-box.orbit')\n"
        "out = cell.run(c, bench, 5, 8.0, False, 'cpu', time.perf_counter())\n"
        "print(json.dumps(dict(out['line'], classes=spec.kernel_classes())))\n"
        % (str(tmp_path), ROOT, str(b)))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert "frames_presented" in line["metrics"] and "setup_s" in line["metrics"]
    assert "latency_ms_p95" not in line["metrics"]
    assert line["classes"]["shade"] == ["fused_shade_kernel"]
