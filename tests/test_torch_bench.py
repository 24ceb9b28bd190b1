"""`bench_torch.py`, the port's benchmark entry, on the CPU at 64x36 with a
small Cornell scene and one window of 2 frames: its result has exactly
`bench.py`'s keys and `detail` keys (read from `bench.py` with `ast`),
its ray count is `bench.py`'s formula, and without CUDA the card run
raises rather than fall back to the CPU. The full-size run is
`chip_smoke.py`'s bench_torch phase.
"""

import ast
import json
import os

import pytest
import torch

import bench_torch
from ilgpu_raytracing_tpu_torch.config import RenderConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(tess=2, sphere_tess=(4, 6), blas_leaf_size=8, bvh_method="sah")


@pytest.fixture(scope="module")
def result():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield bench_torch.run(device="cpu", out_w=64, out_h=36, scene_kwargs=SMALL,
                              n_windows=1, win_frames=2)
    finally:
        torch.set_num_threads(n)


def _bench_keys():
    """(keys, detail keys) of the `result` dict in bench.py's main."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "result"
                and isinstance(node.value, ast.Dict)):
            keys = {k.value for k in node.value.keys}
            detail = node.value.values[[k.value for k in node.value.keys].index("detail")]
            return keys, {k.value for k in detail.keys}
    raise AssertionError("bench.py has no result dict")


def test_result_has_bench_keys(result):
    keys, detail_keys = _bench_keys()
    assert "vs_baseline_effective" in keys and "rays_effective_per_frame" in detail_keys
    assert set(result) == keys
    assert set(result["detail"]) == detail_keys


def test_result_values(result):
    cfg = RenderConfig(spp=2, max_depth=3)
    in_w, in_h = cfg.internal_resolution(64, 36)
    det = result["detail"]
    assert result["metric"] == "mrays_per_sec_1080p_cornell_path_trace"
    assert result["unit"] == "Mrays/s/chip"
    assert det["internal_res"] == [in_w, in_h]
    assert det["rays_dispatched_per_frame"] == in_w * in_h * (1 + cfg.spp * cfg.max_depth * 2)
    assert (det["spp"], det["max_depth"], det["frames"]) == (2, 3, 2)
    assert len(det["window_s"]) == 1 and det["window_s"][0] > 0
    assert 0 < det["rays_effective_per_frame"] <= det["rays_dispatched_per_frame"]
    assert det["tris"] > 0 and det["device"] == "cpu"
    assert result["value"] > 0
    assert abs(result["vs_baseline"] - result["value"] / 200.0) < 1e-4


def test_main_prints_one_json_line(result, monkeypatch, capsys):
    monkeypatch.setattr(bench_torch, "run", lambda: result)
    bench_torch.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result


def test_card_run_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card run is chip_smoke.py's")
    with pytest.raises((RuntimeError, AssertionError)):
        bench_torch.run(scene_kwargs=SMALL, n_windows=1, win_frames=1)
