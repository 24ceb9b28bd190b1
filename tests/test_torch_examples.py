"""The port's example drivers (`examples/torch_*.py`) run in-process on the
CPU at 32x32-class sizes with small scenes: each `main(argv)` returns 0
and writes PNGs of the asked size that are not one colour;
`torch_large_mesh` reports its kernel-scene route; `torch_parity_check`
prints one JSON line with `parity_check.py`'s fields (read with `ast`)
within the noise floor; `torch_fly` without a display returns 1 with the
JAX script's message. The drivers run on the card through
`chip_smoke.py`'s examples phase.
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _main(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _assert_png(path, w, h):
    img = np.asarray(Image.open(path).convert("RGB"))
    assert img.shape == (h, w, 3)
    assert len(np.unique(img.reshape(-1, 3), axis=0)) > 1, f"{path} is one colour"


def test_render_default(tmp_path, capsys):
    out = str(tmp_path / "default.png")
    assert _main("torch_render_default")(
        ["--cpu", "--width", "32", "--height", "32", "--frames", "2", "--out", out]) == 0
    _assert_png(out, 32, 32)
    text = capsys.readouterr().out
    assert "frame 1:" in text and "kernels=True" in text


@pytest.mark.parametrize("bvh", ["sah", "median", "lbvh"])
def test_render_cornell(tmp_path, capsys, bvh):
    out = str(tmp_path / "cornell.png")
    assert _main("torch_render_cornell")(
        ["--device", "cpu", "--width", "32", "--height", "24", "--frames", "1",
         "--tess", "4", "--bvh", bvh, "--out", out]) == 0
    _assert_png(out, 32, 24)
    assert f"(bvh={bvh})" in capsys.readouterr().out


def test_animate(tmp_path):
    outdir = tmp_path / "anim"
    assert _main("torch_animate")(
        ["--cpu", "--width", "32", "--height", "24", "--frames", "2",
         "--outdir", str(outdir)]) == 0
    frames = [np.asarray(Image.open(outdir / f"frame_{f:03d}.png")) for f in range(2)]
    for f in range(2):
        _assert_png(str(outdir / f"frame_{f:03d}.png"), 32, 24)
    assert not np.array_equal(*frames), "the camera orbits and the sphere moves"


def test_large_mesh(tmp_path, capsys):
    """A 16x8 grid (256 triangles, leaf 8: the wide tables on the CPU; the
    chip run takes the StreamScene route at 262,144 triangles)."""
    out = str(tmp_path / "terrain.png")
    assert _main("torch_large_mesh")(
        ["--cpu", "--width", "32", "--height", "18", "--frames", "1", "--grid-x", "16",
         "--grid-z", "8", "--leaf", "8", "--max-depth", "2", "--out", out]) == 0
    _assert_png(out, 32, 18)
    text = capsys.readouterr().out
    assert "scene: 256 tris" in text and "tracer: WideScene" in text


def test_sponza_like(tmp_path, capsys):
    out = str(tmp_path / "sponza.png")
    assert _main("torch_sponza_like")(
        ["--cpu", "--width", "32", "--height", "18", "--frames", "1", "--out", out]) == 0
    _assert_png(out, 32, 18)
    assert "alpha=True" in capsys.readouterr().out


def _parity_keys():
    """The keys of the dict that parity_check.py prints."""
    with open(os.path.join(EXAMPLES, "parity_check.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("parity_check.py prints no dict")


def test_parity_check(capsys):
    assert _main("torch_parity_check")(["--device", "cpu", "--size", "16",
                                        "--seeds", "2"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == _parity_keys()
    assert res["metric"] == "rmse_cpu_vs_device_config1"
    assert (res["size"], res["spp"], res["depth"], res["seeds"]) == (16, 1, 1, 2)
    # both sides are the plain versions on the CPU here: equal means
    assert res["rmse_of_means"] == 0.0 and res["within_noise_floor"] is True
    assert res["noise_floor"] > 0.0 and res["signal_rms"] > 0.0


def test_fly_without_display(monkeypatch, capsys):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert _main("torch_fly")(["--cpu"]) == 1
    assert capsys.readouterr().out.strip() == (
        "no display available (set DISPLAY or use X forwarding)")
