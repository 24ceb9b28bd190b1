"""BASELINE config 2 as the benchmark runs it: the final sphere scene of
*Ray Tracing in One Weekend* (`benchmark/configs/oneweekend-16spp.json`)
under the cell `oneweekend-16spp.orbit`. The committed files resolve to
the configuration's settings; the port, driven through the benchmark's
harness at those settings with only the output size and the sphere grid
cut, matches the plain reference and is judged correct; a fault planted in
the program's spheres alone is judged not correct.

    python -m pytest tests/test_torch_oneweekend.py -q
"""

from __future__ import annotations

import copy
import time

import pytest

from benchmark.harness import cell, program, spec
from benchmark.scenes import oneweekend

CELL = "oneweekend-16spp.orbit"
SEED = 2**31 + 2417


def _committed() -> dict:
    return spec.cell(spec.load_benchmark(), CELL)


def test_committed_cell_is_baseline_config_2():
    c = _committed()
    config, render = c["config"], c["config"]["render"]
    assert c["entry"]["chips"] == 1 and c["entry"]["traffic"] == "orbit"
    assert config["scene"]["kind"] == "oneweekend"
    assert config["scene"]["params"]["grid"] == 11 and config["reduced"] == []
    assert (render["spp"], render["max_depth"]) == (16, 4)
    assert (render["out_w"], render["out_h"], render["render_scale"]) == (1920, 1080, 0.67)
    assert render["enable_temporal_reuse"] and render["enable_spatial_reuse"]
    assert render["enable_taau"] and not render["progressive_accumulation"]
    s = oneweekend.build(config["scene"]["params"])
    assert len(s["mesh"]["tris"]) == config["triangles"] == 0
    assert 400 <= len(s["spheres"]) <= 520 and len(s["spheres"]) == config["spheres"]
    assert c["traffic"]["camera"]["fov_deg"] == 20.0
    assert set(c["traffic"]["checks"].values()) == {0.5}


def _small() -> dict:
    """The committed cell with the output cut to 64x36 (43x24 traced: a
    plain CPU frame at 16 spp takes about half a second, so a window of
    3 s presents frames to judge) and the book's grid to 3 (about 40
    spheres); every other setting, the camera path and the limits are the
    committed files'."""
    c = copy.deepcopy(_committed())
    c["config"]["render"].update(out_w=64, out_h=36)
    c["config"]["scene"]["params"]["grid"] = 3
    return c


def _run(seconds: float) -> dict:
    return cell.run(_small(), spec.load_benchmark(), SEED, seconds, False, "cpu",
                    time.perf_counter(), log=lambda s: None)["line"]


def test_port_matches_the_reference_at_the_cells_settings():
    line = _run(3.0)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    for v in line["checks"].values():
        assert v["value"] is not None and v["value"] <= 0.5


def _glass_ior(s: dict) -> None:
    for sp in s["spheres"]:
        if sp["shading"] == oneweekend.GLASS:
            sp["ior"] = 1.33


def _big_radius(s: dict) -> None:
    for sp in s["spheres"][-3:]:
        sp["radius"] *= 0.97


@pytest.mark.parametrize("fault", [_glass_ior, _big_radius], ids=["glass_ior", "radius"])
def test_a_fault_in_the_programs_spheres_is_not_correct(fault, monkeypatch):
    """The program's scene alone gets other glass (water's ior for
    glass's) or radius-1 spheres 3% smaller; the reference keeps the
    committed scene. A short window: the warm-up chain, judged whatever
    the window holds, already fails a limit."""
    build = program.build_scene

    def faulty(s, b, device):
        s = copy.deepcopy(s)
        fault(s)
        return build(s, b, device)

    monkeypatch.setattr(program, "build_scene", faulty)
    line = _run(1.0)
    assert not line["correct"], line["checks"]
    assert any(v["value"] is not None and v["value"] > v["limit"]
               for v in line["checks"].values()), line["checks"]
