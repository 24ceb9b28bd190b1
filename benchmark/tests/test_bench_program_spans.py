"""CPU tests of the readers of the program's own spans
(`harness/program_spans.py` and the five metrics on it): worked answers on a
snapshot made by hand, None where the records cannot be trusted, and a
small refit-and-render loop of the program on the CPU.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import copy
import sys
import types

import pytest
import torch

from benchmark.harness import loop as loop_mod
from benchmark.harness import program_spans, spec
from benchmark.harness import traffic as traffic_mod
from benchmark.harness.program import Program
from benchmark.metrics import (
    glue_host_ms,
    kernel_call_host_ms,
    refit_host_ms,
    table_prep_host_ms,
    trace_lane_use_pct,
)

READERS = (glue_host_ms, kernel_call_host_ms, refit_host_ms, table_prep_host_ms)
MS = 1_000_000  # ns


def _frame(ids, frame, t0, kernels=(), refit=None, prep=None):
    """Records of one frame starting at t0 ms: an optional refit and
    set_scene before it, then the frame span of 10 ms holding `kernels`
    ((name, lanes, ms) each, one after the other from t0 + 1)."""
    out = []
    if refit is not None:
        out.append((next(ids), -1, "refit", frame, (t0 - 5) * MS, (t0 - 5 + refit) * MS, None))
    if prep is not None:
        out.append((next(ids), -1, "set_scene", frame, (t0 - 3) * MS, (t0 - 3 + prep) * MS,
                    None))
    fid = next(ids)
    t = t0 + 1
    for name, lanes, dur in kernels:
        out.append((next(ids), fid, "kernel", frame, t * MS, (t + dur) * MS,
                    {"name": name, "lanes": lanes}))
        t += dur
    out.append((fid, -1, "frame", frame, t0 * MS, (t0 + 10) * MS, None))
    return out


def _hand_snapshot():
    """Frames 0-4 issued at 100, 120, ..., 180 ms: 0-2 in the window
    (t0 = 0.095 s, copies ending at 0.125 and 0.145 s), 3 the frame issued
    after its last counted copy, 4 the profiled frame."""
    ids = iter(range(1000))
    # an earlier Renderer's frame 1, before the window
    recs = [(next(ids), -1, "kernel", 1, 10 * MS, 15 * MS, {"name": "wide_closest",
                                                           "lanes": 7})]
    kernels = [("wide_closest", 100, 2), ("sortpos", 100, 1), ("wide_shadow", 50, 3)]
    for f in range(5):
        recs += _frame(ids, f, 100 + 20 * f, kernels, refit=1 + f, prep=2)
    recs.append((next(ids), -1, "kernel", 4, 181 * MS, 182 * MS,
                 {"name": "stream_shadow", "lanes": 400}))  # outside its frame span
    snap = {"records": recs, "written": len(recs), "capacity": 1 << 16, "counters": {}}
    window = types.SimpleNamespace(t0=0.095, done=[(0, 0.1, 0.125), (1, 0.12, 0.145)])
    ctx = types.SimpleNamespace(window=window, profile=types.SimpleNamespace(frames=1),
                                live_lanes=(120, 30))
    return snap, ctx


@pytest.fixture
def hand(monkeypatch):
    snap, ctx = _hand_snapshot()
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    return snap, ctx


def test_readers_on_a_snapshot_worked_by_hand(hand):
    _, ctx = hand
    f = program_spans.window_frames(ctx)
    assert f.ids == {0, 1, 2}
    # each frame 10 ms, 6 of them inside kernels; refits 1, 2, 3 ms; set_scene 2 ms
    assert glue_host_ms.read(ctx) == pytest.approx(4.0)
    assert kernel_call_host_ms.read(ctx) == pytest.approx(6.0)
    assert refit_host_ms.read(ctx) == pytest.approx(2.0)
    assert table_prep_host_ms.read(ctx) == pytest.approx(2.0)
    # the profiled frame 4: 150 live lanes over 100 + 50 + 400 dispatched,
    # K3's 100 keys left out
    assert program_spans.profiled_frames(ctx).ids == {4}
    assert trace_lane_use_pct.read(ctx) == pytest.approx(100.0 * 150 / 550)


def test_readers_give_none_without_trustworthy_records(hand, monkeypatch):
    snap, ctx = hand
    # the frame count disagrees with the window's
    short = types.SimpleNamespace(**dict(vars(ctx), window=types.SimpleNamespace(
        t0=ctx.window.t0, done=ctx.window.done[:1] + [(1, 0.12, 0.165)])))
    assert all(m.read(short) is None for m in READERS)
    # the ring dropped records of the window: its oldest ends after t0
    wrapped = dict(snap, records=snap["records"][3:], written=len(snap["records"]) + 5,
                   capacity=len(snap["records"]) - 3)
    monkeypatch.setattr(program_spans, "snapshot", lambda: wrapped)
    assert all(m.read(ctx) is None for m in READERS)
    # ... but not of the profiled frame
    assert trace_lane_use_pct.read(ctx) == pytest.approx(100.0 * 150 / 550)
    # a program that records nothing (no telemetry module)
    monkeypatch.setattr(program_spans, "snapshot", lambda: None)
    assert all(m.read(ctx) is None for m in READERS + (trace_lane_use_pct,))


def test_snapshot_is_none_where_the_program_has_no_telemetry(monkeypatch):
    from ilgpu_raytracing_tpu_torch import utils

    monkeypatch.delattr(utils, "telemetry", raising=False)
    monkeypatch.setitem(sys.modules, "ilgpu_raytracing_tpu_torch.utils.telemetry", None)
    assert program_spans.snapshot() is None


def test_readers_on_a_small_refit_and_render_loop():
    """The animated cell at 96x64, spp 1, 2 bounces, on the CPU: the readers
    find the window's frames, their spans lie inside the harness's own, and
    the lanes of the kernel spans equal the program's lane counter."""
    from ilgpu_raytracing_tpu_torch.utils import telemetry

    bench = spec.load_benchmark()
    c = copy.deepcopy(spec.cell(bench, "cornell-bench.animated"))
    config, params = c["config"], c["traffic"]
    render = dict(config["render"], **params.get("render", {}), out_w=96, out_h=64, spp=1,
                  max_depth=2)
    config["scene"]["params"].update(tess=8, sphere_tess=[12, 18])
    scene = spec.scene_generator(config["scene"]["kind"]).build(config["scene"]["params"])
    traffic = traffic_mod.Traffic(params, scene, 96, 64, 2**31 + 5)
    render["rng_salt"] = traffic.rng_salt
    with torch.inference_mode():
        prog = Program(scene, config["scene"]["build"], render, 96, 64, traffic.pose(0),
                       "cpu")
        loop = loop_mod.Loop(prog, traffic, float(params["dt"]), 1,
                             traffic_mod.seed_rng(5, 1))
        loop.warm_up(1)
        window = loop.window(4.0)
        loop.drain()
        lanes0 = dict(telemetry.LANES)
        for _ in range(2):
            loop.step()
        loop.drain()
    lanes = {k: v - lanes0.get(k, 0) for k, v in telemetry.LANES.items()}
    ctx = types.SimpleNamespace(window=window, profile=types.SimpleNamespace(frames=2),
                                live_lanes=(1000, 500))

    f = program_spans.window_frames(ctx)
    assert f is not None and f.n == len(window.done) + 1 >= 2
    got = {m.__name__.rsplit(".", 1)[1]: m.read(ctx) for m in READERS}
    assert all(v is not None and v > 0 for v in got.values()), got
    # frame spans lie inside the harness's render() spans, which count one
    # frame more; refit and set_scene inside its scene-update spans
    per = lambda name: sum(window.spans[name])
    assert (got["glue_host_ms"] + got["kernel_call_host_ms"]) * f.n <= 1e3 * per("render")
    assert (got["refit_host_ms"] + got["table_prep_host_ms"]) * f.n \
        <= 1e3 * per("scene_update")
    traced = sum(v for k, v in lanes.items() if k != "sortpos")
    assert traced > 0
    assert trace_lane_use_pct.read(ctx) == pytest.approx(100.0 * 1500 / traced)
