"""The port's spans and counters (utils/telemetry.py) on a tiny CPU frame:
where the spans sit, what the lane counter counts, the spans in a
profiler's trace, a frame unchanged by the profiler, the ring's bound, and
the kernel modules' counters held by the one registry."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene
from ilgpu_raytracing_tpu_torch.models.scene import refit_mesh_instance
from ilgpu_raytracing_tpu_torch.ops.cuda import binary, restir, shade, sortkey, sortpos, stream
from ilgpu_raytracing_tpu_torch.ops.cuda import bounce, streamtreelet, treelet, wide
from ilgpu_raytracing_tpu_torch.parallel import sharding
from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer
from ilgpu_raytracing_tpu_torch.utils import telemetry

BOUNCE = {0: {"restir", "shadow", "trace", "shade"}, 1: {"restir", "shadow", "trace"}}


def _renderer(w=32, h=18, max_depth=2, tess=2, sphere_tess=(4, 4)):
    b, s = build_cornell_scene(tess=tess, sphere_tess=sphere_tess, device="cpu")
    return b, Renderer(w, h, RenderConfig(spp=1, max_depth=max_depth), s, device="cpu")


def _refit_and_render(b, r):
    with torch.inference_mode():
        r.set_scene(refit_mesh_instance(b, r.scene, 0, _moved(b)))
        return r.render()


def _moved(b):
    inst = b.instances[0]
    pos = b.positions[inst.vertex_first: inst.vertex_first + inst.vertex_count].copy()
    pos[:, 1] += np.float32(0.01)
    return pos


def _records_since(n0: int) -> list:
    recs = telemetry.REGISTRY.records()
    return recs[len(recs) - (telemetry.REGISTRY.written - n0):]


@pytest.fixture(scope="module")
def frame():
    """One refit, set_scene and frame on the CPU, the lanes each kernel
    wrapper was handed counted by wrapping it, and the records they left."""
    b, r = _renderer()
    seen = {}

    def counting(name, fn, arg=1):
        def call(*args, **kw):
            seen[name] = seen.get(name, 0) + args[arg].shape[0]
            return fn(*args, **kw)
        return call

    patches = [(wide, "trace_closest_wide_packed", "wide_closest", 1),
               (wide, "shadow_occlusion_wide", "wide_shadow", 1),
               (sortpos, "counting_pos", "sortpos", 0)]
    originals = [getattr(m, f) for m, f, _, _ in patches]
    lanes0 = dict(telemetry.LANES)
    n0 = telemetry.REGISTRY.written
    try:
        for (m, f, name, arg), fn in zip(patches, originals):
            setattr(m, f, counting(name, fn, arg))
        packed = _refit_and_render(b, r)
    finally:
        for (m, f, _, _), fn in zip(patches, originals):
            setattr(m, f, fn)
    lanes = {k: v - lanes0.get(k, 0) for k, v in telemetry.LANES.items()
             if v != lanes0.get(k, 0)}
    return dict(r=r, records=_records_since(n0), seen=seen, lanes=lanes, packed=packed)


def test_spans_nest_under_the_frame_and_the_scene_update(frame):
    recs = frame["records"]
    by_id = {x[0]: x for x in recs}
    parent = lambda x: by_id[x[1]][2] if x[1] in by_id else None
    roots = [x for x in recs if x[1] not in by_id]
    assert [x[2] for x in roots] == ["refit", "set_scene", "frame"]
    # the scene update is stamped with the frame it prepares
    assert {x[3] for x in recs} == {frame["r"].frame - 1}
    kids = lambda name: [x[2] for x in recs if parent(x) == name]
    assert kids("refit") == ["readback", "refit_bvh", "tlas", "upload"]
    # a refit of the prepared topology: the wide tables rebuilt, no host prep
    assert kids("set_scene") == ["to_device", "refit_tables"]
    assert all(x[6]["bytes"] > 0 for x in recs if x[2] in ("readback", "upload"))
    assert kids("frame") == ["primary", "sun_shadow", "bounce", "bounce", "fold", "display",
                             "taau"]
    bounces = [x for x in recs if x[2] == "bounce"]
    assert [x[6] for x in bounces] == [{"depth": 0}, {"depth": 1}]
    for b in bounces:
        assert {x[2] for x in recs if x[1] == b[0]} == BOUNCE[b[6]["depth"]]
    # sorted bounce traces: key, K3, permutation and the kernel inside `sort`
    assert all(parent(x) in ("primary", "sun_shadow", "sort") for x in recs
               if x[2] == "kernel")
    assert {x[6]["name"] for x in recs if x[2] == "kernel"} == {
        "wide_closest", "wide_shadow", "sortpos"}


def test_children_fit_inside_their_parents(frame):
    recs = frame["records"]
    by_id = {x[0]: x for x in recs}
    inside = {}
    for x in recs:
        assert x[4] <= x[5]
        if x[1] in by_id:
            p = by_id[x[1]]
            assert p[4] <= x[4] and x[5] <= p[5], (x, p)
            inside[p[0]] = inside.get(p[0], 0) + x[5] - x[4]
    for pid, t in inside.items():
        assert t <= by_id[pid][5] - by_id[pid][4]


def test_lane_counter_equals_the_wrappers_rays(frame):
    assert frame["lanes"] == frame["seen"]
    spans = {}
    for x in frame["records"]:
        if x[2] == "kernel":
            spans[x[6]["name"]] = spans.get(x[6]["name"], 0) + x[6]["lanes"]
    assert spans == frame["seen"]
    # the plain versions ran: nothing counts as a card launch
    assert wide.LAUNCHES == {"wide_closest": 0, "wide_shadow": 0}


def test_hud_takes_the_frame_span(frame):
    frame_rec = next(x for x in frame["records"] if x[2] == "frame")
    seconds = (frame_rec[5] - frame_rec[4]) * 1e-9
    assert frame["r"].hud._samples[-1][1] == pytest.approx(seconds)


def _tensors(x, out, key=""):
    if isinstance(x, torch.Tensor):
        out[key] = x
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _tensors(getattr(x, f.name), out, f"{key}.{f.name}")
    return out


def test_profiler_sees_the_spans_and_leaves_the_frame_unchanged(tmp_path):
    """A smaller frame (one bounce, 16x16) under a CPU profiler: a profiled
    frame of the plain walks records every torch operator."""
    small = dict(w=16, h=16, max_depth=1, tess=1, sphere_tess=(3, 4))
    (b0, r0), (b1, r1) = _renderer(**small), _renderer(**small)
    want = _refit_and_render(b0, r0)
    n0 = telemetry.REGISTRY.written
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = _refit_and_render(b1, r1)
    recs = _records_since(n0)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.load(open(path))["traceEvents"]
    annotated = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    labels = [x[2] if x[2] != "kernel" else "kernel/" + x[6]["name"] for x in recs]
    assert sorted(labels) == sorted(annotated)
    assert {"frame", "bounce", "kernel/wide_closest", "set_scene", "refit"} <= set(labels)
    assert torch.equal(got, want)
    got, want = _tensors(r1.state, {}), _tensors(r0.state, {})
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)


def test_ring_is_bounded(monkeypatch):
    reg = telemetry.Registry(capacity=8)
    monkeypatch.setattr(telemetry, "REGISTRY", reg)
    for i in range(20):
        with telemetry.span("s", i=i):
            pass
    recs = reg.records()
    assert len(reg.ring) == 8 and reg.written == 20
    assert [x[6]["i"] for x in recs] == list(range(12, 20))
    assert telemetry.snapshot()["records"] == recs


def test_counters_are_the_registrys_objects():
    c = telemetry.REGISTRY.counters
    for name, d in (("launches.wide", wide.LAUNCHES), ("launches.stream", stream.LAUNCHES),
                    ("launches.binary", binary.LAUNCHES),
                    ("launches.sortpos", sortpos.LAUNCHES),
                    ("launches.treelet", treelet.LAUNCHES),
                    ("launches.streamtreelet", streamtreelet.LAUNCHES),
                    ("launches.restir", restir.LAUNCHES),
                    ("launches.sortkey", sortkey.LAUNCHES),
                    ("launches.shade", shade.LAUNCHES),
                    ("launches.bounce", bounce.LAUNCHES),
                    ("gather_bytes", sharding.GATHER_BYTES), ("lanes", telemetry.LANES)):
        assert c[name] is d, name
    assert telemetry.snapshot()["counters"]["launches.wide"] == dict(wide.LAUNCHES)
