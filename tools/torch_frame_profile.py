#!/usr/bin/env python3
"""Where the time of one of the port's 1080p frames goes, on one GPU.

Renders, through the port's Renderer, the Cornell bench frame
(`--scene cornell`, the default: tess=24, sphere_tess=(48,72), leaf 8, SAH;
spp=2, max_depth=3; sun (0.3, 0.6)), the 1,048,576-triangle terrain of
examples/large_mesh.py (`--scene terrain`: leaf 64, SAH; spp=2,
max_depth=8), or the Sponza-like courtyard (`--scene courtyard`: alpha
cutouts, every trace peeled around K1, 2 chunks; `courtyard-opaque`: the
same tables with has_alpha off; median BVH, leaf 8; spp=2, max_depth=3;
sun (0.3, 0.6)), or BASELINE config 4 (`--scene config4`: the Cornell
bench scene with examples/animate.py's loop, every frame a refit of the
bobbing sphere, Renderer.set_scene and an orbiting camera, progressive
accumulation; the refit and set_scene are inside the profiled wall), all
1920x1080 out: two warm-up frames, FRAMES frames with the profiler off,
then FRAMES frames under torch.profiler. Prints, from the frames with the
profiler off, the program's span table (utils/telemetry.py: each span
name's self milliseconds a frame, its count a frame and its bytes a frame;
in config 4 `set_scene` holds `refit_tables`, the wide tables rebuilt from
the last ones, where a full prep holds `prepare`, `prepare_wide` and
`upload`), the lanes a frame handed to each kernel and the renderer's
`scene_tables` counts (full preps and refits); from the profiled frames, the
wall time per frame, the device-busy share (the union of the device
operations' intervals over the wall time, as benchmark/harness/trace.py
computes it), the share of the hand-written kernels (the trace kernels, K3,
ReSTIR's, the sort key's, hit shading's and the bounce's scatter and
resolve), the top GPU kernels
by total time, and the 10 longest idle gaps of the device, each named by
the innermost program span (`record_function` label) open on the host when
it began.

Run from the repository root on a machine with one CUDA card:
    python3 tools/torch_frame_profile.py [--scene cornell|terrain|courtyard|courtyard-opaque|config4|oneweekend]

`oneweekend` is the 16-spp sphere cell with every render key of
benchmark/configs/oneweekend-16spp.json (chip_smoke.oneweekend_renderer).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FRAMES = 3
OWN_KERNELS = ("trace_kernel", "anyhit_kernel", "binary_kernel", "treelet_kernel",
               "hist_kernel", "scan_kernel", "rank_kernel", "restir_kernel", "key_kernel",
               "shade_kernel", "scatter_kernel", "resolve_kernel")


def span_table(records) -> list[tuple[str, float, int, int]]:
    """(name, self ns, count, bytes) per span name of telemetry records:
    self time is a span's own time less its children's."""
    inner = {}
    for r in records:
        inner[r[1]] = inner.get(r[1], 0) + r[5] - r[4]
    rows = {}
    for r in records:
        name, self_ns, n, nbytes = rows.get(r[2], (r[2], 0, 0, 0))
        rows[r[2]] = (name, self_ns + r[5] - r[4] - inner.get(r[0], 0), n + 1,
                      nbytes + ((r[6] or {}).get("bytes", 0)))
    return sorted(rows.values(), key=lambda row: -row[1])


def innermost(annotations, t: float) -> str:
    """The shortest program span (user annotation) open at time t."""
    open_at = [(e - s, n) for n, s, e in annotations if s <= t <= e]
    return min(open_at)[1] if open_at else "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", choices=("cornell", "terrain", "courtyard", "courtyard-opaque",
                                        "config4", "oneweekend"), default="cornell")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frame_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import trace
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer
    from ilgpu_raytracing_tpu_torch.utils import telemetry

    def step(frame):
        """What a frame does before render() (config 4: refit and orbit)."""

    if args.scene == "terrain":
        from ilgpu_raytracing_tpu_torch.models.terrain import (
            build_terrain_scene,
            terrain_camera,
        )

        _, scene = build_terrain_scene(device="cuda")
        r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=8), scene,
                     terrain_camera(1920, 1080), device="cuda")
    elif args.scene == "oneweekend":
        from chip_smoke import oneweekend_renderer

        r = oneweekend_renderer("cuda")
    elif args.scene.startswith("courtyard"):
        from ilgpu_raytracing_tpu_torch.models.sponza_like import (
            build_sponza_like_scene,
            sponza_camera,
        )
        from ilgpu_raytracing_tpu_torch.utils.build import BUILD_DIR

        os.makedirs(BUILD_DIR, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
            _, scene = build_sponza_like_scene(d, device="cuda")
        if args.scene == "courtyard-opaque":
            scene = dataclasses.replace(scene, has_alpha=False)
        r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=3), scene,
                     sponza_camera(1920, 1080), device="cuda")
        r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    else:
        from ilgpu_raytracing_tpu_torch.models.camera import Camera
        from ilgpu_raytracing_tpu_torch.models.cornell import (
            build_cornell_scene,
            cornell_camera,
        )
        from ilgpu_raytracing_tpu_torch.models.scene import refit_mesh_instance

        builder, scene = build_cornell_scene(tess=24, sphere_tess=(48, 72),
                                             blas_leaf_size=8, bvh_method="sah",
                                             device="cuda")
        r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=3,
                                              progressive_accumulation=args.scene == "config4"),
                     scene, cornell_camera(1920, 1080), device="cuda")
        r.sun_azimuth, r.sun_elevation = 0.3, 0.6
        if args.scene == "config4":
            inst = builder.instances[0]
            verts = slice(inst.vertex_first, inst.vertex_first + inst.vertex_count)
            base = builder.positions.copy()

            def step(frame):
                phase = 2.0 * np.pi * frame / (2 + FRAMES)
                moved = base.copy()
                moved[-49 * 72:, 1] += np.float32(0.15 * np.sin(phase))  # the sphere
                r.set_scene(refit_mesh_instance(builder, r.scene, 0, moved[verts]))
                r.set_camera(Camera.look_at(
                    (3.2 * np.sin(phase * 0.25), 0.2, 3.2 * np.cos(phase * 0.25)),
                    (0, 0, 0), (0, 1, 0), 40.0, 1920 / 1080))
    for f in range(2):
        step(f)
        r.render().cpu()
    torch.cuda.synchronize()
    n0, lanes0 = telemetry.REGISTRY.written, dict(telemetry.LANES)
    tables0 = dict(telemetry.REGISTRY.counters["scene_tables"])
    for f in range(2, 2 + FRAMES):
        step(f)
        r.render().cpu()
    torch.cuda.synchronize()
    recs = telemetry.REGISTRY.records()
    recs = recs[len(recs) - (telemetry.REGISTRY.written - n0):]
    print(f"program spans, {FRAMES} frames with the profiler off (self ms, count, bytes "
          f"a frame):")
    for name, self_ns, n, nbytes in span_table(recs):
        print(f"{self_ns * 1e-6 / FRAMES:10.3f} ms/frame {n / FRAMES:8.1f}/frame "
              f"{nbytes / FRAMES:14.0f} B/frame  {name}")
    for k, v in sorted(telemetry.LANES.items()):
        print(f"lanes {k}: {(v - lanes0.get(k, 0)) / FRAMES:.0f} a frame")
    tables = telemetry.REGISTRY.counters["scene_tables"]
    print(f"scene_tables over the {FRAMES} frames: "
          f"{ {k: v - tables0[k] for k, v in tables.items()} } (since start: {tables})")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function("window"):
            t0 = time.monotonic()
            for f in range(2 + FRAMES, 2 + 2 * FRAMES):
                step(f)
                r.render().cpu()
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace_events = json.load(f)["traceEvents"]
    p = trace.Profile(trace_events, FRAMES)
    busy_us = p.busy_us()
    own_us = sum(us for base, _, us in p.kernels() if base in OWN_KERNELS)
    print(f"{torch.cuda.get_device_name(0)}, {args.scene}: {FRAMES} frames, wall "
          f"{wall / FRAMES * 1e3:.3f} ms/frame, device busy "
          f"{busy_us / 1e3 / FRAMES:.3f} ms/frame ({busy_us / p.window_us:.1%} of the "
          f"profiled wall), hand-written kernels {own_us / 1e3 / FRAMES:.3f} ms/frame, "
          f"{len(p.device) / FRAMES:.0f} GPU ops/frame")
    annotations = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in trace_events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation" and e.get("name") != "window"]
    gaps = sorted(trace.idle_gaps(p.intervals(), p.lo, p.hi), key=lambda g: g[0] - g[1])
    for s, e in gaps[:10]:
        print(f"idle gap {(e - s) * 1e-3:10.3f} ms  in {innermost(annotations, s)}")
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: -e.self_device_time_total)
    lines = [f"{e.self_device_time_total / 1e3 / FRAMES:10.3f} ms/frame "
             f"{e.count / FRAMES:8.1f} calls/frame  {e.key[:110]}" for e in events]
    for line in lines[:40]:
        print(line)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
