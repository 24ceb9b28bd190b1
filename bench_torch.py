#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port: multi-bounce triangle-mesh path
trace, 1080p presented frame (the port's counterpart of `bench.py`).

Prints ONE JSON line with `bench.py`'s fields: {"metric", "value", "unit",
"vs_baseline", "vs_baseline_effective", "detail"}. Baseline target: 200
Mrays/sec/chip (BASELINE.md north star).

The measured frame is `bench.py`'s: internal tracing at 0.67x per axis
(1280x704) -> ReSTIR path trace (spp=2, 3 bounces) -> TAAU upsample to
1920x1080, through the port's `Renderer` on the card (the hand-written
kernels K1/K2 and the counting sort K3). The headline value counts
DISPATCHED trace lanes at internal resolution (1 primary + (1 scatter + 1
shadow) per sample per bounce per pixel); `detail.mrays_effective` counts
only lanes alive when traced (`aux["eff_rays"]`). Every frame's packed
1080p framebuffer (int64, 16.6 MB) is copied to the host, in `bench.py`'s
order: issue frame N, then copy frame N-1. On one CUDA stream that copy
waits for all of frame N, so the copy is not overlapped with the next
frame's work. Protocol: one warm-up frame (it also absorbs the first-use
nvcc build), then 3 windows of 6 frames; the value is the minimum window.

Scene: procedural Cornell box + tessellated sphere (15,552 triangles at
tess=24, one mesh BLAS, SAH build, leaf 8). `detail.device` is the card's
name and power limit as `nvidia-smi --query-gpu=name,power.limit` gives
them. Needs a CUDA card; it never falls back to the CPU:
    python3 bench_torch.py
"""

from __future__ import annotations

import json
import subprocess
import time

BENCH_SCENE = dict(tess=24, sphere_tess=(48, 72), blas_leaf_size=8, bvh_method="sah")


def device_line(device) -> str:
    """The card's name and power limit from nvidia-smi; the device's name
    off the card."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def run(device="cuda", out_w: int = 1920, out_h: int = 1080, scene_kwargs=None,
        n_windows: int = 3, win_frames: int = 6) -> dict:
    """Render `bench.py`'s frame protocol through the port's Renderer on
    `device` and return `bench.py`'s result dict."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import (
        build_cornell_scene,
        cornell_camera,
    )
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    cfg = RenderConfig(spp=2, max_depth=3)
    _, scene = build_cornell_scene(**(scene_kwargs or BENCH_SCENE), device=device)
    n_tris = int(scene.tri_v0.shape[0])
    r = Renderer(out_w=out_w, out_h=out_h, cfg=cfg, scene=scene,
                 camera=cornell_camera(out_w, out_h), device=device)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6

    # warm-up (and the kernels' first-use build)
    r.render().cpu()

    win_dts = []
    for _ in range(n_windows):
        prev = None
        t0 = time.time()
        for _ in range(win_frames):
            cur = r.render()
            if prev is not None:
                prev.cpu()
            prev = cur
        prev.cpu()  # drain the last frame
        win_dts.append(time.time() - t0)
    dt = min(win_dts)
    n_frames = win_frames

    in_n = r.in_w * r.in_h
    rays_per_frame = in_n * (1 + cfg.spp * cfg.max_depth * 2)
    eff_rays_per_frame = float(r._last_aux["eff_rays"])
    mrays = rays_per_frame * n_frames / dt / 1e6
    mrays_eff = eff_rays_per_frame * n_frames / dt / 1e6
    fps = n_frames / dt
    return {
        "metric": "mrays_per_sec_1080p_cornell_path_trace",
        "value": round(mrays, 2),
        "unit": "Mrays/s/chip",
        "vs_baseline": round(mrays / 200.0, 4),
        "vs_baseline_effective": round(mrays_eff / 200.0, 4),
        "detail": {
            "fps_1080p_presented": round(fps, 3),
            "mrays_effective": round(mrays_eff, 2),
            "window_s": [round(x, 3) for x in win_dts],
            "rays_dispatched_per_frame": rays_per_frame,
            "rays_effective_per_frame": int(eff_rays_per_frame),
            "internal_res": [r.in_w, r.in_h],
            "tris": n_tris,
            "spp": cfg.spp,
            "max_depth": cfg.max_depth,
            "frames": n_frames,
            "device": device_line(device),
        },
    }


def main():
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
