"""CPU-parity check of the PyTorch + CUDA port (BASELINE metric: per-pixel
RMSE vs the CPU reference at equal spp; config 1: sphere scene, 512x512,
1 spp, single bounce; the port's counterpart of `parity_check.py`).

Renders config-1 frames over K noise seeds twice in one process: with the
kernels' plain PyTorch versions on the CPU and with the hand-written
kernels on `--device`, and compares the MEAN images. Identical seeds are
used on both sides, but a stochastic renderer has chaotic decision
boundaries (reservoir selection, Fresnel branches) where float-epsilon
differences flip whole samples -- individual 1-spp frames legitimately
differ pixel-wise; the estimator MEANS must agree within the Monte-Carlo
noise floor (sigma/sqrt(K)), which is what this reports, as one JSON line
with `parity_check.py`'s fields.

Usage: python examples/torch_parity_check.py [--device cuda|cpu]
       [--size 512] [--spp 1] [--depth 1] [--seeds 16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def mean_var(device, size: int, spp: int, depth: int, seeds: int):
    """Per-pixel mean and variance (size*size, 3) float64 of the config-1
    colour over `seeds` noise seeds, traced on `device`."""
    import torch

    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.camera import Camera
    from ilgpu_raytracing_tpu_torch.models.scene import build_default_scene
    from ilgpu_raytracing_tpu_torch.ops import integrator, sky
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide
    from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs

    cfg = RenderConfig(spp=spp, max_depth=depth, rng_lock_noise=1,
                       enable_temporal_reuse=False, enable_spatial_reuse=False)
    _, scene = build_default_scene(device=device)
    ks = wide.prepare_scene(scene)
    cam = Camera.create(size, size, 60.0)
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    n = size * size
    acc = np.zeros((n, 3), np.float64)
    sq = np.zeros((n, 3), np.float64)
    with torch.inference_mode():
        gb = integrator.primary_visibility(scene, cam, size, size, cfg.chunk_pixels, ks)
        for s in range(seeds):
            c = integrator.path_trace(
                scene, gb, cam, cam, Reservoirs.empty(n, device),
                Reservoirs.empty(n, device), 0, (s * 2654435761 & 0xFFFFFFFF) | 1,
                sun, cfg, size, size, ks)[0].double().cpu().numpy()
            acc += c
            sq += c * c
    mean = acc / seeds
    return mean, np.maximum(sq / seeds - mean ** 2, 0.0)


def compare(mean_a, var_a, mean_b, var_b, size: int, spp: int, depth: int,
            seeds: int) -> dict:
    """`parity_check.py`'s result line for the CPU means (a) against the
    device means (b)."""
    err2 = ((mean_a - mean_b) ** 2).mean(axis=1)
    rmse = float(np.sqrt(err2.mean()))
    # Precision differences flip DISCRETE decisions at texture cell edges
    # and silhouettes; those pixels differ by whole texel colours on any
    # backend pair. Report both the overall RMSE and a robust RMSE over the
    # 95% of pixels away from such boundaries, against the noise floor.
    k = int(err2.shape[0] * 0.95)
    robust = float(np.sqrt(np.sort(err2)[:k].mean()))
    floor = float(np.sqrt(np.mean((var_a + var_b) / seeds)))
    signal = float(np.sqrt(np.mean(mean_a ** 2)))
    return {
        "metric": "rmse_cpu_vs_device_config1",
        "rmse_of_means": rmse,
        "rmse_robust_p95": robust,
        "boundary_pixel_frac": float(
            (np.abs(mean_a - mean_b).max(axis=1) > 0.1).mean()
        ),
        "noise_floor": floor,
        "robust_over_floor": robust / max(1e-9, floor),
        "signal_rms": signal,
        "within_noise_floor": bool(robust <= 1.5 * floor),
        "size": size,
        "spp": spp,
        "depth": depth,
        "seeds": seeds,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--depth", type=int, default=1)
    ap.add_argument("--seeds", type=int, default=16)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    shape = (args.size, args.spp, args.depth, args.seeds)
    a = mean_var("cpu", *shape)
    b = mean_var(args.device, *shape)
    print(json.dumps(compare(*a, *b, *shape)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
