"""BASELINE config 5 through the PyTorch + CUDA port: ~1M-triangle
terrain, 8-bounce path trace (the port's counterpart of `large_mesh.py`).

Renders the procedural large mesh (models/terrain.py) through the port's
Renderer. Above 150k triangles it routes to a StreamScene: the streaming
kernels K4/K5 (csrc/stream_trace.cu) with the bounce batches sorted by K3
on the destination-treelet key (ops/sort.py). Multi-device runs use the
same image-space split as every other scene (`Renderer(mesh=...)`,
parallel/sharding.py).

Usage:
  python examples/torch_large_mesh.py [--device cuda|cpu] [--cpu]
      [--width W] [--height H] [--frames N] [--grid-x GX] [--grid-z GZ]
      [--max-depth D] [--bvh sah|lbvh|median] [--leaf L] [--out PNG]
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cpu", action="store_true", help="shorthand for --device cpu")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--grid-x", type=int, default=1024)
    ap.add_argument("--grid-z", type=int, default=512)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--bvh", default="sah", choices=["sah", "lbvh", "median"])
    ap.add_argument("--leaf", type=int, default=64)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "large_mesh.png"))
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.terrain import (
        build_terrain_scene,
        terrain_camera,
    )
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    t0 = time.time()
    _, scene = build_terrain_scene(
        grid_x=args.grid_x, grid_z=args.grid_z,
        blas_leaf_size=args.leaf, bvh_method=args.bvh, device=device,
    )
    n_tris = int(scene.tri_v0.shape[0])
    print(f"scene: {n_tris} tris, built in {time.time()-t0:.1f}s "
          f"({args.bvh} leaf={args.leaf})", flush=True)

    cfg = RenderConfig(spp=2, max_depth=args.max_depth)
    r = Renderer(
        out_w=args.width, out_h=args.height, cfg=cfg, scene=scene,
        camera=terrain_camera(args.width, args.height), device=device,
    )
    print(f"tracer: {type(r.wscene).__name__}; scene-to-kernel-ready "
          f"{time.time()-t0:.1f}s", flush=True)

    r.render().cpu()  # kernels' first use + sync
    t0 = time.time()
    for _ in range(args.frames):
        r.render().cpu()  # each frame copied to the host
    dt = (time.time() - t0) / args.frames
    rays = r.in_w * r.in_h * (1 + cfg.spp * cfg.max_depth * 2)
    print(f"{dt*1e3:.0f} ms/frame  {rays/dt/1e6:.2f} Mrays/s (dispatched)")
    r.save_png(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
