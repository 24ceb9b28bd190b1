"""Animated sequence through the PyTorch + CUDA port: orbiting camera +
per-frame mesh refit + progressive accumulation with tone mapping
(BASELINE config 4 capabilities; the port's counterpart of `animate.py`).

The Cornell sphere bobs up and down via refit_mesh_instance (BVH topology
kept, bounds refit per frame) and `Renderer.set_scene` rebuilds the
kernel tables on the device every frame (`wide.refit_tables`); the camera
orbits; TAAU handles temporal reuse. Writes a frame sequence.

Usage: python examples/torch_animate.py [--device cuda|cpu] [--cpu]
       [--width 320 --height 240] [--frames 8] [--outdir DIR]
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--outdir", type=str,
                    default=os.path.join(tempfile.gettempdir(), "anim"))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cpu", action="store_true", help="shorthand for --device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.camera import Camera
    from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene
    from ilgpu_raytracing_tpu_torch.models.scene import refit_mesh_instance
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    os.makedirs(args.outdir, exist_ok=True)
    cfg = RenderConfig(spp=2, max_depth=3)
    builder, scene = build_cornell_scene(tess=8, sphere_tess=(12, 18), device=device)
    inst = 0  # the cornell mesh instance
    base_positions = builder.positions.copy()
    sphere_verts = slice(
        builder.instances[inst].vertex_first,
        builder.instances[inst].vertex_first + builder.instances[inst].vertex_count,
    )

    r = Renderer(out_w=args.width, out_h=args.height, cfg=cfg, scene=scene,
                 device=device)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6

    for f in range(args.frames):
        t0 = time.time()
        phase = 2.0 * math.pi * f / max(1, args.frames)
        # bob the tessellated sphere (its grid vertices end the mesh)
        moved = base_positions.copy()
        n_sphere = 13 * 19  # sphere_tess (12,18) grid verts
        moved[-n_sphere:, 1] += 0.15 * math.sin(phase)
        r.set_scene(
            refit_mesh_instance(builder, r.scene, inst, moved[sphere_verts])
        )

        cam = Camera.look_at(
            (3.2 * math.sin(phase * 0.25), 0.2, 3.2 * math.cos(phase * 0.25)),
            (0, 0, 0), (0, 1, 0), 40.0, args.width / args.height,
        )
        r.set_camera(cam)
        r.render().cpu()
        path = os.path.join(args.outdir, f"frame_{f:03d}.png")
        r.save_png(path)
        print(f"{path}  {time.time() - t0:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
