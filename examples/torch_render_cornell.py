"""Render the procedural Cornell scene through the PyTorch + CUDA port
(BASELINE config 3: triangle mesh, LBVH/SAH/median build + traversal,
800x600; the port's counterpart of `render_cornell.py`).

`render_cornell.py --pallas` has no counterpart: on the card the port
always traces with its hand-written kernels (the Renderer refuses the plain
walk on CUDA), and on the CPU with their plain PyTorch versions.

Usage: python examples/torch_render_cornell.py [--device cuda|cpu] [--cpu]
       [--bvh sah|median|lbvh] [--width 800 --height 600] [--frames 4]
       [--tess 12] [--out out.png]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", type=str,
                    default=os.path.join(tempfile.gettempdir(), "cornell.png"))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cpu", action="store_true", help="shorthand for --device cpu")
    ap.add_argument("--bvh", type=str, default="sah",
                    choices=["median", "sah", "lbvh"])
    ap.add_argument("--tess", type=int, default=12)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import (
        build_cornell_scene,
        cornell_camera,
    )
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    cfg = RenderConfig(spp=2, max_depth=3)
    _, scene = build_cornell_scene(
        tess=args.tess, blas_leaf_size=8, bvh_method=args.bvh, device=device
    )
    print(f"triangles: {scene.tri_v0.shape[0]} (bvh={args.bvh})")
    r = Renderer(
        out_w=args.width, out_h=args.height, cfg=cfg, scene=scene,
        camera=cornell_camera(args.width, args.height), device=device,
    )
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    for f in range(args.frames):
        t0 = time.time()
        r.render().cpu()
        print(f"frame {f}: {time.time() - t0:.3f}s")
    r.save_png(args.out)
    print("wrote", args.out, "|", r.hud.text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
