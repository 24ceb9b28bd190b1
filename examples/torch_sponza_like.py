"""Sponza-class demo through the PyTorch + CUDA port: procedural
multi-material OBJ courtyard with MTL, tiled diffuse textures and
alpha-cutout banners, through the port's Renderer (every trace peeled
around the closest-hit kernel K1, ops/alpha.py; the port's counterpart of
`sponza_like.py`).

Usage:
  python examples/torch_sponza_like.py [--device cuda|cpu] [--cpu]
      [--width W] [--height H] [--frames N] [--out PNG]
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
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "sponza_like.png"))
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.sponza_like import (
        build_sponza_like_scene,
        sponza_camera,
    )
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    with tempfile.TemporaryDirectory() as d:
        _, scene = build_sponza_like_scene(d, device=device)
    print(f"scene: {int(scene.tri_v0.shape[0])} tris, "
          f"{int(scene.mat_kd.shape[0])} materials, alpha={scene.has_alpha}")

    cfg = RenderConfig(spp=2, max_depth=3, sun_azimuth=0.4, sun_elevation=0.9)
    r = Renderer(
        out_w=args.width, out_h=args.height, cfg=cfg, scene=scene,
        camera=sponza_camera(args.width, args.height), device=device,
    )
    r.render().cpu()
    t0 = time.time()
    for _ in range(args.frames):
        r.render().cpu()  # each frame copied to the host
    print(f"{(time.time()-t0)/args.frames*1e3:.0f} ms/frame")
    r.save_png(args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
