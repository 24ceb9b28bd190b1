"""Human-drivable fly-camera session in a live tk window, through the
PyTorch + CUDA port (the port's counterpart of `fly.py`).

A tkinter window presents the port's frames and pumps real keyboard and
mouse events into the fly camera (runtime/interactive.py over
runtime/controller.py). Controls match the reference (RTWindow.cs:255-314,
CameraController.cs:35-70): WASD + Space/C move, mouse look while
captured, E toggles capture, scroll zooms FOV, Shift x4 / Ctrl x0.25
speed, Escape quits.

Usage: python examples/torch_fly.py [--device cuda|cpu] [--cpu]
       [--width 640] [--height 360] [--cornell] [--spp 1] [--depth 2]
Requires a DISPLAY; prints a message and exits 1 when headless.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cpu", action="store_true", help="shorthand for --device cpu")
    ap.add_argument("--cornell", action="store_true")
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--depth", type=int, default=2)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.runtime.interactive import (
        InteractiveSession,
        TkInputWindow,
    )
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    win = TkInputWindow.open(args.width, args.height)
    if win is None:
        print("no display available (set DISPLAY or use X forwarding)")
        return 1

    cfg = RenderConfig(spp=args.spp, max_depth=args.depth)
    scene = None
    camera = None
    if args.cornell:
        from ilgpu_raytracing_tpu_torch.models.cornell import (
            build_cornell_scene,
            cornell_camera,
        )

        _, scene = build_cornell_scene(tess=12, sphere_tess=(24, 36), device=device)
        camera = cornell_camera(args.width, args.height)
    r = Renderer(
        out_w=args.width, out_h=args.height, cfg=cfg, scene=scene,
        camera=camera, device=device,
    )
    try:
        frames = InteractiveSession(
            r, win.input_provider, win.presenter
        ).run()
    finally:
        win.destroy()
    print(f"{frames} frames")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
