"""Render the default 6-sphere scene to PNG through the PyTorch + CUDA port
(the port's counterpart of `render_default.py`).

Drives the production path: the port's `Renderer` (the full frame step,
tracing with the hand-written kernels K1/K2 and the counting sort K3 on the
card, their plain PyTorch versions on the CPU), the path `bench_torch.py`
measures.

Usage:
  python examples/torch_render_default.py --width 512 --height 512 --frames 3 \
      --out frame.png [--device cuda|cpu] [--cpu] [--spp 2] [--depth 3] \
      [--no-restir-reuse] [--lock-noise] [--no-taau]
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
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", type=str,
                    default=os.path.join(tempfile.gettempdir(), "frame.png"))
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--cpu", action="store_true", help="shorthand for --device cpu")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--no-restir-reuse", action="store_true")
    ap.add_argument("--lock-noise", action="store_true")
    ap.add_argument("--no-taau", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    cfg = RenderConfig(
        spp=args.spp,
        max_depth=args.depth,
        enable_temporal_reuse=not args.no_restir_reuse,
        enable_spatial_reuse=not args.no_restir_reuse,
        rng_lock_noise=0 if args.lock_noise else 1,
        enable_taau=not args.no_taau,
    )
    r = Renderer(out_w=args.width, out_h=args.height, cfg=cfg, device=device)
    for frame in range(args.frames):
        t0 = time.time()
        r.render().cpu()  # the frame copied to the host: an honest time
        print(f"frame {frame}: {time.time() - t0:.3f}s")
    r.save_png(args.out)
    print(f"wrote {args.out} (kernels={r.wscene is not None}, "
          f"internal {r.in_w}x{r.in_h})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
