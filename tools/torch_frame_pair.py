#!/usr/bin/env python3
"""Time the two 1080p main-path frames of the checkout it runs from, on one
GPU, through chip_smoke.py's own phases: K1/K2 on the Cornell bench lanes
(`phase_k1_k2`, with its bars), then the Cornell bench frame
(`phase_main_path`: 1 warm-up + 6 frames) and the 1,048,576-triangle
terrain frame (`phase_terrain_main`: 1 warm-up + 3 frames), each
`--repeats` times. The phases print their own lines ("ms/frame", "frame
ms", launch counts).

Both frames are host-bound and their wall time spreads by tens of ms from
run to run, so pair two checkouts in one session, alternating them
(parent, change, change, parent, ...):
    python3 tools/torch_frame_pair.py
    (cd _checkout/parent && python3 ../../tools/torch_frame_pair.py)
"""

from __future__ import annotations

import argparse
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frame_pair: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ilgpu_raytracing_tpu_torch.models.terrain import build_terrain_scene
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu

    cs.log(f"{os.getcwd()}: {cs.smi_line()}; torch {torch.__version__}")
    dev = torch.device("cuda:0")
    cu.build_all()
    results: dict = {}
    bench = cs.phase_k1_k2(dev, results)
    cs.log(f"K1/K2 ms: {({k: v['ms'] for k, v in results.items()})}")
    _, terrain = build_terrain_scene(device=dev)
    for _ in range(args.repeats):
        cs.phase_main_path(dev, bench)
        cs.phase_terrain_main(dev, terrain)
    return 0


if __name__ == "__main__":
    sys.exit(main())
