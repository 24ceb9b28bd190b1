#!/usr/bin/env python3
"""The 1080p Cornell bench frame through `Renderer(mesh=...)` on every card
of the machine, in turns with the single-device Renderer of the same seed
(chip_smoke.py's `phase_mesh`, its bars included: frames bit-equal, K1/K2/K3
launches n times the single-device ones, the kernel scene replicated onto
each card once), on the wide route and on the binary route (a caller's
BinaryScene set as `r.wscene`, replicated onto each card once by the mesh
Renderer: frames bit-equal, K6 launches 3n + 5n and K3 6n a frame).

Meshes: `make_mesh()` (all cards), and `cuda:0` repeated as many times (the
simulated mesh: the same split and launches on one card). On one card
only the simulated mesh of 4. Prints each mesh's ms/frame beside the
single-device frame's, the gathers' bytes and the cards' names and power
limits. Run from the repository root:
    python3 tools/torch_mesh_bench.py [--frames 4]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mesh_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.parallel import sharding as shrd

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    count = torch.cuda.device_count()
    cs.log(f"{count} cards: {smi}; torch {torch.__version__}")
    dev = torch.device("cuda:0")
    cu.build_all()
    _, scene = build_cornell_scene(tess=24, sphere_tess=(48, 72), blas_leaf_size=8,
                                   bvh_method="sah", device=dev)
    bench = dict(scene=scene)
    n_sim = count if count > 1 else 4
    meshes = (("make_mesh()", shrd.make_mesh()),
              (f"cuda:0 x {n_sim}", shrd.make_mesh(devices=[dev] * n_sim)))
    cs.MESH_FRAMES = args.frames
    counts = cs.phase_mesh(dev, bench, meshes)
    cs.log(f"launches over the timed frames: "
           f"{({k: v for k, v in counts.items() if v})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
