#!/usr/bin/env python3
"""Time K3 (counting-sort positions) and K5 (streaming any-hit) of the
checkout it runs from, on one GPU, at the shapes of the 1080p frames.

Prints, for the package found in the current directory:
- K3 on 1,802,240 keys (70% uniform over bins-1 bins, a dead tail in the
  last bin, as chip_smoke.py makes them) at 129 and 258 bins: the wrapper's
  ms by CUDA events, torch.argsort(stable=True) on the same keys, and the
  GPU time of each kernel of the wrapper from torch.profiler;
- K5 on the 1,802,240 treelet-sorted bounce lanes of the 1,048,576-triangle
  terrain (chip_smoke.py's K4/K5 phase) at t_max 1e29: ms, boxes and
  primitives tested, whether its occlusion equals K4's hit mask, and a
  digest of the occlusion, so that two checkouts can be held equal bit for
  bit. K4 on the same lanes is timed as the control that both checkouts
  share.
chip_smoke.py prints the ptxas report and K5's SIMD-efficiency count.

To pair two checkouts, run this script from the root of each, in turns, on
one card in one run (parent, change, change, parent):
    python3 tools/torch_k3k5_bench.py --label change --out out/k3k5.jsonl
    (cd _checkout/parent && python3 ../../tools/torch_k3k5_bench.py --label parent \
        --out ../../out/k3k5.jsonl)
Appends one JSON line of the numbers to --out.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

N_KEYS = 1_802_240


def kernel_times(fn, reps: int) -> dict:
    """GPU µs per call of each CUDA kernel fn() launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.self_device_time_total / reps, 3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def bench_k3(cs, out: dict, reps: int) -> None:
    from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos

    rng = np.random.default_rng(7)
    for bins in (129, 258):
        live = int(N_KEYS * 0.7)
        key = np.concatenate([rng.integers(0, bins - 1, size=live),
                              np.full(N_KEYS - live, bins - 1)]).astype(np.int32)
        kt = torch.as_tensor(key, device="cuda")
        got = sortpos.counting_pos(kt, bins)
        inv = torch.argsort(kt, stable=True)
        exact = bool(torch.equal(got.long()[inv], torch.arange(N_KEYS, device="cuda")))
        ms = cs.cuda_ms(lambda: sortpos.counting_pos(kt, bins), reps)
        lib_ms = cs.cuda_ms(lambda: torch.argsort(kt, stable=True), reps)
        ms2 = cs.cuda_ms(lambda: sortpos.counting_pos(kt, bins), reps)
        lib_ms2 = cs.cuda_ms(lambda: torch.argsort(kt, stable=True), reps)
        per_kernel = kernel_times(lambda: sortpos.counting_pos(kt, bins), reps)
        print(f"K3 {N_KEYS} keys x {bins} bins: wrapper {ms:.4f}, {ms2:.4f} ms; "
              f"torch.argsort(stable) {lib_ms:.4f}, {lib_ms2:.4f} ms; pos is the inverse "
              f"of the stable argsort: {exact}; GPU µs per call: {per_kernel}", flush=True)
        out[f"k3_{bins}"] = dict(ms=[ms, ms2], argsort_ms=[lib_ms, lib_ms2],
                                 exact=exact, kernel_us=per_kernel)


def bench_k5(cs, out: dict, reps: int) -> None:
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.terrain import build_terrain_scene, terrain_camera
    from ilgpu_raytracing_tpu_torch.ops import rays
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream

    dev = torch.device("cuda")
    _, scene = build_terrain_scene(device=dev)
    ss = stream.prepare_stream(scene)
    in_w, in_h = RenderConfig().internal_resolution(1920, 1080)
    o, d = rays.generate_primary_rays(terrain_camera(1920, 1080), in_w, in_h, dev)
    o = o.contiguous()
    hit = stream.trace_closest_stream(ss, o, d)
    bo, bd, act, n_alive = cs._bounce_rays(scene, hit, o, d, 11, (None, ss.sortkey_bounds))
    nb = bo.shape[0]
    tms = torch.where(act, torch.full((nb,), 1e29, device=dev), torch.zeros(nb, device=dev))
    occ = stream.shadow_occlusion_stream(ss, bo, bd, 1e29, active=act)
    k4_hit = stream.trace_closest_stream_packed(ss, bo, bd, active=act, t_max=1e29)[1] >= 0
    n_diff = int((occ != k4_hit).sum())
    occ_digest = hashlib.sha256(occ.cpu().numpy().tobytes()).hexdigest()[:16]
    times, k4 = [], []
    for _ in range(2):
        times.append(cs.cuda_ms(lambda: stream.shadow_occlusion_stream(
            ss, bo, bd, 1e29, active=act), reps))
        k4.append(cs.cuda_ms(lambda: stream.trace_closest_stream_packed(
            ss, bo, bd, active=act), reps))
    boxes, prims = stream.count_work(ss, bo, bd, tms, any_hit=True)
    print(f"K5 {nb} treelet-sorted terrain bounce lanes ({n_alive} live), t_max 1e29: "
          f"{times[0]:.4f}, {times[1]:.4f} ms; occluded {int(occ.sum())}, differs from "
          f"K4's hit mask on {n_diff} lanes; occlusion digest {occ_digest}; {boxes} "
          f"boxes, {prims} primitives; K4 on the same lanes {k4[0]:.4f}, {k4[1]:.4f} ms",
          flush=True)
    out["k5"] = dict(ms=times, k4_ms=k4, occluded=int(occ.sum()), k4_mask_diff=n_diff,
                     digest=occ_digest, boxes=boxes, prims=prims, lanes=nb, live=n_alive)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="checkout")
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3k5_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu

    t0 = time.monotonic()
    card = cs.smi_line()
    print(f"[{args.label}] {os.getcwd()}: {card}; torch {torch.__version__}", flush=True)
    cu.build_all()
    out: dict = dict(label=args.label, card=card)
    bench_k3(cs, out, args.reps)
    bench_k5(cs, out, args.reps)
    out["seconds"] = time.monotonic() - t0
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
