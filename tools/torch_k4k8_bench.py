#!/usr/bin/env python3
"""Time K4 (streaming closest hit) and one K8 round (streaming treelet
round) of the checkout it runs from, on one GPU, at the shapes of
chip_smoke.py's terrain phases.

Prints, for the package found in the current directory:
- ptxas's report of csrc/stream_trace.cu and csrc/streamtreelet_trace.cu
  (registers, stack frame, spills, shared memory);
- K4 on the 901,120 primary rays and on the 1,802,240 treelet-sorted bounce
  lanes (about 1.13M live) of the 1,048,576-triangle terrain, t_max T_INF:
  ms by CUDA events (twice), the boxes and primitives its counting variant
  tallies, the bound of chip_smoke.py's `trace_bound` from those counts, and
  a digest of (t, pp), so that two checkouts can be held equal bit for bit;
- the first K8 round of `trace_closest_treelet_stream_packed` on the bounce
  lanes: ms (twice), boxes, primitives, bound, digest; and whether the
  rounds call equals K4 in t and pp on every lane.
The bound's bytes are those of the packed node records, the order words,
the leaf rows and the instance tables in every checkout, so that two
checkouts' bounds differ only by the work their walks count.

To pair two checkouts, run this script from the root of each, in turns, on
one card in one run (parent, change, change, parent):
    python3 tools/torch_k4k8_bench.py --label change --out out/k4k8.jsonl
    (cd _checkout/parent && python3 ../../tools/torch_k4k8_bench.py --label parent \\
        --out ../../out/k4k8.jsonl)
Appends one JSON line of the numbers to --out.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import torch


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def terrain_lanes(cs):
    """The terrain, its stream tables, primary rays and treelet-sorted
    bounce lanes, as chip_smoke.py's K4/K5 phase makes them."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.terrain import build_terrain_scene, terrain_camera
    from ilgpu_raytracing_tpu_torch.ops import rays
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream, streamtreelet

    dev = torch.device("cuda")
    _, scene = build_terrain_scene(device=dev)
    ss = stream.prepare_stream(scene)
    in_w, in_h = RenderConfig().internal_resolution(1920, 1080)
    o, d = rays.generate_primary_rays(terrain_camera(1920, 1080), in_w, in_h, dev)
    o = o.contiguous()
    hit = stream.trace_closest_stream(ss, o, d)
    bo, bd, act, n_alive = cs._bounce_rays(scene, hit, o, d, 11, (None, ss.sortkey_bounds))
    sts = streamtreelet.prepare_treelets_stream(ss, 32)
    return dict(ss=ss, sts=sts, o=o, d=d, bo=bo, bd=bd, act=act, n_alive=n_alive)


def bench_build(cs, lanes: dict, reps: int) -> dict:
    """K4 primary, K4 bounce and K8's first round."""
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import treelet as ops_treelet
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream, streamtreelet
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    out: dict = {}
    for name in ("stream_trace", "streamtreelet_trace"):
        out[f"ptxas_{name}"] = cu.ptxas_info(name)
        for line in out[f"ptxas_{name}"]:
            print(f"ptxas {name}.cu: {line}", flush=True)
    ss, sts = lanes["ss"], lanes["sts"]
    o, d, bo, bd, act = lanes["o"], lanes["d"], lanes["bo"], lanes["bd"], lanes["act"]
    n, nb = o.shape[0], bo.shape[0]
    tmp = torch.full((n,), T_INF, device=o.device)
    k4_tables = (ss.anyhit_nodes, ss.wide_perm, ss.tri_rows, ss.sph_rows, ss.inst_i,
                 ss.inst_f)
    tmb = torch.where(act, torch.full((nb,), T_INF, device=o.device),
                      torch.zeros(nb, device=o.device))
    for label, args, tm in (("k4_primary", (ss, o, d), tmp),
                            ("k4_bounce", (ss, bo, bd), tmb)):
        kw = {} if label == "k4_primary" else {"active": act}
        t, pp = stream.trace_closest_stream_packed(*args, **kw)
        ms = [cs.cuda_ms(lambda: stream.trace_closest_stream_packed(*args, **kw), reps)
              for _ in range(2)]
        boxes, prims = stream.count_work(*args, tm, any_hit=False)
        bound = cs.trace_bound(args[1].shape[0], (boxes, prims), False, cs.QBOX_OPS,
                               k4_tables)
        out[label] = dict(ms=ms, boxes=boxes, prims=prims, hits=int((pp >= 0).sum()),
                          digest=digest(t, pp), lanes=args[1].shape[0], **bound)
        print(f"{label} {args[1].shape[0]} lanes: {ms[0]:.4f}, {ms[1]:.4f} ms; {boxes} "
              f"boxes, {prims} primitives, bound {bound}; {out[label]['hits']} hits; "
              f"(t, pp) digest {out[label]['digest']}", flush=True)
        if label == "k4_bounce":
            t_k4, pp_k4 = t, pp

    (t, pp, rounds), (args, _) = cs._first_round(
        (ops_treelet.stl, "run_treelet_stream_trace"),
        lambda: ops_treelet.trace_closest_treelet_stream_packed(sts, bo, bd, active=act,
                                                                with_rounds=True))
    rounds_equal = bool(torch.equal(t, t_k4)) and bool(torch.equal(pp, pp_k4))
    t1, pp1 = streamtreelet.run_treelet_stream_trace(*args)
    ms = [cs.cuda_ms(lambda: streamtreelet.run_treelet_stream_trace(*args), reps)
          for _ in range(2)]
    boxes, prims = streamtreelet.count_work(*args)
    s = sts.sscene
    bound = cs.trace_bound(nb, (boxes, prims), False, cs.QBOX_OPS,
                           (sts.t_root, sts.t_inst, s.anyhit_nodes, s.wide_perm,
                            s.tri_rows, s.sph_rows, args[1]))
    out["k8_round"] = dict(ms=ms, boxes=boxes, prims=prims, digest=digest(t1, pp1),
                           rounds=rounds, rounds_equal_k4=rounds_equal, **bound)
    print(f"k8 first round {nb} lanes: {ms[0]:.4f}, {ms[1]:.4f} ms; {boxes} boxes, "
          f"{prims} primitives, bound {bound}; (t, pp) digest "
          f"{out['k8_round']['digest']}; {rounds} rounds, equal to K4 on every lane: "
          f"{rounds_equal}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="checkout")
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k4k8_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu

    t0 = time.monotonic()
    card = cs.smi_line()
    print(f"[{args.label}] {os.getcwd()}: {card}; torch {torch.__version__}", flush=True)
    cu.build_all()
    lanes = terrain_lanes(cs)
    print(f"terrain: {lanes['o'].shape[0]} primary rays, {lanes['bo'].shape[0]} bounce "
          f"lanes ({lanes['n_alive']} live), {lanes['sts'].n_treelets} treelets", flush=True)
    out: dict = dict(label=args.label, card=card, **bench_build(cs, lanes, args.reps))
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
