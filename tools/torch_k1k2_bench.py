#!/usr/bin/env python3
"""Time K1 (wide closest hit), K2 (wide any-hit) and one K7 round (treelet
round over the wide tables) of the checkout it runs from, on one GPU, at
the shapes of chip_smoke.py's Cornell bench phases.

Prints, for the package found in the current directory:
- ptxas's report of csrc/wide_trace.cu and csrc/treelet_trace.cu
  (registers, stack frame, spills, shared memory);
- K1 on the 901,120 primary rays and on the 1,802,240 sorted bounce lanes
  (about 1.16M live) of the Cornell bench scene (15,552 triangles, SAH,
  leaf 8), t_max T_INF, and K2 on the bounce lanes at t_max 1e29: ms by CUDA
  events (twice), the boxes and primitives the counting variant tallies,
  the bound of chip_smoke.py's `trace_bound` from those counts, and a digest
  of (t, pp) or of the occlusion, so that two checkouts can be held equal
  bit for bit;
- K6 (the binary BVH walk) closest and any-hit on the same bounce lanes,
  timed in turns with K1 and K2 (the route question of the wide against
  the binary tables), and K6 closest on the primary rays: ms, the boxes
  and primitives its counting variant tallies, the bound from them, and a
  digest of (t, prim, inst, bu, bv) or of the occlusion;
- the first K7 round of `trace_closest_treelet_packed` on the bounce lanes
  (packets of 4096): ms (twice), boxes, primitives, bound, digest; and
  whether the rounds call equals K1 in t and pp on every lane.
The bound's bytes are those of the flat wide tables (child boxes, child
words, order words: the same 256 bytes a node as the packed record), the
leaf rows and the instance tables in every checkout, so that two checkouts'
bounds differ only by the work their walks count; K6's are those of the
flat binary tables (node boxes, node records, leaf rows, instance tables),
and beside them the bound over the tables the checkout's kernel reads (the
child-pair and root records in place of the flat node tables where the
checkout has them).

To pair two checkouts, run this script from the root of each, in turns, on
one card in one run (parent, change, change, parent):
    python3 tools/torch_k1k2_bench.py --label change --out out/k1k2.jsonl
    (cd _checkout/parent && python3 ../../tools/torch_k1k2_bench.py --label parent \\
        --out ../../out/k1k2.jsonl)
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


def bench_lanes(cs):
    """The bench scene, its wide and binary tables, the treelet cut, primary
    rays and sorted bounce lanes, as chip_smoke.py's K1/K2 phase makes them."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene, cornell_camera
    from ilgpu_raytracing_tpu_torch.ops import rays
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary, treelet, wide

    dev = torch.device("cuda")
    _, scene = build_cornell_scene(tess=24, sphere_tess=(48, 72), blas_leaf_size=8,
                                   bvh_method="sah", device=dev)
    ws = wide.prepare_scene(scene)
    in_w, in_h = RenderConfig().internal_resolution(1920, 1080)
    o, d = rays.generate_primary_rays(cornell_camera(1920, 1080), in_w, in_h, dev)
    o = o.contiguous()
    hit = wide.trace_closest_wide(ws, o, d)
    bmin = torch.amin(scene.inst_bmin, dim=0)
    bmax = torch.amax(scene.inst_bmax, dim=0)
    bo, bd, act, n_alive = cs._bounce_rays(scene, hit, o, d, 11,
                                           ((bmin, 1.0 / (bmax - bmin)),))
    return dict(ws=ws, bs=binary.prepare_binary(scene), ts=treelet.prepare_treelets(ws, 32),
                o=o, d=d, bo=bo, bd=bd, act=act, n_alive=n_alive)


def bench_build(cs, lanes: dict, reps: int) -> dict:
    """K1 primary, K1 and K2 bounce beside K6, and K7's first round."""
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import treelet as ops_treelet
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary, treelet, wide
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    out: dict = {}
    for name in ("wide_trace", "treelet_trace", "binary_trace"):
        out[f"ptxas_{name}"] = cu.ptxas_info(name)
        for line in out[f"ptxas_{name}"]:
            print(f"ptxas {name}.cu: {line}", flush=True)
    ws, bs, ts = lanes["ws"], lanes["bs"], lanes["ts"]
    o, d, bo, bd, act = lanes["o"], lanes["d"], lanes["bo"], lanes["bd"], lanes["act"]
    dev = o.device
    n, nb = o.shape[0], bo.shape[0]
    tables = (ws.wide_bounds, ws.wide_child, ws.wide_perm, ws.tri_rows, ws.sph_rows,
              ws.inst_i, ws.inst_f)
    tmb = torch.where(act, torch.full((nb,), T_INF, device=dev), torch.zeros(nb, device=dev))
    tms = torch.where(act, torch.full((nb,), 1e29, device=dev), torch.zeros(nb, device=dev))

    def record(label, lanes_n, ms, work, any_hit, outs):
        bound = cs.trace_bound(lanes_n, work, any_hit, cs.BOX_OPS, tables)
        out[label] = dict(ms=ms, boxes=work[0], prims=work[1], digest=digest(*outs),
                          lanes=lanes_n, **bound)
        print(f"{label} {lanes_n} lanes: {ms[0]:.4f}, {ms[1]:.4f} ms; {work[0]} boxes, "
              f"{work[1]} primitives, bound {bound}; digest {out[label]['digest']}",
              flush=True)

    t_p, pp_p = wide.trace_closest_wide_packed(ws, o, d)
    ms = [cs.cuda_ms(lambda: wide.trace_closest_wide_packed(ws, o, d), reps)
          for _ in range(2)]
    record("k1_primary", n, ms,
           wide.count_work(ws, o, d, torch.full((n,), T_INF, device=dev), any_hit=False),
           False, (t_p, pp_p))

    t_b, pp_b = wide.trace_closest_wide_packed(ws, bo, bd, active=act)
    occ = wide.shadow_occlusion_wide(ws, bo, bd, 1e29, active=act)
    k1, k2, k6c, k6s = [], [], [], []
    for _ in range(2):  # in turns with K6 on the same lanes
        k1.append(cs.cuda_ms(lambda: wide.trace_closest_wide_packed(ws, bo, bd, active=act),
                             reps))
        k6c.append(cs.cuda_ms(lambda: binary.trace_binary_raw(bs, bo, bd, tmb), reps))
        k2.append(cs.cuda_ms(lambda: wide.shadow_occlusion_wide(ws, bo, bd, 1e29,
                                                                active=act), reps))
        k6s.append(cs.cuda_ms(lambda: binary.shadow_occlusion_binary(bs, bo, bd, tms),
                              reps))
    record("k1_bounce", nb, k1, wide.count_work(ws, bo, bd, tmb, any_hit=False),
           False, (t_b, pp_b))
    record("k2_bounce", nb, k2, wide.count_work(ws, bo, bd, tms, any_hit=True),
           True, (occ,))
    out["k2_bounce"]["occluded"] = int(occ.sum())

    flat = (bs.nodes, bs.node_i, bs.tri, bs.sph, bs.inst_i, bs.inst_f)
    # the tables this checkout's kernel reads: the flat ones, or the records
    reads = flat
    if hasattr(bs, "pairs"):
        reads = (bs.pairs, bs.roots, bs.tri, bs.sph, bs.inst_i, bs.inst_f)

    def record_k6(label, lanes_n, ms, work, any_hit, outs):
        out_bytes = 1 if any_hit else 20
        bound = cs.trace_bound(lanes_n, work, any_hit, cs.BOX_OPS, flat, out_bytes)
        own = cs.trace_bound(lanes_n, work, any_hit, cs.BOX_OPS, reads, out_bytes)
        out[label] = dict(ms=ms, boxes=work[0], prims=work[1], digest=digest(*outs),
                          lanes=lanes_n, bound_over_its_tables=own, **bound)
        print(f"{label} {lanes_n} lanes: {', '.join(f'{v:.4f}' for v in ms)} ms; "
              f"{work[0]} boxes, {work[1]} primitives, bound {bound} (over the "
              f"tables its kernel reads {own}); digest {out[label]['digest']}",
              flush=True)

    record_k6("k6_closest_bounce", nb, k6c, binary.count_work(bs, bo, bd, tmb, False),
              False, binary.trace_binary_raw(bs, bo, bd, tmb))
    occ6 = binary.shadow_occlusion_binary(bs, bo, bd, tms)
    record_k6("k6_anyhit_bounce", nb, k6s, binary.count_work(bs, bo, bd, tms, True),
              True, (occ6,))
    out["k6_anyhit_bounce"]["occluded"] = int(occ6.sum())
    tmp = torch.full((n,), T_INF, device=dev)  # t_max of the primary rays
    ms = [cs.cuda_ms(lambda: binary.trace_binary_raw(bs, o, d, tmp), reps)
          for _ in range(2)]
    record_k6("k6_primary", n, ms, binary.count_work(bs, o, d, tmp, False), False,
              binary.trace_binary_raw(bs, o, d, tmp))

    (t, pp, rounds), (args, _) = cs._first_round(
        (ops_treelet.tl, "run_treelet_trace"),
        lambda: ops_treelet.trace_closest_treelet_packed(ts, bo, bd, active=act,
                                                         with_rounds=True))
    rounds_equal = bool(torch.equal(t, t_b)) and bool(torch.equal(pp, pp_b))
    t1, pp1 = treelet.run_treelet_trace(*args)
    ms = [cs.cuda_ms(lambda: treelet.run_treelet_trace(*args), reps) for _ in range(2)]
    boxes, prims = treelet.count_work(*args)
    w = ts.wscene
    bound = cs.trace_bound(nb, (boxes, prims), False, cs.BOX_OPS,
                           (ts.t_root, ts.t_inst, ts.t_w2o, w.wide_bounds, w.wide_child,
                            w.wide_perm, w.tri_rows, w.sph_rows, args[1]))
    out["k7_round"] = dict(ms=ms, boxes=boxes, prims=prims, digest=digest(t1, pp1),
                           rounds=rounds, rounds_equal_k1=rounds_equal, **bound)
    print(f"k7 first round {nb} lanes: {ms[0]:.4f}, {ms[1]:.4f} ms; {boxes} boxes, "
          f"{prims} primitives, bound {bound}; (t, pp) digest "
          f"{out['k7_round']['digest']}; {rounds} rounds, equal to K1 on every lane: "
          f"{rounds_equal}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="checkout")
    ap.add_argument("--out", default=None, help="append the JSON line to this file")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1k2_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu

    t0 = time.monotonic()
    card = cs.smi_line()
    print(f"[{args.label}] {os.getcwd()}: {card}; torch {torch.__version__}", flush=True)
    cu.build_all()
    lanes = bench_lanes(cs)
    print(f"bench scene: {lanes['o'].shape[0]} primary rays, {lanes['bo'].shape[0]} "
          f"bounce lanes ({lanes['n_alive']} live), {lanes['ts'].n_treelets} treelets",
          flush=True)
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
