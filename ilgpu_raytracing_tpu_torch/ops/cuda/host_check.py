"""Run the port's CUDA kernels (K1/K2, K4/K5, K6, K7, K8, ReSTIR, the sort
key, hit shading and the bounce's lane updates) on the CPU.

A rehearsal for machines without a card or nvcc: compiles the trace sources
(`csrc/wide_trace.cu`, `stream_trace.cu`, `binary_trace.cu`,
`treelet_trace.cu`, `streamtreelet_trace.cu`), `csrc/restir.cu`,
`csrc/sortkey.cu`, `csrc/shade.cu` and `csrc/bounce.cu` for the host with
g++ (a stub `cuda_runtime.h`; each kernel launch becomes a loop over the grid;
`-ffp-contract=off` in place of nvcc's `--fmad=false`), binds the results in
place of the nvcc builds, and runs them through the wrappers' own launch
path on CPU tensors. Scenes: the small terrain and the leaf-64 Cornell box
(streaming tables: K4/K5, and K8 on treelet cuts), the leaf-8 Cornell box
and the default six-instance sphere scene (wide and binary tables: K1/K2,
K6, and K7 on treelet cuts); primary rays and one scattered bounce per hit.
K1/K2 and K4/K5 are held to the plain skip-index walk (hit masks and
occlusion equal, |dt| <= 1e-3, prim agreement > 99.5%); K5 also, with a
tenth of the lanes inactive, to the plain walk and to K4's hit mask at the
same t_max; K6, K7 and K8 to their own
plain versions bit for bit (every output field, on random want masks for
the rounds). The boxes and primitives the counting variant
tallies are printed. The ReSTIR kernel is held to the plain
`ops/restir.restir_direct` on seeded inputs (`restir_case`,
`compare_restir`). The sort key is held to the plain
`ops/sort.ray_key_plain` bit for bit in its three variants (`sortkey_case`,
`compare_sortkey`: treelet boxes of the small terrain, the six-instance
sphere scene and a hand-made table with ties, origins inside a box and
rays that miss; zero, NaN and inf components). Hit shading is held to the
plain `ops/traverse.shade_hits_plain` on the plain walk's hit records
(`shade_case`, `compare_shade`: every output bit for bit but a textured
sphere's albedo, see SHADE_RTOL). The bounce kernels are held to the plain
`ops/integrator.scatter_plain` and `resolve_plain` on every call of recorded
CPU frames and on seeded corner lanes (`bounce_case`, `compare_bounce`:
every output bit for bit but three of `scatter`'s, see BOUNCE_RTOL). Exits
1 on a mismatch. It says nothing about speed, and nothing about what nvcc
accepts.

Run from the repository root:
    python3 -m ilgpu_raytracing_tpu_torch.ops.cuda.host_check
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.utils.build import BUILD_DIR

STUB = """#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
struct float4 { float x, y, z, w; };
struct int4 { int x, y, z, w; };
struct Dim { unsigned x, y, z; };
static Dim blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class T> inline cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline int cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return ""; }
inline float4 __ldg(const float4* p) { return *p; }
inline int4 __ldg(const int4* p) { return *p; }
inline int __ldg(const int* p) { return *p; }
inline float __ldg(const float* p) { return *p; }
inline float __int_as_float(int v) { float f; std::memcpy(&f, &v, sizeof f); return f; }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned atomicMax(unsigned* p, unsigned v) {
  unsigned o = *p; if (v > o) *p = v; return o;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  unsigned long long o = *p; *p += v; return o;
}
using std::min;
"""
SOURCES = ("wide_trace", "stream_trace", "binary_trace", "treelet_trace",
           "streamtreelet_trace")
RESTIR = "restir"
SORTKEY = "sortkey"
SHADE = "shade"
BOUNCE = "bounce"
# kernel<...><<<blocks, THREADS, smem, s>>>(args);  ->  a loop over the grid
LAUNCH = re.compile(r"(\w+(?:<[^>]*>)?)<<<blocks, THREADS, \w+, s>>>\((.*?)\);", re.S)
LOOP = (r"for (unsigned b_ = 0; b_ < unsigned(blocks); ++b_) "
        r"for (unsigned t_ = 0; t_ < unsigned(THREADS); ++t_) { blockIdx.x = b_; "
        r"blockDim.x = THREADS; threadIdx.x = t_; \1(\2); }")


def host_libraries(sources=SOURCES, out_dir=None) -> dict[str, ctypes.CDLL]:
    """g++ builds of `sources` (csrc/<name>.cu), under `out_dir` (default
    _build/host/; a caller running beside another gives its own)."""
    out_dir = out_dir or os.path.join(BUILD_DIR, "host")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cuda_runtime.h"), "w") as f:
        f.write(STUB)
    for name in cu.HEADERS + tuple(src + ".cu" for src in sources):
        with open(os.path.join(cu.CSRC, name)) as f:
            src = LAUNCH.sub(LOOP, f.read())
        if "<<<" in src:
            raise RuntimeError(f"{name}: a launch the host build cannot rewrite")
        host_name = name[:-3] + ".cpp" if name.endswith(".cu") else name
        with open(os.path.join(out_dir, host_name), "w") as f:
            f.write(src)
    libs = {}
    for name in sources:
        so = os.path.join(out_dir, f"lib{name}.so")
        subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-shared",
                        "-fPIC", "-I", out_dir, "-o", so,
                        os.path.join(out_dir, name + ".cpp")], check=True)
        libs[name] = ctypes.CDLL(so)
    return libs


def jittered_rays(cam, w: int, h: int, seed: int):
    from ilgpu_raytracing_tpu_torch.ops import rays

    rng = np.random.default_rng(seed)
    u = (np.arange(w * h) % w + rng.random(w * h)) / w
    v = (np.arange(w * h) // w + rng.random(w * h)) / h
    o, d = rays.generate_rays(cam, torch.as_tensor(u, dtype=torch.float32),
                              torch.as_tensor(v, dtype=torch.float32))
    return o.contiguous(), d.contiguous()


def bounce_rays(scene, hit, o, d, seed: int):
    from ilgpu_raytracing_tpu_torch.ops import traverse

    surf = traverse.shade_hits(scene, hit, o, d)
    rnd = torch.as_tensor(np.random.default_rng(seed).normal(size=o.shape),
                          dtype=torch.float32)
    rnd = rnd / rnd.norm(dim=1, keepdim=True)
    dirs = torch.where(((rnd * surf.normal).sum(1) < 0)[:, None], -rnd, rnd)
    org = surf.pos + surf.normal * 0.0025
    return org[hit.hit].contiguous(), dirs[hit.hit].contiguous()


def check_walks(label, mod, ks, o, d) -> bool:
    """Kernel (through `mod._launch`) vs plain walk on one ray set; prints
    the comparison and the counting variant's tallies, returns the verdict."""
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    n = o.shape[0]
    tm = torch.full((n,), T_INF)
    t_k, pp_k = mod._launch(ks, o, d, tm, any_hit=False)
    t_p, pp_p = mod.trace_closest_plain(ks, o, d, tm)
    hit_k, hit_p = pp_k >= 0, pp_p >= 0
    both = hit_k & hit_p
    dt = (t_k - t_p).abs()[both]
    agree = float((pp_k == pp_p)[both].float().mean()) if bool(both.any()) else 1.0
    ok = bool(torch.equal(hit_k, hit_p)) and not bool((dt > 1e-3).any()) and agree > 0.995
    occ_diff = []
    for t_max in (5.0, 1e29):
        tt = torch.full((n,), t_max)
        occ_diff.append(int((mod._launch(ks, o, d, tt, any_hit=True)[0]
                             != mod.shadow_plain(ks, o, d, tt)).sum()))
    ok = ok and not any(occ_diff)
    work = torch.zeros((2,), dtype=torch.int64)
    mod._launch(ks, o, d, tm, any_hit=False, work=work)
    n_hit = max(1, int(hit_k.sum()))
    print(f"{label}: {n} rays, {int(hit_k.sum())} hits, hit masks "
          f"{'equal' if torch.equal(hit_k, hit_p) else 'DIFFER'}, max |dt| "
          f"{float(dt.max()) if bool(both.any()) else 0.0:.3e}, prim agreement "
          f"{agree:.5f}, occlusion differs on {occ_diff} (t_max 5, 1e29); "
          f"per ray {int(work[0]) / n:.1f} boxes, {int(work[1]) / n:.1f} "
          f"primitives ({int(work[1]) / n_hit:.1f} per hit) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def check_anyhit(label, ss, o, d, seed: int) -> bool:
    """K5 (host build) with some lanes inactive: occlusion equal to the plain
    walk and to K4's hit mask at t_max 5 and 1e29; prints K5's
    SIMD-efficiency count."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream

    n = o.shape[0]
    act = torch.as_tensor(np.random.default_rng(seed).random(n) < 0.9)
    ok = True
    for t_max in (5.0, 1e29):
        tt = torch.where(act, t_max, 0.0).to(torch.float32)
        occ = stream._launch(ss, o, d, tt, any_hit=True)[0]
        hit_k4 = stream._launch(ss, o, d, tt, any_hit=False)[1] >= 0
        ok = ok and bool(torch.equal(occ, stream.shadow_plain(ss, o, d, tt)))
        ok = ok and bool(torch.equal(occ, hit_k4)) and not bool(occ[~act].any())
    steps, warp_max = stream.anyhit_warp_steps(
        ss, o, d, torch.where(act, 1e29, 0.0).to(torch.float32))
    print(f"{label} K5: {n} rays ({int(act.sum())} active), occlusion at t_max 5 and "
          f"1e29 {'equal' if ok else 'NOT equal'} to the plain walk and K4's hit mask; "
          f"SIMD efficiency {steps / max(1, 32 * warp_max):.4f} -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def _same(a, b) -> bool:
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def check_binary(label, bs, o, d) -> bool:
    """K6 (host build) vs its plain version: every output equal, and the
    counting variant's boxes and primitives equal the skip walk's."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    n = o.shape[0]
    tm = torch.full((n,), T_INF)
    ok = _same(binary._launch(bs, o, d, tm, any_hit=False),
               binary.trace_plain(bs, o, d, tm))
    for t_max in (5.0, 1e29):
        tt = torch.full((n,), t_max)
        ok = ok and bool(torch.equal(binary._launch(bs, o, d, tt, any_hit=True)[0],
                                     binary.shadow_plain(bs, o, d, tt)))
    counts, same_work = [], True  # the counting variant against the skip walk's
    for t_max, any_hit in ((T_INF, False), (1e29, True)):
        tt = torch.full((n,), t_max)
        work, plain = torch.zeros((2,), dtype=torch.int64), [0, 0]
        binary._launch(bs, o, d, tt, any_hit=any_hit, work=work)
        binary._walk_plain(bs, o, d, tt, any_hit, plain)
        counts.append(work.tolist())
        same_work = same_work and work.tolist() == plain
    print(f"{label} K6: {n} rays, outputs and occlusion (t_max 5, 1e29) "
          f"{'equal' if ok else 'DIFFER'}; counts {'equal' if same_work else 'DIFFER'} "
          f"(per ray closest {counts[0][0] / n:.1f} boxes, {counts[0][1] / n:.1f} "
          f"primitives, any-hit {counts[1][0] / n:.1f} boxes, {counts[1][1] / n:.1f} "
          f"primitives) -> {'ok' if ok and same_work else 'FAIL'}", flush=True)
    return ok and same_work


def check_round(label, mod, ks, o, d, tile_rows: int, seed: int) -> bool:
    """One K7/K8 round (host build) vs its plain version on random want
    masks (and on all treelets), with some lanes inactive: t and pp equal."""
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    n = o.shape[0]
    g = -(-n // (tile_rows * 128))
    rng = np.random.default_rng(seed)
    tm = torch.where(torch.as_tensor(rng.random(n) < 0.9), T_INF, 0.0).to(torch.float32)
    ok = True
    full = (1 << ks.n_treelets) - 1
    for bits in (rng.integers(0, 1 << ks.n_treelets, size=g), np.full(g, full)):
        mask = torch.as_tensor(np.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
                               .astype(np.int32))
        ok = ok and _same(mod._launch(ks, mask, o, d, tm, tile_rows),
                          mod.round_plain(ks, mask, o, d, tm, tile_rows))
    work = torch.zeros((2,), dtype=torch.int64)
    mod._launch(ks, mask, o, d, tm, tile_rows, work)
    print(f"{label} round ({ks.n_treelets} treelets, {g} packets): t and pp "
          f"{'equal' if ok else 'DIFFER'}; all-treelet round per ray "
          f"{int(work[0]) / n:.1f} boxes, {int(work[1]) / n:.1f} primitives -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def primary_hits(mod, ks, o, d):
    """Plain closest hits of the primary rays, decoded (the bounce origins)."""
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    t, pp = mod.trace_closest_plain(ks, o, d, torch.full((o.shape[0],), T_INF))
    decode = getattr(mod, "decode_stream_hits", None) or mod.decode_wide_hits
    return decode(ks, o, d, t, pp)


def restir_case(width: int, height: int, reps: int, pixel_major: bool, seed: int,
                **kw) -> dict:
    """Seeded keyword arguments of `ops/restir.restir_direct` on CPU tensors:
    a width x height G-buffer of a wavy surface of four objects in front of
    the default camera (some pixels missed, obj_id -1), seeded previous
    reservoirs, `reps` sample views of every pixel (stacked tiles, or a
    pixel's views adjacent with `pixel_major`), a tenth of the lanes
    inactive, the reuse masks on 80% of the active lanes, and a previous
    camera moved sideways so that reprojection and the spatial neighbours
    run off the image's edges. `kw` overrides any argument."""
    from ilgpu_raytracing_tpu_torch.models.camera import Camera
    from ilgpu_raytracing_tpu_torch.ops import integrator, layout, rays, restir, sky
    from ilgpu_raytracing_tpu_torch.utils import vec

    rng = np.random.default_rng(seed)
    g = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)
    cam = Camera.create(width, height)
    p = width * height
    px, py = layout.xy_from_position(torch.arange(p, dtype=torch.int32), width, height)
    o, d = rays.generate_rays(cam, (px.float() + 0.5) / width, (py.float() + 0.5) / height)
    t = 2.5 + 0.4 * torch.sin(px.float() * 0.35) * torch.cos(py.float() * 0.2)
    pos = (o + d * t[:, None]).contiguous()
    normal = vec.normalize(-d + 0.25 * g(rng.normal(size=(p, 3))))
    obj = (px * 2 // width + 2 * (py * 2 // height)).to(torch.int32)
    obj = torch.where(g(rng.random(p) < 0.05, torch.bool), -1, obj)
    gb = integrator.GBuffer(
        pos=pos, normal=normal, albedo=g(rng.uniform(0, 1, (p, 3))),
        shading=torch.zeros(p, dtype=torch.int32), ior=torch.zeros(p), obj_id=obj,
        hit=obj >= 0)
    wi = rng.normal(size=(p, 3))
    prev = restir.Reservoirs(
        L=g(rng.uniform(0, 3, (p, 3))), wi=g(wi / np.linalg.norm(wi, axis=1, keepdims=True)),
        pdf=g(rng.uniform(0.05, 1, p)), w=g(rng.uniform(0.0, 1, p)),
        w_sum=g(rng.uniform(0.0, 5, p)), m=g(rng.integers(0, 20, p), torch.int32),
        light_id=g(rng.integers(1, 3, p), torch.int32), W=g(rng.uniform(0.0, 2, p)))
    lanes = reps * p

    def tile(x):
        return x.repeat_interleave(reps, dim=0) if pixel_major else x.repeat(
            (reps,) + (1,) * (x.dim() - 1))

    active = g(rng.random(lanes) < 0.9, torch.bool)
    args = dict(
        scene_unused=None, gb=gb, res_prev=prev,
        state=g(rng.integers(1, 2 ** 32, size=lanes) | 1, torch.int64), active=active,
        pos=tile(gb.pos), n=tile(gb.normal), albedo=tile(gb.albedo),
        pixel_idx=tile(torch.arange(p, dtype=torch.int32)), width=width, height=height,
        frame=int(rng.integers(0, 2 ** 31)), prev_cam=cam.translate([0.04, 0.02, 0.0]),
        cam_origin=g(cam.origin), sun_dir=sky.sun_direction(0.3, 0.6),
        sun_radiance=(10.0, 9.5, 9.0), sky_top=(0.5, 0.7, 1.0), sky_bottom=(1.0, 1.0, 1.0),
        enable_temporal=active & g(rng.random(lanes) < 0.8, torch.bool),
        enable_spatial=active & g(rng.random(lanes) < 0.8, torch.bool),
        local_candidates=8, delta_candidates=1, reps=reps, reps_pixel_major=pixel_major)
    args.update(kw)
    return args


# Float outputs of the host build against the plain version on the CPU:
# PyTorch's CPU float32 sqrt, cos and sin are not the C library's to the
# last bit (its sqrt is not always correctly rounded), so a local
# candidate's direction, and all that is computed from it, may differ by a
# few ulp (the largest relative difference seen over 24 seeded cases is
# 1.4e-6); every integer output is exact.
RESTIR_RTOL = 1e-5
RESTIR_ATOL = 1e-6


def compare_restir(args: dict) -> dict:
    """The kernel (`ops/restir.restir_direct_kernel`, a host build bound in
    place of the nvcc one) and `restir_direct_plain` on `args`. Returns per
    output the lanes that differ: integers (state, m, light_id, ok, is_sun)
    at all, floats beyond RESTIR_RTOL / RESTIR_ATOL."""
    from ilgpu_raytracing_tpu_torch.ops import restir

    (st_p, res_p, sel_p), (st_k, res_k, sel_k) = (
        restir.restir_direct_plain(**args), restir.restir_direct_kernel(**args))
    pairs = {"state": (st_p, st_k)}
    pairs.update({k: (getattr(res_p, k), getattr(res_k, k)) for k in vars(res_p)})
    pairs.update({f"sel.{k}": (sel_p[k], sel_k[k]) for k in sel_p})
    out = {}
    for k, (a, b) in pairs.items():
        if a.dtype.is_floating_point:
            bad = ~torch.isclose(b, a, rtol=RESTIR_RTOL, atol=RESTIR_ATOL, equal_nan=True)
        else:
            bad = a != b
        out[k] = int(bad.reshape(a.shape[0], -1).any(dim=1).sum())
    return out


def check_restir(label: str, args: dict) -> bool:
    """compare_restir, printed; True when no output differs."""
    diff = compare_restir(args)
    ok = not any(diff.values())
    print(f"ReSTIR {label}: {args['state'].shape[0]} lanes, lanes that differ "
          f"{diff} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


RESTIR_CASES = {
    "reuse": dict(width=64, height=64, reps=1, pixel_major=False),
    "reference_weighting": dict(width=64, height=64, reps=1, pixel_major=False,
                                reference_weighting=True),
    "candidates_only": dict(width=64, height=64, reps=1, pixel_major=False,
                            static_reuse=False),
    "candidates_only_reference": dict(width=64, height=64, reps=1, pixel_major=False,
                                      static_reuse=False, reference_weighting=True),
    "reps2_tiles": dict(width=64, height=64, reps=2, pixel_major=False),
    "reps2_pixel_major": dict(width=64, height=64, reps=2, pixel_major=True),
    "reps2_pixel_major_reference": dict(width=64, height=64, reps=2, pixel_major=True,
                                        reference_weighting=True),
    "row_major_image": dict(width=40, height=24, reps=2, pixel_major=False),
}


def restir_args(case: str, seed: int) -> dict:
    """restir_case's arguments for one of RESTIR_CASES."""
    kw = dict(RESTIR_CASES[case])
    return restir_case(kw.pop("width"), kw.pop("height"), kw.pop("reps"),
                       kw.pop("pixel_major"), seed, **kw)


# Hand-made treelet boxes (lo xyz, hi xyz): boxes 1 and 3 share the entry
# face x = 4 over y, z in [-1, 1], so a ray along +x from x < 4 enters both
# at the same t and box 1 must win; box 0 holds the origins of
# `_edge_rays`'s inside rays (their entry is the 1e-4 floor); box 2 lies off
# every edge ray's path.
HAND_BOXES = ((-12.0, -12.0, -12.0, -8.0, -8.0, -8.0),
              (4.0, -1.0, -1.0, 6.0, 1.0, 1.0),
              (20.0, 20.0, 20.0, 21.0, 21.0, 21.0),
              (4.0, -2.0, -2.0, 5.0, 2.0, 2.0))


def _edge_rays():
    """(o, d) rows that reach the key's corners: axis rays onto the tied
    faces, origins inside box 0, zero, signed-zero, subnormal, NaN and inf
    direction components, NaN and inf origins, and a ray that starts on a
    face."""
    nan, inf, sub = float("nan"), float("inf"), 1e-40
    rows = [
        ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0)),  # tie of boxes 1 and 3 at t = 4
        ((0.0, 0.5, -0.5), (2.0, 0.0, -0.0)),
        ((-10.0, -10.0, -10.0), (1.0, 1.0, 1.0)),  # inside box 0
        ((-9.0, -11.0, -10.0), (0.0, 0.0, -1.0)),
        ((4.0, 0.0, 0.0), (1.0, 0.0, 0.0)),  # on box 1's and 3's face
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
        ((0.0, 0.0, 0.0), (-0.0, -0.0, -0.0)),
        ((0.0, 0.0, 0.0), (sub, 0.0, 0.0)),  # 1 / d overflows to inf
        ((0.0, 0.0, 0.0), (sub, sub, -sub)),
        ((nan, 0.0, 0.0), (1.0, 0.0, 0.0)),
        ((0.0, 0.0, 0.0), (nan, 0.3, 0.1)),
        ((inf, 0.0, 0.0), (-1.0, 0.0, 0.0)),
        ((-inf, -inf, -inf), (1.0, 1.0, 1.0)),
        ((0.0, 0.0, 0.0), (inf, 0.0, 0.0)),
        ((0.0, 0.0, 0.0), (-inf, inf, -inf)),
        ((1e30, 1e30, 1e30), (-1.0, -1.0, -1.0)),
    ]
    o = torch.tensor([r[0] for r in rows], dtype=torch.float32)
    d = torch.tensor([r[1] for r in rows], dtype=torch.float32)
    return o, d


def sortkey_rays(lo, hi, n: int, seed: int):
    """n seeded rays whose origins lie in the box [lo, hi] grown by a
    quarter of its size a side, with unit-normal directions; a tenth of the
    lanes inactive, some direction components zeroed, and `_edge_rays`
    appended twice (live, then dead)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    pad = 0.25 * (hi - lo)
    o = rng.uniform(lo - pad, hi + pad, (n, 3))
    d = rng.normal(size=(n, 3))
    d[rng.random((n, 3)) < 0.05] = 0.0
    eo, ed = _edge_rays()
    o = torch.cat([torch.as_tensor(o, dtype=torch.float32), eo, eo])
    d = torch.cat([torch.as_tensor(d, dtype=torch.float32), ed, ed])
    act = torch.as_tensor(np.concatenate([rng.random(n) >= 0.1, np.ones(len(eo), bool),
                                          np.zeros(len(eo), bool)]))
    return o.contiguous(), d.contiguous(), act


def sortkey_case(case: str, seed: int, n: int = 4000) -> dict:
    """Keyword arguments of `ops/sort.ray_key_plain` for one of
    SORTKEY_CASES, on CPU tensors: its scene's treelet boxes (or Morton
    bounds, or neither) and `sortkey_rays` over the scene's bounds."""
    from ilgpu_raytracing_tpu_torch.models import cornell, terrain
    from ilgpu_raytracing_tpu_torch.models.bvh import cut_scene_treelets
    from ilgpu_raytracing_tpu_torch.models.scene import build_default_scene

    scene_of = {
        "terrain": lambda: terrain.build_terrain_scene(grid_x=64, grid_z=32,
                                                       device="cpu")[1],
        "spheres": lambda: build_default_scene(single_instance=False, device="cpu")[1],
        "cornell": lambda: cornell.build_cornell_scene(tess=4, sphere_tess=(8, 12),
                                                       device="cpu")[1],
    }
    scene_name, variant = SORTKEY_CASES[case]
    treelet = morton = None
    if scene_name == "hand":
        treelet = torch.tensor(HAND_BOXES, dtype=torch.float32)
        lo, hi = treelet[:, :3].amin(0), treelet[:, 3:].amax(0)
    else:
        scene = scene_of[scene_name]()
        lo, hi = torch.amin(scene.inst_bmin, dim=0), torch.amax(scene.inst_bmax, dim=0)
        if variant == "treelet":
            treelet = torch.as_tensor(cut_scene_treelets(scene, 32), dtype=torch.float32)
        elif variant == "morton":
            morton = (lo, 1.0 / torch.clamp(hi - lo, min=1e-6))
    o, d, act = sortkey_rays(lo.numpy(), hi.numpy(), n, seed)
    return dict(o=o, d=d, active=act, morton_bounds=morton, treelet_bounds=treelet)


SORTKEY_CASES = {  # case: (scene, key variant)
    "terrain_treelet": ("terrain", "treelet"),  # 32 boxes
    "spheres_treelet": ("spheres", "treelet"),  # 6 boxes
    "hand_treelet": ("hand", "treelet"),
    "cornell_morton": ("cornell", "morton"),
    "cornell_octant": ("cornell", "octant"),
}


def compare_sortkey(args: dict) -> int:
    """Lanes on which the kernel's key (`ops/cuda/sortkey.ray_key`, a host
    build bound in place of the nvcc one) differs from
    `ops/sort.ray_key_plain`'s on `args`."""
    from ilgpu_raytracing_tpu_torch.ops import sort
    from ilgpu_raytracing_tpu_torch.ops.cuda import sortkey

    return int((sortkey.ray_key(**args) != sort.ray_key_plain(**args)).sum())


def check_sortkey(case: str, args: dict) -> bool:
    """compare_sortkey, printed; True when every key is equal."""
    diff = compare_sortkey(args)
    print(f"sort key {case}: {args['o'].shape[0]} rays, keys that differ {diff} -> "
          f"{'ok' if diff == 0 else 'FAIL'}", flush=True)
    return diff == 0


def _shade_builder_scene():
    """A SceneBuilder scene of every branch of the shading: a textured
    sphere in a rotated, scaled and moved instance; a sphere whose material
    kd is zero (its own albedo shows); a glass sphere (its own ior, and a
    kd with one zero channel, which shows); a sphere whose texture id lies past the table (white); two textured,
    two-sided grids, one in a rotated instance, with uvs beyond [0, 1]
    (wrap) and per-triangle materials: a 13x7 random texture, a checker, an
    empty texture (white), a mirror material of ior 0 (read as 1)."""
    from ilgpu_raytracing_tpu_torch.models.materials import (
        SHADING_GLASS,
        SHADING_MIRROR,
        Material,
    )
    from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder

    rng = np.random.default_rng(7)
    b = SceneBuilder(blas_leaf_size=4, bvh_method="sah")
    t_rand = b.add_texture_rgba(rng.integers(0, 256, (7, 13, 4), dtype=np.uint8))
    t_check = b.add_checker_texture(16, 8, 2, (250, 30, 30, 255), (20, 200, 90, 255))
    t_empty = b.add_texture_rgba(np.zeros((0, 4, 4), np.uint8))
    mats = [b.add_material(m) for m in (
        Material(kd=(1.0, 1.0, 1.0), diffuse_tex=t_rand),
        Material(kd=(0.0, 0.0, 0.0)),
        Material(kd=(0.0, 1.0, 1.0), shading=SHADING_GLASS, ior=1.5),
        Material(kd=(0.3, 0.3, 0.9), diffuse_tex=99, two_sided=True),
        Material(kd=(0.5, 0.5, 0.5), diffuse_tex=t_check, two_sided=True),
        Material(kd=(0.2, 0.6, 0.3), shading=SHADING_MIRROR, ior=0.0),
        Material(kd=(0.7, 0.2, 0.2), diffuse_tex=t_empty),
        Material(kd=(0.9, 0.8, 0.1), diffuse_tex=t_rand, two_sided=True),
    )]
    s_tex = b.add_sphere((0.0, 0.0, 0.0), 0.6, material=mats[0])
    s_zero = b.add_sphere((-1.5, 0.3, 0.5), 0.4, (0.9, 0.5, 0.1), mats[1])
    s_glass = b.add_sphere((1.4, 0.2, -0.4), 0.45, material=mats[2], shading=SHADING_GLASS,
                           ior=1.5)
    s_bad = b.add_sphere((0.2, 1.3, -1.0), 0.3, material=mats[3])
    b.add_sphere_instance([s_zero, s_glass, s_bad])
    c, s_ = np.cos(0.7), np.sin(0.7)
    rot_y = np.array([[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]])
    b.add_sphere_instance([s_tex], np.hstack([1.5 * rot_y, [[0.3], [0.4], [0.8]]]))

    k = 4  # a k x k grid of quads over [-2, 2]^2 at y = 0
    g = np.linspace(-2.0, 2.0, k + 1)
    xs, zs = np.meshgrid(g, g)
    pos = np.stack([xs.ravel(), np.zeros(xs.size), zs.ravel()], 1)
    quads = [(r * (k + 1) + q, r * (k + 1) + q + 1, (r + 1) * (k + 1) + q)
             for r in range(k) for q in range(k)]
    tris = np.array(quads + [(a + 1, c_ + 1, c_) for a, _, c_ in quads], np.int32)
    uv = np.stack([(pos[:, 0] + 2.0) - 1.3, (pos[:, 2] + 2.0) * 0.8 - 0.6], 1)
    mesh_mats = np.array(mats[3:])[np.arange(tris.shape[0]) % 5]
    c, s_ = np.cos(1.2), np.sin(1.2)
    rot_x = np.array([[1.0, 0.0, 0.0], [0.0, c, -s_], [0.0, s_, c]])
    for o2w in (np.hstack([np.eye(3), [[0.0], [-0.8], [0.0]]]),
                np.hstack([rot_x, [[0.0], [0.5], [-2.0]]])):
        b.add_mesh_instance(pos, tris, uv[tris], mesh_mats, o2w)
    return b.commit("cpu")


def _rays_at(lo, hi, n: int, seed: int):
    """n rays from a sphere around the box [lo, hi] toward random points
    inside it: every object is seen from every side."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo, np.float64), np.asarray(hi, np.float64)
    mid, radius = 0.5 * (lo + hi), 0.75 * float(np.linalg.norm(hi - lo)) + 1.0
    u = rng.normal(size=(n, 3))
    o = mid + radius * u / np.linalg.norm(u, axis=1, keepdims=True)
    d = rng.uniform(lo, hi, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o, dtype=torch.float32).contiguous(),
            torch.as_tensor(d, dtype=torch.float32).contiguous())


def _camera_lanes(scene, cam, w: int, h: int, seed: int):
    """Primary rays of `cam` and one scattered bounce from each of their
    hits, together: (o, d)."""
    from ilgpu_raytracing_tpu_torch.ops import traverse

    o, d = jittered_rays(cam, w, h, seed)
    bo, bd = bounce_rays(scene, traverse.trace_closest(scene, o, d), o, d, seed + 1)
    return torch.cat([o, bo]).contiguous(), torch.cat([d, bd]).contiguous()


def _clamped_hits(hit, seed: int):
    """`hit` with a seeded tenth of its lanes edited to the records the
    gathers clamp: prim and inst -1 or past their tables, kind 0 on a hit,
    t at the hit limit, +inf and NaN."""
    from ilgpu_raytracing_tpu_torch.ops.traverse import HitRecord

    rng = np.random.default_rng(seed)
    n = hit.t.shape[0]
    edit = torch.as_tensor(rng.integers(0, 10, n))
    pick = lambda j, new, old: torch.where(edit == j, new, old)
    i32 = lambda v: torch.full((n,), v, dtype=torch.int32)
    return HitRecord(
        t=pick(5, float(np.float32(1e29)), pick(6, float("inf"), pick(7, float("nan"),
                                                                    hit.t))),
        kind=pick(4, i32(0), hit.kind),
        prim=pick(0, i32(-1), pick(1, i32(10 ** 6), hit.prim)),
        inst=pick(2, i32(-1), pick(3, i32(99), hit.inst)),
        bu=hit.bu, bv=hit.bv)


def shade_case(case: str, seed: int) -> dict:
    """Arguments of `ops/traverse.shade_hits` (scene, hit, o, d) for one of
    SHADE_CASES, on CPU tensors, the hits from the plain walk."""
    from ilgpu_raytracing_tpu_torch.models import cornell, sponza_like, terrain
    from ilgpu_raytracing_tpu_torch.ops import traverse

    if case == "cornell":
        scene = cornell.build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                                            bvh_method="sah", device="cpu")[1]
        o, d = _camera_lanes(scene, cornell.cornell_camera(64, 64), 64, 64, seed)
    elif case == "terrain":
        scene = terrain.build_terrain_scene(grid_x=64, grid_z=32, device="cpu")[1]
        o, d = _camera_lanes(scene, terrain.terrain_camera(48, 32), 48, 32, seed)
        so, sd = _rays_at((-0.9, 0.6, -0.9), (3.0, 2.5, 2.4), 1024, seed + 2)
        o, d = torch.cat([o, so]).contiguous(), torch.cat([d, sd]).contiguous()
    elif case == "courtyard":
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            scene = sponza_like.build_sponza_like_scene(tmp, device="cpu")[1]
        o, d = _camera_lanes(scene, sponza_like.sponza_camera(64, 48), 64, 48, seed)
    else:
        scene = _shade_builder_scene()
        o, d = _rays_at((-2.2, -1.5, -2.5), (2.2, 2.0, 2.2), 4096, seed)
    hit = traverse.trace_closest(scene, o, d)
    if case == "clamped":
        hit = _clamped_hits(hit, seed)
    return dict(scene=scene, hit=hit, o=o, d=d)


SHADE_CASES = ("cornell", "terrain", "builder", "courtyard", "clamped")

# Albedo of a textured sphere from the host build against the plain version
# on the CPU: PyTorch's CPU float32 atan2 and acos (SLEEF's, vectorised) are
# not the C library's to the last bit, so the sphere's (u, v), and the
# bilinear sample there, may differ by a few ulp. Every other output, and
# every other lane, is held exact.
SHADE_RTOL = 1e-5
SHADE_ATOL = 1e-6


def shade_lanes(args: dict) -> dict:
    """Lanes of `args` by what the shading does there (bool masks): miss,
    sphere, tri, textured (a texture id >= 0), textured_sphere, flipped (a
    two-sided triangle seen from its back)."""
    from ilgpu_raytracing_tpu_torch.ops.texture import take
    from ilgpu_raytracing_tpu_torch.ops.traverse import KIND_SPHERE, KIND_TRI
    from ilgpu_raytracing_tpu_torch.utils import vec

    sc, hit, d = args["scene"], args["hit"], args["d"]
    hit_ = hit.hit
    prim = torch.clamp(hit.prim, min=0)
    sph = hit_ & (hit.kind == KIND_SPHERE)
    tri = hit_ & ~sph
    mat = torch.where(sph, take(sc.sph_mat, prim), take(sc.tri_mat, prim))
    textured = hit_ & (take(sc.mat_diffuse_tex, mat) >= 0)
    n = vec.cross(take(sc.tri_e1, prim), take(sc.tri_e2, prim))
    w2o = take(sc.inst_w2o, torch.clamp(hit.inst, min=0))
    flipped = (tri & (take(sc.mat_two_sided, mat) != 0)
               & (vec.dot(n, vec.transform_vector(w2o, d)) > 0.0))
    return dict(miss=~hit_, sphere=sph, tri=tri & (hit.kind == KIND_TRI), textured=textured,
                textured_sphere=textured & sph, flipped=flipped)


def compare_shade(args: dict) -> dict:
    """The kernel (`ops/traverse.shade_hits_kernel`, a host build bound in
    place of the nvcc one) and `shade_hits_plain` on `args`. Returns per
    output the lanes that differ: every output in any bit, but the albedo
    of a textured sphere beyond SHADE_RTOL / SHADE_ATOL."""
    from ilgpu_raytracing_tpu_torch.ops import traverse

    plain = traverse.shade_hits_plain(**args)
    kern = traverse.shade_hits_kernel(**args)
    loose = shade_lanes(args)["textured_sphere"]
    out = {}
    for k in vars(plain):
        a, b = getattr(plain, k), getattr(kern, k)
        if a.dtype != b.dtype or a.shape != b.shape or not b.is_contiguous():
            out[k] = a.shape[0]
            continue
        bits = a.view(torch.int32) != b.view(torch.int32) if a.is_floating_point() else a != b
        bad = bits.reshape(a.shape[0], -1).any(dim=1)
        if k == "albedo":
            near = torch.isclose(b, a, rtol=SHADE_RTOL, atol=SHADE_ATOL).all(dim=1)
            bad = bad & ~(loose & near)
        out[k] = int(bad.sum())
    return out


def check_shade(case: str, args: dict) -> bool:
    """compare_shade, printed with the lanes of each kind; True when no
    output differs."""
    diff = compare_shade(args)
    kinds = {k: int(v.sum()) for k, v in shade_lanes(args).items()}
    ok = not any(diff.values())
    print(f"shade {case}: {args['o'].shape[0]} lanes {kinds}, lanes that differ {diff} -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok


def clone_args(x):
    """A deep copy of a recorded argument: tensors cloned, through
    dataclasses and dicts of them; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: clone_args(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: clone_args(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x


def record_bounces(renderer, frames: int = 1) -> list:
    """The `ops/integrator.scatter` and `resolve` calls of `frames` frames
    of `renderer`, in order: ("scatter" | "resolve", positional arguments
    cloned). The frames run the plain bodies on CPU tensors."""
    from ilgpu_raytracing_tpu_torch.ops import integrator

    calls = []
    real = integrator.scatter, integrator.resolve

    def spy(kind, fn):
        def run(*args):
            calls.append((kind, [clone_args(a) for a in args]))
            return fn(*args)
        return run

    integrator.scatter, integrator.resolve = spy("scatter", real[0]), spy("resolve", real[1])
    try:
        for _ in range(frames):
            renderer.render()
    finally:
        integrator.scatter, integrator.resolve = real
    return calls


def _bounce_frame(case: str):
    """(scene, camera, RenderConfig) of a scene-recorded BOUNCE_CASES case at
    48x32 (32x21 traced)."""
    import tempfile

    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models import cornell, sponza_like, terrain
    from ilgpu_raytracing_tpu_torch.models.camera import Camera
    from ilgpu_raytracing_tpu_torch.models.scene import build_default_scene

    w, h = 48, 32
    if case in ("cornell", "deferred", "cornell_no_dedup"):
        scene = cornell.build_cornell_scene(tess=4, sphere_tess=(8, 12), device="cpu")[1]
        return scene, cornell.cornell_camera(w, h), RenderConfig(
            spp=2, max_depth=3, deferred_shadows=case == "deferred",
            dedup_sun_shadow=case != "cornell_no_dedup")
    if case == "terrain":
        scene = terrain.build_terrain_scene(grid_x=64, grid_z=32, blas_leaf_size=8,
                                            device="cpu")[1]
        return scene, terrain.terrain_camera(w, h), RenderConfig(spp=2, max_depth=3)
    if case == "alpha":
        with tempfile.TemporaryDirectory() as tmp:
            scene = sponza_like.build_sponza_like_scene(tmp, device="cpu")[1]
        return scene, sponza_like.sponza_camera(w, h), RenderConfig(spp=2, max_depth=3)
    # the default six spheres: glass, mirror and lambert; roulette from bounce 1
    scene = build_default_scene(single_instance=False, device="cpu")[1]
    return scene, Camera.create(w, h), RenderConfig(
        spp=4, max_depth=4, rr_start_depth=1,
        shadow_rr_lum=0.0 if case == "spheres_no_shadow_rr" else 0.3)


def _edge_lanes(n: int, seed: int, cfg, final: bool) -> list:
    """Seeded lanes of one bounce that reach the branches' corners, as
    recorded calls [("scatter", args), ("resolve", args)]: every shading
    code (and one the integrator does not know), glass seen from inside at
    grazing angles (total internal reflection), glass of zero albedo and of
    ior 0 and -1, dead lanes, a tenth of the selections exactly this
    frame's sun and a tenth one ulp off it in one component (a stale wi),
    zero and NaN throughput, the bounce at `rr_start_depth`; the scatter
    ray's hits at, below and above the hit limit."""
    from ilgpu_raytracing_tpu_torch.ops import integrator, restir, sky, traverse
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_HIT_MAX, T_INF
    from ilgpu_raytracing_tpu_torch.utils import vec

    rng = np.random.default_rng(seed)
    g = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), dtype=dt)
    unit = lambda: vec.normalize(g(rng.normal(size=(n, 3))))
    pick = lambda p: g(rng.random(n) < p, torch.bool)
    nrm = unit()
    view = unit()
    # a fifth inside the glass, leaving it at up to 80 degrees from the
    # normal: past the critical angle on most (total internal reflection)
    glass_in = pick(0.2)
    tangent = vec.normalize(vec.cross(nrm, unit()))
    lift = g(rng.uniform(0.18, 1.0, n))[:, None]
    view = torch.where(glass_in[:, None], vec.normalize(tangent + nrm * lift), view)
    alb = g(rng.uniform(0, 1, (n, 3)))
    alb = torch.where(pick(0.15)[:, None], 0.0, alb)
    thr = g(rng.uniform(0, 1.5, (n, 3)))
    thr = torch.where(pick(0.05)[:, None], 0.0, thr)
    thr[g(rng.random(n) < 0.01, torch.bool), 1] = float("nan")
    shade = g(rng.choice([0, 1, 2, 2, 3], n), torch.int32)
    shade = torch.where(glass_in, 2, shade).to(torch.int32)
    ior = g(rng.choice([1.5, 1.33, 0.0, -1.0, 2.4], n))

    def reservoirs():
        return restir.Reservoirs(
            L=g(rng.uniform(0, 3, (n, 3))), wi=unit(), pdf=g(rng.uniform(0.05, 1, n)),
            w=g(rng.uniform(0, 1, n)), w_sum=g(rng.uniform(0, 5, n)),
            m=g(rng.integers(0, 20, n), torch.int32),
            light_id=g(rng.integers(1, 3, n), torch.int32), W=g(rng.uniform(0, 2, n)))

    sun = vec.normalize(g(sky.sun_direction(0.3, 0.6)))
    wi = unit()
    exact, stale = pick(0.1), pick(0.1)
    # one ulp off the sun in one component a lane
    axis = torch.nn.functional.one_hot(g(rng.integers(0, 3, n), torch.int64), 3).bool()
    off = torch.where(axis, torch.nextafter(sun, torch.ones(3)), sun)
    wi = torch.where(stale[:, None], off, wi)
    wi = torch.where(exact[:, None], sun, wi)
    lanes = integrator.PathLanes(
        pos=g(rng.uniform(-3, 3, (n, 3))), nrm=nrm, alb=alb, shade=shade, ior=ior, thr=thr,
        li=g(rng.uniform(0, 2, (n, 3))), alive=pick(0.85), view=view,
        state=g(rng.integers(1, 2 ** 32, n), torch.int64), wrote=pick(0.3),
        res_cur=reservoirs())
    res_out = reservoirs()
    sel = dict(ok=pick(0.8), wi=wi, contrib=g(rng.uniform(0, 2, (n, 3))),
               is_sun=pick(0.5) | exact | stale)
    args = [lanes, g(rng.integers(1, 2 ** 32, n), torch.int64), res_out, sel, cfg,
            cfg.rr_start_depth, final, pick(0.5), sun]
    sc = integrator.scatter_plain(*args)
    t = g(rng.uniform(0.1, 10, n))
    t = torch.where(pick(0.3), T_INF, t)
    t = torch.where(pick(0.05), float(np.float32(T_HIT_MAX)), t)
    t = torch.where(pick(0.05), float(np.nextafter(np.float32(T_HIT_MAX), np.float32(0))), t)
    i32 = lambda: torch.zeros(n, dtype=torch.int32)
    hit = traverse.HitRecord(t=t, kind=i32(), prim=i32(), inst=i32(), bu=t, bv=t)
    surf = traverse.Surface(pos=g(rng.uniform(-3, 3, (n, 3))), normal=unit(),
                            albedo=g(rng.uniform(0, 1, (n, 3))),
                            shading=g(rng.integers(0, 3, n), torch.int32),
                            ior=g(rng.uniform(1, 2, n)), obj_id=i32())
    occ = pick(0.4)
    res = [lanes, sc, cfg, occ] + ([pick(0.5), None, None] if final else [None, hit, surf])
    return [("scatter", args), ("resolve", res)]


def bounce_case(case: str, seed: int) -> list:
    """The recorded calls of one of BOUNCE_CASES, on CPU tensors:
    [("scatter" | "resolve", positional arguments), ...]. A scene case is
    one frame of its scene (every bounce: the sun substitution at bounce 0
    but in `cornell_no_dedup`, which traces the sun like any other light,
    roulette from `rr_start_depth`, the final bounce's sky test or, with
    alpha, its closest hit); an `edges` case is `_edge_lanes`."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    if case.startswith("edges"):
        cfg = RenderConfig(shadow_rr_lum=0.0 if case == "edges_no_shadow_rr" else 0.3)
        return _edge_lanes(3000, seed, cfg, final=case != "edges")
    scene, cam, cfg = _bounce_frame(case)
    cfg = dataclasses.replace(cfg, rng_salt=seed)
    r = Renderer(48, 32, cfg, scene, cam, device="cpu")
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    return record_bounces(r)


BOUNCE_CASES = ("cornell", "terrain", "spheres", "spheres_no_shadow_rr", "deferred", "alpha",
                "cornell_no_dedup", "edges", "edges_final", "edges_no_shadow_rr")

# Float outputs of the host build's `scatter` against the plain body on the
# CPU: PyTorch's CPU float32 sqrt, rsqrt, cos and sin are not the C
# library's to the last bit, so the lambert sample and the refracted
# direction (`new_dir`), the scatter ray's origin offset along them
# (`ray_o`) and the sky weight read along them (`sky_w`) may differ by a
# few ulp. Every other output, integers, masks and the RNG state included,
# and every output of `resolve` is held exact.
BOUNCE_RTOL = 1e-5
BOUNCE_ATOL = 1e-6
BOUNCE_LOOSE = ("new_dir", "ray_o", "sky_w")


def lane_fields(x, prefix="") -> dict:
    """The tensors of a Scattered or PathLanes, reservoir fields as res.<k>."""
    out = {}
    for f in dataclasses.fields(x):
        v = getattr(x, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif v is not None:
            out.update(lane_fields(v, "res."))
    return out


def compare_bounce(kind: str, args: list, loose=BOUNCE_LOOSE) -> dict:
    """One recorded call through the kernel (`ops/integrator.scatter_kernel`
    or `resolve_kernel`: on the CPU a host build bound in place of the nvcc
    one) and the plain body. Returns per output the lanes that differ: any
    bit (NaN against NaN aside), but `loose` outputs of `scatter` beyond
    BOUNCE_RTOL / BOUNCE_ATOL; an output missing on one side counts every
    lane."""
    from ilgpu_raytracing_tpu_torch.ops import integrator

    plain = lane_fields(getattr(integrator, kind + "_plain")(*args))
    kern = lane_fields(getattr(integrator, kind + "_kernel")(*args))
    out = {}
    for k, a in plain.items():
        b = kern.get(k)
        if b is None or a.dtype != b.dtype or a.shape != b.shape:
            out[k] = a.shape[0]
            continue
        if a.is_floating_point():
            bad = (a.view(torch.int32) != b.view(torch.int32)) & ~(a.isnan() & b.isnan())
            if kind == "scatter" and k in loose:
                bad = bad & ~torch.isclose(b, a, rtol=BOUNCE_RTOL, atol=BOUNCE_ATOL)
        else:
            bad = a != b
        out[k] = int(bad.reshape(a.shape[0], -1).any(dim=1).sum())
    out.update({k: kern[k].shape[0] for k in kern.keys() - plain.keys()})
    return out


def check_bounce(case: str, calls: list) -> bool:
    """compare_bounce on every call of a case, printed; True when no output
    differs."""
    diff = [compare_bounce(kind, args) for kind, args in calls]
    bad = [{k: v for k, v in d.items() if v} for d in diff]
    ok = not any(bad)
    lanes = calls[0][1][0].pos.shape[0]
    print(f"bounce {case}: {len(calls)} calls of {lanes} lanes, outputs that differ "
          f"{bad} -> {'ok' if ok else 'FAIL'}", flush=True)
    return ok


def main() -> int:
    torch.set_num_threads(1)  # one thread: the plain versions run as in the tests
    libs = host_libraries(SOURCES + (RESTIR, SORTKEY, SHADE, BOUNCE))
    cu.load_kernel_library = lambda name: (libs[name], 0.0)
    cu.stream_ptr = lambda t: None

    from ilgpu_raytracing_tpu_torch.models import cornell, terrain
    from ilgpu_raytracing_tpu_torch.models.camera import Camera
    from ilgpu_raytracing_tpu_torch.models.scene import build_default_scene
    from ilgpu_raytracing_tpu_torch.ops.cuda import (
        binary,
        stream,
        streamtreelet,
        treelet,
        wide,
    )

    cases = (
        ("small terrain", stream,
         terrain.build_terrain_scene(grid_x=64, grid_z=32, device="cpu")[1],
         terrain.terrain_camera(96, 64)),
        ("Cornell leaf 64", stream,
         cornell.build_cornell_scene(tess=6, sphere_tess=(10, 14), blas_leaf_size=64,
                                     bvh_method="sah", device="cpu")[1],
         cornell.cornell_camera(96, 64)),
        ("Cornell leaf 8", wide,
         cornell.build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                                     bvh_method="sah", device="cpu")[1],
         cornell.cornell_camera(96, 64)),
        ("default 6-sphere", wide,
         build_default_scene(single_instance=False, device="cpu")[1],
         Camera.create(96, 64)),
    )
    ok = True
    for label, mod, scene, cam in cases:
        ks = stream.prepare_stream(scene) if mod is stream else wide.prepare_scene(scene)
        o, d = jittered_rays(cam, 96, 64, 1)
        ok &= check_walks(f"{label} primary", mod, ks, o, d)
        hit = primary_hits(mod, ks, o, d)
        bo, bd = bounce_rays(scene, hit, o, d, 2)
        ok &= check_walks(f"{label} bounce", mod, ks, bo, bd)
        if mod is wide:
            bs = binary.prepare_binary(scene)
            ok &= check_binary(f"{label} primary", bs, o, d)
            ok &= check_binary(f"{label} bounce", bs, bo, bd)
            ts = treelet.prepare_treelets(ks, 8)
            ok &= check_round(f"{label} bounce K7", treelet, ts, bo, bd, 1, 3)
        else:
            ok &= check_anyhit(f"{label} bounce", ks, bo, bd, 4)
            sts = streamtreelet.prepare_treelets_stream(ks, 8)
            ok &= check_round(f"{label} bounce K8", streamtreelet, sts, bo, bd, 1, 3)
    for case in RESTIR_CASES:
        ok &= check_restir(case, restir_args(case, 5))
    for case in SORTKEY_CASES:
        ok &= check_sortkey(case, sortkey_case(case, 6))
    for case in SHADE_CASES:
        ok &= check_shade(case, shade_case(case, 8))
    for case in BOUNCE_CASES:
        ok &= check_bounce(case, bounce_case(case, 9))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
