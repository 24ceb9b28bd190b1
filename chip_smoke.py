#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main path -- the 1920x1080 Cornell bench frame that
`bench.py` renders (15,552 triangles, SAH BVH with leaf 8, spp=2,
max_depth=3, internal 1280x704) -- through `Renderer` on the card, after
checking every hand-written kernel of that path against its plain PyTorch
version on the card:

  1. device: the card's name and power limit;
  2. build: nvcc builds every kernel from csrc/ (sm_90a);
  3. K3 counting-sort positions vs the one-hot plain version, exact,
     on 1,802,240 keys (129 and 16 bins);
  4. K1 closest hit / K2 any-hit vs the plain skip-index walk on the bench
     scene: primary rays and 1,802,240 sorted bounce rays, held to the bar
     of tests/test_wide_kernel.py (hit masks agree, relative t mismatch
     above 1e-3 on < 0.5% of rays, shadow agreement > 99.5%); the same
     bar on the default 6-sphere scene and a scene with transformed
     instances;
  5. a 64x64 Cornell frame pair rendered with the kernels on the card and
     with the plain versions on the CPU, held to the golden-image bar;
  6. the main path: one warm-up and 6 timed 1080p frames, each copied to
     the host, with every kernel's launch count checked.

Prints the kernels' JSON line, the card line, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits nonzero.
Needs one CUDA card; run from the repository root: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 6
T_REL_TOL = 1e-3


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean wall time of fn() on the card over `reps` runs after a warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def phase_k3(dev, results):
    from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos

    n = 1_802_240
    rng = np.random.default_rng(7)
    for bins in (129, 16):
        live = int(n * 0.7)
        key = np.concatenate([
            rng.integers(0, bins - 1, size=live), np.full(n - live, bins - 1)
        ]).astype(np.int32)
        kt = torch.as_tensor(key, device=dev)
        got = sortpos.counting_pos(kt, bins)
        want = sortpos.counting_pos_plain(kt, bins)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        check(err == 0, f"K3 differs from its plain version at bins={bins}")
        log(f"K3 bins={bins} n={n}: exact")
        if bins == 129:
            ms = cuda_ms(lambda: sortpos.counting_pos(kt, bins), 20)
            plain_ms = cuda_ms(lambda: sortpos.counting_pos_plain(kt, bins), 3)
            log(f"K3 {n} lanes x 129 bins: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            results["sortpos"] = dict(max_abs_err=float(err), ms=ms, plain_ms=plain_ms)


def _trace_bar(ws, o, d, label):
    """K1/K2 vs plain on one ray set. Returns K1's max |t_kernel - t_plain|
    over rays both hit, and 1.0 if K2 differs from plain on any ray."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    n = o.shape[0]
    tm = torch.full((n,), T_INF, device=o.device)
    t_k, pp_k = wide.trace_closest_wide_packed(ws, o, d)
    t_p, pp_p = wide.trace_closest_plain(ws, o, d, tm)
    hit_k, hit_p = pp_k >= 0, pp_p >= 0
    n_hit_diff = int((hit_k != hit_p).sum())
    check(n_hit_diff == 0, f"K1 {label}: hit masks differ on {n_hit_diff} rays")
    tk = torch.where(hit_k, t_k, torch.full_like(t_k, T_INF))
    tp = torch.where(hit_p, t_p, torch.full_like(t_p, T_INF))
    mism = (tk - tp).abs() > T_REL_TOL * torch.clamp(tp.abs(), max=1e6)
    n_mism = int(mism.sum())
    frac = n_mism / n
    check(frac < 0.005, f"K1 {label}: t mismatch on {n_mism} of {n} rays")
    both = hit_k & hit_p
    k1_err = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
    log(f"K1 {label} n={n}: hits {int(hit_k.sum())}, hit masks equal, "
        f"t mismatch on {n_mism} rays, max |dt| {k1_err:.3e}, "
        f"prim differs on {int((both & (pp_k != pp_p)).sum())}")
    k2_err = 0.0
    for t_max in (5.0, 1e29):
        occ_k = wide.shadow_occlusion_wide(ws, o, d, t_max)
        occ_p = wide.shadow_plain(
            ws, o, d, torch.full((n,), t_max, device=o.device))
        n_diff = int((occ_k != occ_p).sum())
        check(n_diff < 0.005 * n, f"K2 {label} t_max={t_max}: {n_diff} of {n} differ")
        k2_err = max(k2_err, float(n_diff > 0))
        log(f"K2 {label} t_max={t_max:g}: occluded {int(occ_k.sum())}, "
            f"differs from plain on {n_diff} of {n} rays")
    return k1_err, k2_err


def phase_k1_k2(dev, results):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import (
        build_cornell_scene,
        cornell_camera,
    )
    from ilgpu_raytracing_tpu_torch.ops import rays, sort, traverse
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    t0 = time.monotonic()
    _, scene = build_cornell_scene(tess=24, sphere_tess=(48, 72),
                                   blas_leaf_size=8, bvh_method="sah")
    scene = scene.to(dev)
    ws = wide.prepare_scene(scene)
    log(f"bench scene: {scene.n_tris} tris, {ws.wide_child.numel() // 8} wide "
        f"nodes, per-thread stack bound {ws.thread_stack}, prep "
        f"{time.monotonic() - t0:.2f} s")
    in_w, in_h = RenderConfig().internal_resolution(1920, 1080)
    o, d = rays.generate_primary_rays(cornell_camera(1920, 1080), in_w, in_h, dev)
    o = o.contiguous()
    k1_err, k2_err = _trace_bar(ws, o, d, "primary")
    n = o.shape[0]
    tm = torch.full((n,), T_INF, device=dev)
    k1_primary_ms = cuda_ms(lambda: wide.trace_closest_wide_packed(ws, o, d), 10)
    k1_primary_plain = cuda_ms(lambda: wide.trace_closest_plain(ws, o, d, tm), 1)
    log(f"K1 primary {n} lanes: kernel {k1_primary_ms:.4f} ms, plain "
        f"{k1_primary_plain:.4f} ms")

    # bounce-like rays: 2 cosine-ish scatter directions per primary hit, from
    # a numpy seed, sorted by (alive, octant, origin morton) as the frame does
    hit = wide.trace_closest_wide(ws, o, d)
    surf = traverse.shade_hits(scene, hit, o, d)
    rng = np.random.default_rng(11)
    rnd = torch.as_tensor(rng.normal(size=(2 * n, 3)).astype(np.float32), device=dev)
    nrm = surf.normal.repeat(2, 1)
    rnd = rnd / rnd.norm(dim=1, keepdim=True)
    dirs = torch.where(((rnd * nrm).sum(1) < 0)[:, None], -rnd, rnd)
    org = (surf.pos + surf.normal * 0.0025).repeat(2, 1)
    alive = hit.hit.repeat(2)
    bmin = torch.amin(scene.inst_bmin, dim=0)
    bmax = torch.amax(scene.inst_bmax, dim=0)
    perm, _pos = sort._ray_perm(org, dirs, alive, (bmin, 1.0 / (bmax - bmin)))
    pl = perm.long()
    bo, bd = org[pl].contiguous(), dirs[pl].contiguous()
    n_alive = int(alive.sum())
    act = torch.arange(2 * n, device=dev) < n_alive
    e1, e2 = _trace_bar(ws, bo[:n_alive].contiguous(), bd[:n_alive].contiguous(),
                        "bounce (sorted, live lanes)")
    k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
    nb = 2 * n
    tmb = torch.where(act, torch.full((nb,), T_INF, device=dev), torch.zeros(nb, device=dev))
    tms = torch.where(act, torch.full((nb,), 1e29, device=dev), torch.zeros(nb, device=dev))
    k1_ms = cuda_ms(lambda: wide.trace_closest_wide_packed(ws, bo, bd, active=act), 10)
    k1_plain = cuda_ms(lambda: wide.trace_closest_plain(ws, bo, bd, tmb), 1)
    k2_ms = cuda_ms(lambda: wide.shadow_occlusion_wide(ws, bo, bd, 1e29, active=act), 10)
    k2_plain = cuda_ms(lambda: wide.shadow_plain(ws, bo, bd, tms), 1)
    log(f"K1 bounce {nb} lanes ({n_alive} live): kernel {k1_ms:.4f} ms, plain "
        f"{k1_plain:.4f} ms")
    log(f"K2 bounce {nb} lanes ({n_alive} live): kernel {k2_ms:.4f} ms, plain "
        f"{k2_plain:.4f} ms")
    results["wide_closest"] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain)
    results["wide_shadow"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain)
    return scene


def phase_other_scenes(dev):
    """K1/K2 vs plain off the bench scene: the default 6-sphere scene (six
    instances, sphere leaves) and a rotated + scaled sphere set beside a
    translated mesh (the world->object transform path), 1280x720 primary
    rays each."""
    from ilgpu_raytracing_tpu_torch.models.camera import Camera
    from ilgpu_raytracing_tpu_torch.models.cornell import _quad_grid
    from ilgpu_raytracing_tpu_torch.models.scene import (
        Material,
        SceneBuilder,
        build_default_scene,
        scale_affine,
        translation_affine,
    )
    from ilgpu_raytracing_tpu_torch.ops import rays
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide

    b = SceneBuilder()
    mat = b.add_material(Material(kd=(0.7, 0.6, 0.5)))
    ids = [b.add_sphere((0.0, 0.0, 0.0), 0.5, material=mat),
           b.add_sphere((0.8, 0.2, 0.0), 0.3, material=mat)]
    c, s = np.cos(0.5), np.sin(0.5)
    o2w = scale_affine(1.5, (0.2, 0.3, -0.5))
    o2w[:, :3] = o2w[:, :3] @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    b.add_sphere_instance(ids, o2w)
    v, t = _quad_grid((-2, 0, -2), (2, 0, -2), (-2, 0, 2), 6)
    b.add_mesh_instance(v, t, object_to_world=translation_affine((0, -0.6, 0)))
    scenes = (
        ("default 6-sphere", build_default_scene(single_instance=False)[1],
         Camera.create(1280, 720)),
        ("transformed", b.commit(),
         Camera.look_at((0.5, 1.0, 4.0), (0, 0, 0), (0, 1, 0), 50.0, 1280 / 720)),
    )
    for label, scene, cam in scenes:
        ws = wide.prepare_scene(scene.to(dev))
        o, d = rays.generate_primary_rays(cam, 1280, 720, dev)
        _trace_bar(ws, o.contiguous(), d, label)


def _render_color(scene, device, frames=2):
    """2 locked-noise frames of the integrator (tests/test_golden.py
    protocol) with the parity knobs; returns the last linear color."""
    from ilgpu_raytracing_tpu_torch.config import PARITY_KNOBS, RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import cornell_camera
    from ilgpu_raytracing_tpu_torch.ops import integrator, sky
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide
    from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs

    cfg = RenderConfig(spp=2, max_depth=3, **PARITY_KNOBS)
    w = h = 64
    scene = scene.to(device)
    ws = wide.prepare_scene(scene)
    cam = cornell_camera(w, h)
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    ra, rb = Reservoirs.empty(w * h, device), Reservoirs.empty(w * h, device)
    color = None
    for f in range(frames):
        gb = integrator.primary_visibility(scene, cam, w, h, 0, ws)
        rp, rc = (ra, rb) if f % 2 == 0 else (rb, ra)
        color, _, _, rc, _ = integrator.path_trace(
            scene, gb, cam, cam, rp, rc, f, 1234, sun, cfg, w, h, ws)
        if f % 2 == 0:
            rb = rc
        else:
            ra = rc
    return color.cpu().numpy()


def phase_parity(dev):
    from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene

    _, scene = build_cornell_scene(tess=4, sphere_tess=(8, 12))
    got = _render_color(scene, dev)
    want = _render_color(scene, torch.device("cpu"))
    diff = np.abs(got - want)
    frac = float((diff.max(axis=-1) > 0.1).mean())
    check(np.isfinite(got).all(), "64x64 frame on the card is not finite")
    check(diff.mean() < 0.02, f"64x64 parity: mean |diff| {diff.mean():.5f}")
    check(frac < 0.01, f"64x64 parity: {frac:.3%} pixels off by > 0.1")
    log(f"64x64 Cornell kernels-on-card vs plain-on-CPU: mean |diff| "
        f"{diff.mean():.6f}, pixels > 0.1: {frac:.4%}")


def phase_main_path(dev, scene):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import cornell_camera
    from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos, wide
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    out_w, out_h = 1920, 1080
    cfg = RenderConfig(spp=2, max_depth=3)
    r = Renderer(out_w, out_h, cfg, scene, cornell_camera(out_w, out_h), device=dev)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    r.render().cpu()  # warm-up
    torch.cuda.synchronize()

    for counts in (wide.LAUNCHES, sortpos.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    frame_ms = []
    eff = 0.0
    for _ in range(FRAMES):
        tf = time.monotonic()
        packed = r.render().cpu()
        torch.cuda.synchronize()
        frame_ms.append((time.monotonic() - tf) * 1e3)
        eff += float(r._last_aux["eff_rays"])
    dt = time.monotonic() - t0
    launches = {**wide.LAUNCHES, **sortpos.LAUNCHES}

    in_n = r.in_w * r.in_h
    rays_per_frame = in_n * (1 + cfg.spp * cfg.max_depth * 2)
    log(f"main path: {out_w}x{out_h} out, {r.in_w}x{r.in_h} internal, "
        f"{FRAMES} frames in {dt:.4f} s")
    log(f"frame ms: {[round(x, 3) for x in frame_ms]}")
    log(f"ms/frame {dt / FRAMES * 1e3:.3f}  fps {FRAMES / dt:.4f}  "
        f"Mrays/s {rays_per_frame * FRAMES / dt / 1e6:.4f} "
        f"({rays_per_frame} dispatched rays/frame)  effective Mrays/s "
        f"{eff / dt / 1e6:.4f} ({eff / FRAMES:.0f} effective rays/frame)")
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    per_frame = {k: v / FRAMES for k, v in launches.items()}
    log(f"launches per frame: {per_frame}")
    want = {"wide_closest": 3, "wide_shadow": 5, "sortpos": 6}
    check(per_frame == want, f"launch counts {per_frame} != {want}")

    img = packed.numpy()
    color = r._last_aux["color"]
    check(bool(torch.isfinite(color).all()), "1080p frame color has NaN/Inf")
    check(len(np.unique(img)) > 1, "1080p frame is one colour")
    check(img.shape == (out_w * out_h,), f"packed frame shape {img.shape}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu

    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    log(f"device: {kind}; nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = cu.build_all()
    log(f"build: nvcc {' '.join(cu.NVCC_FLAGS)}: {secs:.2f} s")

    results: dict[str, dict] = {}
    phase_k3(dev, results)
    bench_scene = phase_k1_k2(dev, results)
    phase_other_scenes(dev)
    phase_parity(dev)
    launches = phase_main_path(dev, bench_scene)

    meta = {
        "wide_closest": ("ilgpu_raytracing_tpu_torch/csrc/wide_trace.cu",
                         "ilgpu_raytracing_tpu/ops/pallas/wide_kernel.py:952"),
        "wide_shadow": ("ilgpu_raytracing_tpu_torch/csrc/wide_trace.cu",
                        "ilgpu_raytracing_tpu/ops/pallas/wide_kernel.py:1073"),
        "sortpos": ("ilgpu_raytracing_tpu_torch/csrc/sortpos.cu",
                    "ilgpu_raytracing_tpu/ops/pallas/sortpos_kernel.py:135"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **results[name])
        for name, (src, rep) in meta.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
