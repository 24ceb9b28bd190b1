#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

Drives the port's main paths on the card through the entry points a user
calls, after checking every hand-written kernel of them against its plain
PyTorch version on the card:
- the 1920x1080 Cornell bench frame that `bench.py` renders (15,552
  triangles, SAH BVH with leaf 8, spp=2, max_depth=3, internal 1280x704):
  the wide kernels K1/K2 and the counting sort K3, through `Renderer`;
- the same frame with `r.wscene = binary.prepare_binary(scene)`: the binary
  skip-index kernel K6 (closest and any-hit) and K3, through `Renderer`;
- the treelet rounds of `ops/treelet.py` on the bench frame's 1,802,240
  sorted bounce lanes: K7 (and K3, K1 for the cleanup variant);
- the 1920x1080 terrain frame of `examples/large_mesh.py` (BASELINE config
  5: 1,048,576 triangles, SAH BVH with leaf 64, spp=2, max_depth=8): the
  streaming kernels K4/K5 and K3 with the destination-treelet sort key,
  through `Renderer`;
- the stream treelet rounds on the terrain's 1,802,240 treelet-sorted
  bounce lanes: K8 (and K3);
- the Sponza-like courtyard of `models/sponza_like.py` (94 triangles, 5
  materials, TGA diffuse textures and alpha-cutout banners, loaded through
  the OBJ/MTL parser; median BVH, leaf 8) at 1920x1080, spp=2,
  max_depth=3: every trace peels around K1 (ops/alpha.py), K3 sorts the
  bounce batches, and `path_trace` runs in 2 chunks, through `Renderer`;
- BASELINE config 4 (`examples/animate.py`'s loop) on the bench scene at
  1920x1080: every frame `refit_mesh_instance`, `Renderer.set_scene` (the
  kernel tables re-prepared) and an orbiting camera, progressive
  accumulation, through K1/K2/K3;
- the interactive session (`runtime/interactive.py` over
  `runtime/controller.py`) at 1920x1080 on the default 6-sphere scene;
- the bench frame with each integrator setting, `deferred_shadows` (one
  K2 dispatch over every visibility ray of the frame) and
  `spp_pixel_major`;
- the bench frame through `Renderer(mesh=...)` (parallel/sharding.py):
  on `make_mesh()` and on a 4-block mesh of cuda:0, K1/K2/K3 once per
  block, and the same with a caller's BinaryScene (K6/K3 once per block);
- `bench_torch.py`, the port's benchmark entry, at its full size (the
  bench frame, 1 + 3 x 6 frames): K1/K2/K3;
- each `examples/torch_*.py` at small sizes: the 6-sphere scene and the
  Cornell scene (SAH, median and LBVH builds) through K1/K2/K3, the
  config-4 loop, a 262,144-triangle terrain through K4/K5/K3, the
  courtyard's peel around K1, config-1 parity, and the fly viewer without
  a display.

Phases:
  1. device: the card's name and power limit;
  2. build: one nvcc per kernel source, all started together (sm_90a);
  3. K3 counting-sort positions vs the one-hot plain version, exact on
     every lane: 1,802,240 frame-like keys at 129, 16 and 258 bins, every
     key in one bin, descending keys, n = 1, 1,000 and 1,802,241, bins = 1
     and 384; timed beside torch.argsort(stable=True) at 129 and 258 bins;
     a key out of range must fail the kernel's device-side assert (in a
     child process); ptxas's report of csrc/sortpos.cu and of
     csrc/sortkey.cu (the sort key);
  4. K1 closest hit / K2 any-hit vs the plain skip-index walk on the bench
     scene: primary rays and 1,802,240 sorted bounce rays, held to the bar
     of tests/test_wide_kernel.py (hit masks agree, relative t mismatch
     above 1e-3 on < 0.5% of rays, shadow agreement > 99.5%); the same
     bar on the default 6-sphere scene and a scene with transformed
     instances; ptxas's report of csrc/wide_trace.cu and
     csrc/treelet_trace.cu; K1 called with a stack cap of 1 on the bench
     bounce lanes must fail the walk's device-side assert (in a child
     process);
  5. a 64x64 Cornell frame pair rendered with the kernels on the card and
     with the plain versions on the CPU, held to the golden-image bar;
  6. the Cornell main path: one warm-up and 6 timed 1080p frames, each
     copied to the host, with every kernel's launch count checked (ReSTIR
     3 a frame; the sort key 6 Morton launches, as many as K3's); then one
     more frame whose 6 sorted calls are recorded: the sort-key kernel
     (csrc/sortkey.cu) equal to the plain key on every lane of each, and
     on the first (1,802,240 lanes) the Morton and the octant key timed by
     CUDA events beside their byte bound and the plain key's ms;
  6r. ReSTIR: the bench frame's three `restir_direct` calls (1,802,240
     lanes each) recorded from a frame of an orbiting camera; the kernel
     (csrc/restir.cu) against the plain body on the card on the
     with-reuse call, a without-reuse call and the with-reuse call in the
     reference's weighting, every output equal bit for bit; the kernel's
     CUDA-event ms beside its byte bound and the plain body's ms; ptxas's
     report of csrc/restir.cu;
  6s. hit shading: the bench frame's three `shade_hits` calls recorded
     from a frame of an orbiting camera; the kernel (csrc/shade.cu) against
     the plain body on the card on each call, every output equal bit for
     bit; on the primary (901,120 lanes) and the first bounce's (1,802,240
     lanes) calls the launch's own CUDA-event ms (arguments packed once,
     the C entry alone in the loop) beside its byte bound, the wrapper's
     ms called back to back and the plain body's ms; the same bar on the CPU cases of
     ops/cuda/host_check (`SHADE_CASES`: Cornell, a small terrain's
     spheres, a scene of textured, glass and transformed spheres and
     textured two-sided grids, the courtyard's OBJ textures, clamped
     records) moved to the card; three bench frames rendered with the
     kernel and with the plain body in its place, packed frame and colour
     bit-equal; ptxas's report of csrc/shade.cu. Every
     main path checks `launches.shade` a frame (3 Cornell, 8 terrain, 3n
     a mesh frame of n blocks);
  6l. the bounce's lane updates: every `scatter` and `resolve` call of a
     bench frame (1,802,240 lanes), of one with `dedup_sun_shadow` off
     (the sun traced like any other light), and of a frame of the 16-spp sphere
     scene of `benchmark/configs/oneweekend-16spp.json` (486 spheres of
     glass, mirror and lambert, 4 bounces, 14,417,920 lanes) held to the
     plain bodies bit for bit as it happens (csrc/bounce.cu, every output,
     the RNG state included); the sphere frame's main path with its launch
     counts (`launches.bounce` 4 + 4 a frame); both kernels' own CUDA-event
     ms (arguments packed once, the C entry alone in the loop) on the first
     bounce of each frame beside a lower bound on their bytes
     (ops/cuda/bounce.needed_bytes) and the plain bodies' ms; three bench
     frames rendered with the kernels and with the plain bodies in their
     place, packed frame and colour bit-equal; ptxas's report of
     csrc/bounce.cu. Every main path checks `launches.bounce` a frame (3 +
     3 Cornell, 8 + 8 terrain, 3n + 3n a mesh frame of n blocks), and the
     terrain main path holds its frame's calls to the plain bodies too;
  6a. the mesh: the bench frame through `Renderer(mesh=make_mesh())` (one
     card: a mesh of size 1) and `Renderer(mesh=make_mesh(devices=[cuda:0]
     * 4))`, one warm-up and 2 frames each in turns with the
     single-device Renderer of the same seed: packed frame and aux colour
     bit-equal every frame, launches K1 3n, K2 5n, K3 6n, ms/frame, the
     bytes the gathers copied and moved, the kernel scene replicated once;
     then the same with a caller's BinaryScene set as `r.wscene` on every
     Renderer (each mesh Renderer replicates it once): bit-equal every
     frame, launches K6 3n + 5n, K3 6n;
  6b. bench_torch: `bench_torch.run` at its full size, its JSON line
     printed and its fields checked (11,714,560 rays dispatched a frame,
     internal 1280x704, 15,552 triangles, 3 windows of 6 frames, the
     card's nvidia-smi line), K1 3, K2 5, K3 6 launches a frame;
  6c. parity, BASELINE config 1 (examples/torch_parity_check.py's
     `mean_var` and `compare`): the default sphere scene at 512x512, spp 1, max_depth 1, reuse off,
     16 noise seeds, the kernels on the card against the plain versions on
     the CPU: the robust RMSE of the per-pixel means within 1.5x the
     Monte-Carlo floor, and the means held per pixel to the 64x64
     card-vs-CPU bar (the seeds are shared);
  7. K6 vs its plain version on 65,536-ray subsets of the bench scene's
     primary rays and sorted bounce lanes (hit masks and t, prim, inst,
     bu, bv equal on every ray, any-hit equal at t_max 5 and 1e29, the
     counting variant's boxes and primitives equal to the skip walk's);
     K6 at its deepest stack (454 levels, shared memory opted in) equal to
     K6; K6 timed on the full bounce population and the primary rays, and
     in turns with K1 and K2 on the same lanes (the route pair: wide
     against binary tables); its records' bytes, its stack bound, the
     bound over the tables it reads and over the flat tables, and ptxas's
     report of csrc/binary_trace.cu; K6 called with a stack cap of 1 on
     the bench bounce lanes must fail the walk's device-side assert (in a
     child process);
  8. a 64x64 Cornell frame pair through the binary route, card vs CPU;
  9. the K6 main path: the 1080p bench frame through `Renderer` with a
     BinaryScene, one warm-up and 3 timed frames with every launch count
     checked (K6 only, no K1/K2), held to the K1/K2 frame of the same seed
     (< 1% of pixels off by more than 2 levels);
 10. K7: `trace_closest_treelet_packed` (rounds), `_single` and
     `cleanup_after=1` on all 1,802,240 sorted bounce lanes, each equal to
     K1 (t and pp) on every lane; one K7 round equal to its plain version
     on the first 65,536 lanes; timed;
 11. the integrator settings on the 1080p bench frame: `deferred_shadows`
     and `spp_pixel_major` each against the default, the three arms in
     turns after one warm-up each: the deferred colour within rtol 3e-5,
     atol 3e-6 and the pixel-major colour and packed frame bit-equal, eff
     and the reservoirs bit-equal, every frame; launch counts per arm
     (deferred: K2 2 and K3 3 a frame);
 12. BASELINE config 4 at 1080p: examples/animate.py's loop on the bench
     scene (refit_mesh_instance of the bobbing sphere, Renderer.set_scene,
     orbiting camera, progressive accumulation), one warm-up and 4 timed
     frames with the refit, set_scene (read-back + leaf packing, 8-wide
     collapse, upload) and render ms of each and the launch counts; K1/K2
     on the refit tables against the plain walk, K1 on them against K1 on
     a fresh SAH build of the moved geometry (hit masks equal, t within
     1e-5); a 64x64 refit frame pair, card vs CPU, at the golden bar;
 13. the interactive session at 1080p on the default 6-sphere scene: a
     scripted input of W, mouse look, Shift+D, scroll, Space and one
     EventPump step, a presenter keeping frame_rgb(); the frame count, the
     camera's move and turn, distinct frames, launch counts, ms/frame and
     the HUD text;
 14. terrain prep: the host BVH build and the streaming prep, timed apart;
 15. K4 closest hit / K5 any-hit vs the plain walk on strided subsets of
     the terrain's primary rays and 1,802,240 treelet-sorted bounce rays,
     held to the bar of tests/test_stream_kernel.py (hit masks equal, no
     |dt| > 1e-3 where both hit, prim agreement > 99.5%, K5 equal at t_max
     5 and 1e29); K5 equal to K4's hit mask at t_max 5 and 1e29 on all
     901,120 primary and 1,802,240 bounce lanes; K4 timed on the 901,120
     primary and the full bounce lanes and K5 on the bounce lanes, each
     with the boxes and primitives its counting variant tallies; K5's
     SIMD-efficiency count; ptxas's report of csrc/stream_trace.cu; the
     depth of the terrain's binary BVH against K6's stack bound; K4
     called with a stack cap of 1 on the terrain's bounce lanes must fail
     the walk's device-side assert (in a child process);
 16. K8: `trace_closest_treelet_stream_packed` on the terrain's 1,802,240
     treelet-sorted bounce lanes equal to K4 (t and pp) on every lane; one
     K8 round equal to its plain version on the first 65,536 lanes; timed;
     ptxas's report of csrc/streamtreelet_trace.cu;
 17. a 64x64 small-terrain (4,096 triangles) frame pair through the
     integrator with a StreamScene, kernels on the card vs plain on the
     CPU, held to the golden-image bar;
 18. the terrain main path: one warm-up and 3 timed 1080p frames, each
     copied to the host, with every kernel's launch count checked (the
     sort key 16 treelet launches, as many as K3's); then one more frame
     whose 16 sorted calls are recorded: the sort-key kernel equal to the
     plain key on every lane of each, and on the first (1,802,240 lanes,
     32 boxes) the treelet key timed beside its byte bound and the plain
     key's ms; then one more frame whose 8 `shade_hits` calls (the 1M-row
     triangle tables, the mirror and lambert spheres, primary and bounces
     0-6) are recorded: the shading kernel's surface equal to the plain
     body's bit for bit on every call;
 19. K1/K2 vs the plain walk on the courtyard's 1280x720 primary rays (the
     opaque tables, has_alpha off, barycentrics on), at the bar of phase 4;
     K1 timed there, with its boxes, primitives and bound;
 20. 64x64 courtyard frame pairs, kernels (the peel around K1, and around
     K4 on a StreamScene of the courtyard) on the card vs plain versions on
     the CPU, held to the golden-image bar;
 21. the courtyard main path: one warm-up and 3 timed 1080p frames, each
     copied to the host: K1 and K3 launched, K2, K4-K8 not, `path_trace` in
     2 chunks, the peel rounds of every trace counted (K1 launches equal
     their sum); then the same tables with has_alpha off (the opaque
     control of tools/alphabench.py) and the alpha frame in one chunk
     (chunk_pixels=0) in turns with the alpha frames, the medians and
     their ratios;
 22. the examples: each examples/torch_*.py `main` in this process on the
     card, its output printed: torch_render_default 256x256, 2 frames;
     torch_render_cornell 320x240 with --bvh sah, median and lbvh;
     torch_animate 160x120, 3 frames; torch_large_mesh 640x360 on a
     512x256 grid (262,144 triangles: the StreamScene route, K4 and K5
     launched); torch_sponza_like 320x180; torch_parity_check --size 128
     --seeds 4 within the noise floor; torch_fly without DISPLAY returns 1
     with its message. Every PNG has its size and more than one colour.

Each kernel's bound is the larger of the bytes it must move (rays in and
results out once, the scene tables read once) over 3.35 TB/s and the
float32 operations it does on these rays (boxes and primitives tested, as
the kernels' counting variant counts them) over 67 TFLOP/s.

Prints each phase's seconds, the kernels' JSON line, the card line, and as
the last line {"ok": true, "device": {...}}. Any failure raises and exits
nonzero. Needs one CUDA card; run from the repository root:
python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FRAMES = 6
K6_FRAMES = 3
TERRAIN_FRAMES = 3
COURTYARD_FRAMES = 3
COURTYARD_PAIRS = 4  # alpha and opaque-control frames timed in turns
CONFIG4_FRAMES = 4  # refit frames timed after one warm-up
SETTINGS_FRAMES = 3  # frames of each integrator-setting arm after one warm-up
T_REL_TOL = 1e-3
SUBSET = 65_536  # rays of each terrain population held to the plain walk
MESH_FRAMES = 2  # timed mesh frames after one warm-up, in turns with one device
PARITY_SIZE = 512  # BASELINE config 1 at full size
PARITY_SEEDS = 16
K3_LANES = 1_802_240  # 2 x 901,120: the frame's sorted bounce batches

# Peak rates of one H100 SXM (NVIDIA's data sheet, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per test, counted in csrc/trace_common.cuh: a slab
# test is 6 sub, 6 mul, 11 min/max and 2 compares; the u8 dequantization of
# a K4/K5 child box adds 6 mul and 6 add; a Moller-Trumbore test is 46
# mul/add/sub/div and 8 compares (sphere slots are counted at that rate).
BOX_OPS = 25
QBOX_OPS = BOX_OPS + 12
PRIM_OPS = 54
# (boxes, primitives) that the K4/K8 walk before the node-group redesign
# (StreamWalker, commit de09dde) tested on this script's terrain lanes, by
# tools/torch_k4k8_bench.py on an H100. The bound is printed from them beside
# the bound from this walk's own counts: a walk that tests fewer boxes must
# not be credited with a lower bound, nor one that tests more with a higher.
PRIOR_K4_K8_WORK = dict(k4_primary=(51_163_836, 58_970_760),
                        k4_bounce=(89_112_975, 127_319_096),
                        k8_round=(18_110_707, 13_401_456))


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    from bench_torch import device_line

    return device_line("cuda")


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


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of bytes over the
    HBM rate and float32 operations over the float32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def trace_bound(n: int, work, any_hit: bool, box_ops: int, tables,
                out_bytes: int = 8) -> dict:
    """Bound of one trace call on n rays: o, d, t_max in, the closest record
    (`out_bytes` a ray: 8 for (t, pp), 20 for K6's t, prim, inst, bu, bv)
    or occ out, `tables` read once; `work` = (boxes, primitives) tested."""
    n_bytes = n * (28 + (1 if any_hit else out_bytes)) + sum(
        t.numel() * t.element_size() for t in tables)
    boxes, prims = work
    return bound(n_bytes, boxes * box_ops + prims * PRIM_OPS)


def _k3_key_sets(rng):
    """(label, keys, bins) of the K3 phase: the frame's shape (70% uniform,
    a dead tail in the last bin) at 129, 16 and 258 bins, and the edges."""
    n = K3_LANES

    def frame_keys(m, bins):
        live = int(m * 0.7)
        return np.concatenate([rng.integers(0, bins - 1, size=live),
                               np.full(m - live, bins - 1)])

    return [
        *((f"frame keys, {b} bins", frame_keys(n, b), b) for b in (129, 16, 258)),
        ("every key in one bin", np.full(n, 57), 129),
        ("descending keys", (np.arange(n)[::-1] * 258) // n, 258),
        ("n=1", np.array([5]), 16),
        ("n=1,000", rng.integers(0, 129, size=1000), 129),
        ("n=1,802,241", frame_keys(n + 1, 258), 258),
        ("bins=1", np.zeros(n), 1),
        ("bins=384", rng.integers(0, 384, size=n), 384),
    ]


def _k3_bad_key_fails() -> str:
    """A key outside [0, bins) in a child process: the device-side assert
    must fail the next synchronizing call. Returns the first line of the
    error that names the assert."""
    code = ("import torch; from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos; "
            "k = torch.zeros(5000, dtype=torch.int32, device='cuda'); k[4321] = 129; "
            "sortpos.counting_pos(k, 129); torch.cuda.synchronize()")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    said = [ln for ln in proc.stderr.splitlines() if "assert" in ln.lower()]
    check(proc.returncode != 0 and bool(said),
          f"K3 took a key outside [0, bins) without an error: rc {proc.returncode}, "
          f"{proc.stderr[-500:]}")
    return said[0].strip()


def phase_k3(dev, results):
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos

    for name in ("sortpos", "sortkey"):
        for line in cu.ptxas_info(name):
            log(f"ptxas {name}.cu: {line}")
    for label, keys, bins in _k3_key_sets(np.random.default_rng(7)):
        kt = torch.as_tensor(keys.astype(np.int32), device=dev)
        got = sortpos.counting_pos(kt, bins)
        want = sortpos.counting_pos_plain(kt, bins)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        check(n_diff == 0, f"K3 {label}: {n_diff} of {kt.numel()} positions differ from plain")
        log(f"K3 {label} (n={kt.numel()}, bins={bins}): equal to plain on every lane")
        if label.startswith("frame keys") and bins != 16:
            n = kt.numel()
            inv = torch.argsort(kt, stable=True)
            check(bool(torch.equal(got.long()[inv], torch.arange(n, device=dev))),
                  "K3 pos is not the inverse of the stable argsort")
            ms = cuda_ms(lambda: sortpos.counting_pos(kt, bins), 20)
            # the library call: a stable argsort gives the inverse of pos
            lib_ms = cuda_ms(lambda: torch.argsort(kt, stable=True), 20)
            ms2 = cuda_ms(lambda: sortpos.counting_pos(kt, bins), 20)
            plain_ms = cuda_ms(lambda: sortpos.counting_pos_plain(kt, bins), 3)
            log(f"K3 {n} lanes x {bins} bins: kernel {ms:.4f}; {ms2:.4f} ms, plain "
                f"{plain_ms:.4f} ms, torch.argsort(stable) {lib_ms:.4f} ms")
            if bins == 129:
                results["sortpos"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                          **bound(8.0 * n, 0), library_ms=lib_ms)
    log(f"K3 with a key outside [0, bins): the child process failed: {_k3_bad_key_fails()}")


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


def _bounce_rays(scene, hit, o, d, seed, sort_args):
    """2 scatter directions per primary hit (normal-flipped unit normals
    from a numpy seed), sorted as the frame sorts its bounce batches.
    Returns (sorted o, sorted d, live mask, live count)."""
    from ilgpu_raytracing_tpu_torch.ops import sort, traverse

    dev = o.device
    n = o.shape[0]
    surf = traverse.shade_hits(scene, hit, o, d)
    rng = np.random.default_rng(seed)
    rnd = torch.as_tensor(rng.normal(size=(2 * n, 3)).astype(np.float32), device=dev)
    nrm = surf.normal.repeat(2, 1)
    rnd = rnd / rnd.norm(dim=1, keepdim=True)
    dirs = torch.where(((rnd * nrm).sum(1) < 0)[:, None], -rnd, rnd)
    org = (surf.pos + surf.normal * 0.0025).repeat(2, 1)
    alive = hit.hit.repeat(2)
    perm, _pos = sort._ray_perm(org, dirs, alive, *sort_args)
    pl = perm.long()
    n_alive = int(alive.sum())
    act = torch.arange(2 * n, device=dev) < n_alive
    return org[pl].contiguous(), dirs[pl].contiguous(), act, n_alive


def phase_k1_k2(dev, results):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import (
        build_cornell_scene,
        cornell_camera,
    )
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import rays
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    for name in ("wide_trace", "treelet_trace"):
        for line in cu.ptxas_info(name):
            log(f"ptxas {name}.cu: {line}")
    t0 = time.monotonic()
    _, scene = build_cornell_scene(tess=24, sphere_tess=(48, 72),
                                   blas_leaf_size=8, bvh_method="sah", device=dev)
    ws = wide.prepare_scene(scene)
    log(f"bench scene: {scene.n_tris} tris, {ws.wide_child.numel() // 8} wide "
        f"nodes, wide depth {ws.wide_depth} (node-group stack {ws.wide_depth} x "
        f"128 x 4 B a block), prep {time.monotonic() - t0:.2f} s")
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

    # bounce-like rays sorted by (alive, octant, origin morton) as the frame does
    hit = wide.trace_closest_wide(ws, o, d)
    bmin = torch.amin(scene.inst_bmin, dim=0)
    bmax = torch.amax(scene.inst_bmax, dim=0)
    bo, bd, act, n_alive = _bounce_rays(scene, hit, o, d, 11,
                                        ((bmin, 1.0 / (bmax - bmin)),))
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
    tables = (ws.nodes, ws.tri_rows, ws.sph_rows, ws.inst_i, ws.inst_f)
    w1 = wide.count_work(ws, bo, bd, tmb, any_hit=False)
    w2 = wide.count_work(ws, bo, bd, tms, any_hit=True)
    log(f"K1 bounce work: {w1[0]} boxes, {w1[1]} primitives; K2: {w2[0]} boxes, "
        f"{w2[1]} primitives")
    k1_tables = [ws.nodes, ws.tri_rows, ws.sph_rows, ws.inst_i, ws.inst_f,
                 ws.inst_i.shape[0], ws.leaf_width]
    case = dict(tables=k1_tables, o=bo, d=bd, tm=tmb)
    log(f"K1 with a stack cap of 1 on the bench bounce lanes: the child process failed: "
        f"{_overflow_fails('K1', OVERFLOW_CHILD, case, 'wide')}")
    results["wide_closest"] = dict(max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain,
                                   **trace_bound(nb, w1, False, BOX_OPS, tables),
                                   library_ms=None)
    results["wide_shadow"] = dict(max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
                                  **trace_bound(nb, w2, True, BOX_OPS, tables),
                                  library_ms=None)
    return dict(scene=scene, ws=ws, o=o, d=d, bo=bo, bd=bd, act=act, n_alive=n_alive)


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
        ("default 6-sphere", build_default_scene(single_instance=False, device=dev)[1],
         Camera.create(1280, 720)),
        ("transformed", b.commit(dev),
         Camera.look_at((0.5, 1.0, 4.0), (0, 0, 0), (0, 1, 0), 50.0, 1280 / 720)),
    )
    for label, scene, cam in scenes:
        ws = wide.prepare_scene(scene)
        o, d = rays.generate_primary_rays(cam, 1280, 720, dev)
        _trace_bar(ws, o.contiguous(), d, label)


def _render_color(scene, device, prepare, camera, frames=2):
    """2 locked-noise 64x64 frames of the integrator (tests/test_golden.py
    protocol) with the parity knobs on the kernel scene `prepare(scene)`;
    returns the last linear color."""
    from ilgpu_raytracing_tpu_torch.config import PARITY_KNOBS, RenderConfig
    from ilgpu_raytracing_tpu_torch.ops import integrator, sky
    from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs

    cfg = RenderConfig(spp=2, max_depth=3, **PARITY_KNOBS)
    w = h = 64
    scene = scene.to(device)
    ks = prepare(scene)
    cam = camera(w, h)
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    ra, rb = Reservoirs.empty(w * h, device), Reservoirs.empty(w * h, device)
    color = None
    for f in range(frames):
        gb = integrator.primary_visibility(scene, cam, w, h, 0, ks)
        rp, rc = (ra, rb) if f % 2 == 0 else (rb, ra)
        color, _, _, rc, _ = integrator.path_trace(
            scene, gb, cam, cam, rp, rc, f, 1234, sun, cfg, w, h, ks)
        if f % 2 == 0:
            rb = rc
        else:
            ra = rc
    return color.cpu().numpy()


def _parity(dev, label, scene, prepare, camera):
    """The 64x64 frame pair with the kernels on the card against the plain
    versions on the CPU, held to the golden-image bar."""
    got = _render_color(scene, dev, prepare, camera)
    want = _render_color(scene, torch.device("cpu"), prepare, camera)
    diff = np.abs(got - want)
    frac = float((diff.max(axis=-1) > 0.1).mean())
    check(np.isfinite(got).all(), f"64x64 {label} frame on the card is not finite")
    check(diff.mean() < 0.02, f"64x64 {label} parity: mean |diff| {diff.mean():.5f}")
    check(frac < 0.01, f"64x64 {label} parity: {frac:.3%} pixels off by > 0.1")
    check(float(got.std()) > 0.0, f"64x64 {label} frame is one colour")
    log(f"64x64 {label} kernels-on-card vs plain-on-CPU: mean |diff| "
        f"{diff.mean():.6f}, pixels > 0.1: {frac:.4%}")


def phase_parity(dev):
    from ilgpu_raytracing_tpu_torch.models.cornell import (
        build_cornell_scene,
        cornell_camera,
    )
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide

    _, scene = build_cornell_scene(tess=4, sphere_tess=(8, 12), device="cpu")
    _parity(dev, "Cornell", scene, wide.prepare_scene, cornell_camera)


def _count_tables():
    from ilgpu_raytracing_tpu_torch.ops.cuda import (
        binary,
        sortpos,
        stream,
        streamtreelet,
        treelet,
        wide,
    )

    return (wide.LAUNCHES, stream.LAUNCHES, sortpos.LAUNCHES, binary.LAUNCHES,
            treelet.LAUNCHES, streamtreelet.LAUNCHES)


def _reset_counts():
    from ilgpu_raytracing_tpu_torch.ops.cuda import bounce, restir, shade, sortkey

    for counts in _count_tables() + (restir.LAUNCHES, sortkey.LAUNCHES, shade.LAUNCHES,
                                     bounce.LAUNCHES):
        for k in counts:
            counts[k] = 0


def _read_counts() -> dict:
    out = {}
    for counts in _count_tables():
        out.update(counts)
    return out


def _want(**nonzero) -> dict:
    """Launch counts of a path: every kernel 0 except those given (None:
    launched at least once a frame)."""
    return {**{k: 0 for k in _read_counts()}, **nonzero}


def _drive(label, r, frames, want_per_frame, around=contextlib.nullcontext,
           restir_per_frame=None, sortkey_per_frame=None, shade_per_frame=None,
           bounce_per_frame=None):
    """One warm-up and `frames` timed frames of the Renderer, each copied to
    the host, with the launch counts set to 0 just before the timed frames
    and read just after (`around()` is entered around the timed frames).
    With `restir_per_frame`, the ReSTIR kernel's launches a frame must
    equal it; the sort-key kernel's must equal K3's (every sorted call
    computes one key), and with `sortkey_per_frame` its launches of each
    variant (the other variants 0). With `shade_per_frame`, the shading
    kernel's launches a frame must equal it, and with `bounce_per_frame`
    each bounce kernel's (scatter, resolve). Returns the launch counts of
    the timed frames."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import bounce, restir, shade, sortkey

    cfg = r.cfg
    r.render().cpu()  # warm-up
    torch.cuda.synchronize()

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    eff = 0.0
    with around():
        t0 = time.monotonic()
        for _ in range(frames):
            tf = time.monotonic()
            packed = r.render().cpu()
            torch.cuda.synchronize()
            frame_ms.append((time.monotonic() - tf) * 1e3)
            eff += float(r._last_aux["eff_rays"])
        dt = time.monotonic() - t0
    launches = _read_counts()

    in_n = r.in_w * r.in_h
    rays_per_frame = in_n * (1 + cfg.spp * cfg.max_depth * 2)
    log(f"{label}: {r.out_w}x{r.out_h} out, {r.in_w}x{r.in_h} internal, "
        f"{frames} frames in {dt:.4f} s")
    log(f"{label} frame ms: {[round(x, 3) for x in frame_ms]}")
    log(f"{label}: ms/frame {dt / frames * 1e3:.3f}  fps {frames / dt:.4f}  "
        f"Mrays/s {rays_per_frame * frames / dt / 1e6:.4f} "
        f"({rays_per_frame} dispatched rays/frame)  effective Mrays/s "
        f"{eff / dt / 1e6:.4f} ({eff / frames:.0f} effective rays/frame)")
    log(f"{label}: peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    per_frame = {k: v / frames for k, v in launches.items()}
    log(f"{label} launches per frame: {per_frame}")
    restir_frame = restir.LAUNCHES["restir"] / frames
    log(f"{label} launches.restir per frame: {restir_frame}")
    if restir_per_frame is not None:
        check(restir_frame == restir_per_frame,
              f"{label}: {restir_frame} ReSTIR launches a frame != {restir_per_frame}")
    shade_frame = shade.LAUNCHES["shade"] / frames
    log(f"{label} launches.shade per frame: {shade_frame}")
    if shade_per_frame is not None:
        check(shade_frame == shade_per_frame,
              f"{label}: {shade_frame} shading launches a frame != {shade_per_frame}")
    bounce_frame = {k: v / frames for k, v in bounce.LAUNCHES.items()}
    log(f"{label} launches.bounce per frame: {bounce_frame}")
    if bounce_per_frame is not None:
        check(bounce_frame == dict(scatter=bounce_per_frame, resolve=bounce_per_frame),
              f"{label}: bounce launches a frame {bounce_frame} != {bounce_per_frame} each")
    sortkey_frame = {k: v / frames for k, v in sortkey.LAUNCHES.items()}
    log(f"{label} launches.sortkey per frame: {sortkey_frame}")
    check(sum(sortkey_frame.values()) == per_frame["sortpos"],
          f"{label}: sort-key launches {sortkey_frame} != K3's {per_frame['sortpos']}")
    if sortkey_per_frame is not None:
        want = {k: sortkey_per_frame.get(k, 0) for k in sortkey.LAUNCHES}
        check(sortkey_frame == want,
              f"{label}: sort-key launches a frame {sortkey_frame} != {want}")
    check(per_frame.keys() == want_per_frame.keys() and all(
        per_frame[k] > 0 if want is None else per_frame[k] == want
        for k, want in want_per_frame.items()),
          f"{label} launch counts {per_frame} != {want_per_frame}")

    img = packed.numpy()
    color = r._last_aux["color"]
    check(bool(torch.isfinite(color).all()), f"{label} frame color has NaN/Inf")
    check(len(np.unique(img)) > 1, f"{label} frame is one colour")
    check(img.shape == (r.out_w * r.out_h,), f"{label} packed frame shape {img.shape}")
    return launches


def phase_main_path(dev, bench):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import cornell_camera
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=3), bench["scene"],
                 cornell_camera(1920, 1080), device=dev)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    counts = _drive("Cornell main path", r, FRAMES,
                    _want(wide_closest=3, wide_shadow=5, sortpos=6),
                    restir_per_frame=r.cfg.max_depth,
                    sortkey_per_frame=dict(morton=2 * r.cfg.max_depth),
                    shade_per_frame=r.cfg.max_depth, bounce_per_frame=r.cfg.max_depth)
    _sortkey_bar("Cornell", r)
    return counts


def _sort_key_bytes(n: int, morton_bounds, treelet_bounds) -> int:
    """Bytes a sort-key call must move, each once: per lane o, d, active in
    and the key out (29 B; the octant key reads no origin, 17 B), and the
    boxes or the Morton bounds."""
    if treelet_bounds is not None:
        return 29 * n + treelet_bounds.numel() * 4
    return 29 * n + 24 if morton_bounds is not None else 17 * n


def _sortkey_bar(label, r):
    """The sorted calls of one frame of `r`, recorded at `sort._ray_perm`:
    the kernel's key (csrc/sortkey.cu) equal to the plain key's bit for bit
    on every call; on the first call (the first bounce's closest-hit sort)
    the kernel and the plain key timed by CUDA events beside the byte bound,
    and on a Morton frame the octant variant checked and timed too."""
    from ilgpu_raytracing_tpu_torch.ops import sort
    from ilgpu_raytracing_tpu_torch.ops.cuda import sortkey

    calls = []
    real = sort._ray_perm

    def record(o, d, active, morton_bounds, treelet_bounds=None):
        calls.append((o.clone(), d.clone(), active.clone(), morton_bounds, treelet_bounds))
        return real(o, d, active, morton_bounds, treelet_bounds)

    sort._ray_perm = record
    try:
        r.render().cpu()
    finally:
        sort._ray_perm = real
    torch.cuda.synchronize()

    def differ(args):
        return int((sortkey.ray_key(*args) != sort.ray_key_plain(*args)).sum())

    diff = [differ(args) for args in calls]
    check(not any(diff), f"{label} sort key: keys differ from the plain key's {diff}")
    log(f"{label} sort key: {len(calls)} sorted calls of a frame "
        f"({[c[0].shape[0] for c in calls]} lanes), the kernel's key equal to the "
        f"plain key's on every lane")
    o, d, act, mb, tb = calls[0]
    arms = [("treelet" if tb is not None else "Morton", mb, tb)]
    if tb is None:
        arms.append(("octant", None, None))
        check(differ((o, d, act, None, None)) == 0, f"{label} octant key differs")
    n = o.shape[0]
    for name, mb_, tb_ in arms:
        ms_k = cuda_ms(lambda: sortkey.ray_key(o, d, act, mb_, tb_), 20)
        ms_p = cuda_ms(lambda: sort.ray_key_plain(o, d, act, mb_, tb_), 5)
        nb = _sort_key_bytes(n, mb_, tb_)
        b = bound(nb, 0)
        log(f"{label} sort key, {name}: {n} lanes ({int(act.sum())} live"
            f"{f', {tb_.shape[0]} boxes' if tb_ is not None else ''}): kernel "
            f"{ms_k:.4f} ms, {nb} bytes, bound {b['bound_ms']:.4f} ms "
            f"({100 * b['bound_ms'] / ms_k:.2f}% of it), plain key {ms_p:.4f} ms")


def _clone_args(x):
    """A copy of a recorded argument: tensors and dataclasses of them
    cloned, anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if hasattr(x, "map"):
        return x.map(lambda t: t.clone())
    return x


def _restir_bits_differ(a, b) -> dict:
    """Lanes on which two (state, res, sel) results of restir_direct differ
    in any bit, per output."""
    (st_a, res_a, sel_a), (st_b, res_b, sel_b) = a, b
    pairs = {"state": (st_a, st_b)}
    pairs.update({k: (getattr(res_a, k), getattr(res_b, k)) for k in vars(res_a)})
    pairs.update({f"sel.{k}": (sel_a[k], sel_b[k]) for k in sel_a})
    out = {}
    for k, (x, y) in pairs.items():
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        out[k] = int((x != y).reshape(x.shape[0], -1).any(dim=1).sum())
    return out


def _restir_bytes(n_lanes: int, n_pixels: int, reuse: bool) -> int:
    """Bytes a ReSTIR call must move, each read or written once: per lane
    state, active, normal, albedo in (33 B) and the 12 outputs (70 B); with
    reuse also position and the two reuse masks (14 B), and per pixel its
    pixel_idx (4 B), its G-buffer row (28 B) and previous reservoir row
    read by the imports (32 B)."""
    return n_lanes * (33 + 70 + (14 if reuse else 0)) + (n_pixels * 64 if reuse else 0)


def phase_restir(dev, bench, size=(1920, 1080)):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import restir
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    for line in cu.ptxas_info("restir"):
        log(f"ptxas restir.cu: {line}")
    r = Renderer(*size, RenderConfig(spp=2, max_depth=3), bench["scene"],
                 _orbit_camera(0.0, *size), device=dev)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    for k in range(2):  # fills res_prev
        r.render()
        r.set_camera(_orbit_camera(0.05 * (k + 1), *size))
    calls = []
    kernel = restir.restir_direct

    def record(*args, **kw):
        calls.append(([_clone_args(a) for a in args],
                      {k: _clone_args(v) for k, v in kw.items()}))
        return kernel(*args, **kw)

    restir.restir_direct = record
    try:
        r.render()
    finally:
        restir.restir_direct = kernel
    torch.cuda.synchronize()
    check(len(calls) == r.cfg.max_depth,
          f"ReSTIR: {len(calls)} calls in a frame of {r.cfg.max_depth} bounces")
    check(calls[0][1]["static_reuse"] and not calls[1][1]["static_reuse"],
          "ReSTIR: reuse is not on the first bounce alone")
    n_px = r.in_w * r.in_h
    arms = (("with reuse", calls[0][0], calls[0][1]),
            ("without reuse", calls[1][0], calls[1][1]),
            ("with reuse, reference weighting", calls[0][0],
             {**calls[0][1], "reference_weighting": True}))
    for label, args, kw in arms:
        n = args[5].shape[0]
        reuse = bool(kw["static_reuse"])
        diff = _restir_bits_differ(kernel(*args, **kw),
                                   restir.restir_direct_plain(*args, **kw))
        ms_k = cuda_ms(lambda: kernel(*args, **kw), 20)
        ms_p = cuda_ms(lambda: restir.restir_direct_plain(*args, **kw), 3)
        nb = _restir_bytes(n, n_px, reuse)
        b = bound(nb, 0)
        log(f"ReSTIR {label}: {n} lanes ({int(args[4].sum())} active), lanes whose "
            f"bits differ from the plain body's {diff}; kernel {ms_k:.4f} ms, "
            f"{nb} bytes, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
            f"{100 * b['bound_ms'] / ms_k:.2f}% of it), plain body {ms_p:.3f} ms")
        check(not any(diff.values()), f"ReSTIR {label}: kernel != plain body {diff}")


def _surface_bits_differ(a, b) -> dict:
    """Lanes on which two Surfaces differ in any bit, per output."""
    out = {}
    for k in vars(a):
        x, y = getattr(a, k), getattr(b, k)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        out[k] = int((x != y).reshape(x.shape[0], -1).any(dim=1).sum())
    return out


def _shade_calls(label, r):
    """The `shade_hits` calls of one frame of `r`, recorded at
    `traverse.shade_hits` with their lanes cloned: one launch a call."""
    from ilgpu_raytracing_tpu_torch.ops import traverse
    from ilgpu_raytracing_tpu_torch.ops.cuda import shade

    calls = []
    real = traverse.shade_hits

    def record(scene, hit, o, d):
        calls.append((scene, dataclasses.replace(
            hit, **{k: v.clone() for k, v in vars(hit).items()}), o.clone(), d.clone()))
        return real(scene, hit, o, d)

    traverse.shade_hits = record
    before = shade.LAUNCHES["shade"]
    try:
        r.render().cpu()
    finally:
        traverse.shade_hits = real
    torch.cuda.synchronize()
    check(len(calls) == r.cfg.max_depth and shade.LAUNCHES["shade"] - before == len(calls),
          f"{label} shade: {len(calls)} calls and {shade.LAUNCHES['shade'] - before} "
          f"launches in a frame of {r.cfg.max_depth} bounces")
    return calls


def _shade_bar(label, calls):
    """Every recorded call: the kernel's surface equal to the plain body's
    bit for bit."""
    from ilgpu_raytracing_tpu_torch.ops import traverse

    diff = [_surface_bits_differ(traverse.shade_hits_kernel(*a),
                                 traverse.shade_hits_plain(*a)) for a in calls]
    log(f"{label} shade: {len(calls)} calls of a frame "
        f"({[a[2].shape[0] for a in calls]} lanes, "
        f"{[int(a[1].hit.sum()) for a in calls]} hits), lanes whose bits differ from "
        f"the plain body's {diff}")
    check(not any(any(d.values()) for d in diff), f"{label} shade: kernel != plain {diff}")


def _shade_kernel_ms(args, reps: int) -> float:
    """The launch's own device ms: the arguments checked and packed once,
    then only the C entry called between the CUDA events, so the host's
    per-call checks do not pace the loop."""
    import ctypes

    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops.cuda import shade

    scene, hit, o, d = args
    packed, _out, _keep = shade.pack(scene, hit.t, hit.kind, hit.prim, hit.inst,
                                     hit.bu, hit.bv, o, d)
    lib, _ = shade.library()
    stream = cu.stream_ptr(o)
    return cuda_ms(lambda: cu.check(lib, "shade", lib.shade_hits(ctypes.byref(packed),
                                                                 stream)), reps)


def phase_shade(dev, bench, size=(1920, 1080)):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import traverse
    from ilgpu_raytracing_tpu_torch.ops.cuda import host_check
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    for line in cu.ptxas_info("shade"):
        log(f"ptxas shade.cu: {line}")
    r = Renderer(*size, RenderConfig(spp=2, max_depth=3), bench["scene"],
                 _orbit_camera(0.0, *size), device=dev)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    r.render()
    r.set_camera(_orbit_camera(0.05, *size))
    real = traverse.shade_hits
    calls = _shade_calls("Cornell", r)
    _shade_bar("Cornell", calls)
    for label, args in (("primary", calls[0]), ("bounce 0", calls[1])):
        n = args[2].shape[0]
        ms_k = _shade_kernel_ms(args, 50)
        ms_w = cuda_ms(lambda: traverse.shade_hits_kernel(*args), 20)
        ms_p = cuda_ms(lambda: traverse.shade_hits_plain(*args), 3)
        nb = 96 * n  # per lane the hit record, o and d in (48 B), the surface out (48 B)
        b = bound(nb, 0)
        log(f"shade {label}: {n} lanes ({int(args[1].hit.sum())} hits): kernel "
            f"{ms_k:.4f} ms, {nb} bytes, bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
            f"{100 * b['bound_ms'] / ms_k:.2f}% of it); wrapper calls back to back "
            f"{ms_w:.4f} ms, plain body {ms_p:.3f} ms ({smi_line()})")
    # whole frames: the kernel against the plain body in its place, from one seed
    frames = {}
    for arm, fn in (("kernel", traverse.shade_hits_kernel),
                    ("plain", traverse.shade_hits_plain)):
        rr = Renderer(*size, RenderConfig(spp=2, max_depth=3), bench["scene"],
                      _orbit_camera(0.0, *size), device=dev)
        rr.sun_azimuth, rr.sun_elevation = 0.3, 0.6
        traverse.shade_hits = fn
        try:
            for k in range(3):
                rr.set_camera(_orbit_camera(0.05 * k, *size))
                frames.setdefault(arm, []).append((rr.render().cpu(),
                                                   rr._last_aux["color"].cpu()))
        finally:
            traverse.shade_hits = real
    same = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(frames["kernel"], frames["plain"])]
    log(f"shade whole frames: 3 bench frames with the kernel and with the plain body in "
        f"its place, packed frame and colour bit-equal: {same}")
    check(all(same), f"shade whole frames differ: {same}")
    for case in host_check.SHADE_CASES:
        args = host_check.shade_case(case, 8)
        args = dict(scene=args["scene"].to(dev), o=args["o"].to(dev), d=args["d"].to(dev),
                    hit=dataclasses.replace(args["hit"], **{
                        k: v.to(dev) for k, v in vars(args["hit"]).items()}))
        diff = _surface_bits_differ(traverse.shade_hits_kernel(**args),
                                    traverse.shade_hits_plain(**args))
        kinds = {k: int(v.sum()) for k, v in host_check.shade_lanes(args).items()}
        log(f"shade case {case}: {args['o'].shape[0]} lanes {kinds}, lanes whose bits "
            f"differ from the plain body's {diff}")
        check(not any(diff.values()), f"shade case {case}: kernel != plain body {diff}")


def _bounce_bar(label, r) -> dict:
    """One frame of `r` with every `scatter` and `resolve` call held to the
    plain body bit for bit as it happens (ops/cuda/host_check.compare_bounce
    with nothing loose; the kernel's result goes on). Returns the first
    bounce's two calls, cloned: {"scatter": args, "resolve": args}."""
    from ilgpu_raytracing_tpu_torch.ops import integrator
    from ilgpu_raytracing_tpu_torch.ops.cuda import host_check

    diffs, lanes, first = [], [], {}
    real = integrator.scatter, integrator.resolve

    def spy(kind):
        def run(*args):
            d = host_check.compare_bounce(kind, list(args), loose=())
            diffs.append({k: v for k, v in d.items() if v})
            lanes.append(args[0].pos.shape[0])
            first.setdefault(kind, [host_check.clone_args(a) for a in args])
            return getattr(integrator, kind + "_kernel")(*args)
        return run

    integrator.scatter, integrator.resolve = spy("scatter"), spy("resolve")
    try:
        r.render().cpu()
    finally:
        integrator.scatter, integrator.resolve = real
    torch.cuda.synchronize()
    check(len(diffs) == 2 * r.cfg.max_depth,
          f"{label} bounce: {len(diffs)} calls in a frame of {r.cfg.max_depth} bounces")
    log(f"{label} bounce: {len(diffs)} scatter and resolve calls of a frame ({lanes} lanes), "
        f"outputs whose bits differ from the plain body's {diffs}")
    check(not any(diffs), f"{label} bounce: kernel != plain body {diffs}")
    return first


def _bounce_kernel_ms(kind: str, args, reps: int) -> tuple[float, int]:
    """(the launch's own device ms, a lower bound on the bytes it moves,
    ops/cuda/bounce.needed_bytes):
    the arguments checked and packed once, then only the C entry called
    between the CUDA events."""
    import ctypes

    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import integrator
    from ilgpu_raytracing_tpu_torch.ops.cuda import bounce

    t, kw = getattr(integrator, kind + "_launch_args")(*args)
    packed, out, keep = getattr(bounce, "pack_" + kind)(t, **kw)
    lib, _ = bounce.library()
    entry = getattr(lib, "bounce_" + kind)
    stream = cu.stream_ptr(keep[0])
    ms = cuda_ms(lambda: cu.check(lib, "bounce", entry(ctypes.byref(packed), stream)), reps)
    return ms, bounce.needed_bytes(kind, t, out)


def _bounce_times(label, first: dict, reps: int) -> None:
    from ilgpu_raytracing_tpu_torch.ops import integrator

    for kind in ("scatter", "resolve"):
        args = first[kind]
        n = args[0].pos.shape[0]
        ms_k, nb = _bounce_kernel_ms(kind, args, reps)
        ms_p = cuda_ms(lambda: getattr(integrator, kind + "_plain")(*args), 3)
        b = bound(nb, 0)
        log(f"bounce {kind}, {label} bounce 0: {n} lanes: kernel {ms_k:.4f} ms, {nb} bytes "
            f"needed ({nb / n:.1f} a lane), bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
            f"{100 * b['bound_ms'] / ms_k:.2f}% of it), plain body {ms_p:.3f} ms "
            f"({smi_line()})")


def oneweekend_renderer(dev):
    """A Renderer of the 16-spp sphere cell's scene and settings
    (benchmark/configs/oneweekend-16spp.json, its sweep's first pose); also
    the scene of tools/torch_frame_profile.py --scene oneweekend."""
    from benchmark.harness.program import build_scene
    from benchmark.scenes import oneweekend
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.camera import Camera
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark",
                           "configs", "oneweekend-16spp.json")) as f:
        conf = json.load(f)
    spec = oneweekend.build(conf["scene"]["params"])
    _, scene = build_scene(spec, conf["scene"]["build"], dev)
    keys = {f.name for f in dataclasses.fields(RenderConfig)}
    render = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["render"].items()
              if k in keys}
    cfg = RenderConfig(**render)
    cam = Camera.look_at((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0,
                         16.0 / 9.0)
    r = Renderer(conf["render"]["out_w"], conf["render"]["out_h"], cfg, scene, cam,
                 device=dev)
    r.sun_azimuth, r.sun_elevation = cfg.sun_azimuth, cfg.sun_elevation
    return r


def phase_bounce(dev, bench, size=(1920, 1080)):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import integrator
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    for line in cu.ptxas_info("bounce"):
        log(f"ptxas bounce.cu: {line}")
    r = Renderer(*size, RenderConfig(spp=2, max_depth=3), bench["scene"],
                 _orbit_camera(0.0, *size), device=dev)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    r.render()
    r.set_camera(_orbit_camera(0.05, *size))
    _bounce_times("Cornell", _bounce_bar("Cornell", r), 20)
    # the sun traced like any other light: bounce 0 hands the sun's
    # direction without its occlusion
    r = Renderer(*size, RenderConfig(spp=2, max_depth=3, dedup_sun_shadow=False),
                 bench["scene"], _orbit_camera(0.0, *size), device=dev)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    first = _bounce_bar("Cornell, dedup_sun_shadow off", r)
    check(first["scatter"][7] is None, "dedup_sun_shadow off: bounce 0 got a sun occlusion")
    # whole frames: the kernels against the plain bodies in their place
    frames = {}
    real = integrator.scatter, integrator.resolve
    for arm, fns in (("kernel", real),
                     ("plain", (integrator.scatter_plain, integrator.resolve_plain))):
        rr = Renderer(*size, RenderConfig(spp=2, max_depth=3), bench["scene"],
                      _orbit_camera(0.0, *size), device=dev)
        rr.sun_azimuth, rr.sun_elevation = 0.3, 0.6
        integrator.scatter, integrator.resolve = fns
        try:
            for k in range(3):
                rr.set_camera(_orbit_camera(0.05 * k, *size))
                frames.setdefault(arm, []).append((rr.render().cpu(),
                                                   rr._last_aux["color"].cpu()))
        finally:
            integrator.scatter, integrator.resolve = real
    same = [torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
            for a, b in zip(frames["kernel"], frames["plain"])]
    log(f"bounce whole frames: 3 bench frames with the kernels and with the plain bodies in "
        f"their place, packed frame and colour bit-equal: {same}")
    check(all(same), f"bounce whole frames differ: {same}")
    del r, rr, frames
    # the 16-spp sphere scene: 14,417,920 lanes a bounce
    r = oneweekend_renderer(dev)
    depth = r.cfg.max_depth
    _drive("sphere main path", r, 2,
           _want(wide_closest=depth, wide_shadow=depth + 2, sortpos=2 * depth),
           restir_per_frame=depth, shade_per_frame=depth, bounce_per_frame=depth)
    _bounce_times("sphere", _bounce_bar("sphere", r), 10)


def _meshes(dev):
    from ilgpu_raytracing_tpu_torch.parallel import sharding as shrd

    return (("make_mesh()", shrd.make_mesh()),
            (f"{dev} x 4", shrd.make_mesh(devices=[dev] * 4)))


def _mesh_route(route, dev, bench, meshes, kscene, want):
    """The bench frame of one route through Renderer(mesh=...) on `meshes`,
    in turns with the single-device Renderer of the same seed: packed frame
    and low-res colour bit-equal every frame, launches `want(n)` a frame.
    `kscene` (None: the Renderer's own wide tables) is set as `r.wscene`
    on every Renderer: each mesh Renderer replicates it onto its mesh once.
    Returns (launches of the timed frames, ms/frame by arm, the
    gathers' bytes of each arm's last frame, the internal pixel count)."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import cornell_camera
    from ilgpu_raytracing_tpu_torch.ops.cuda import bounce, shade
    from ilgpu_raytracing_tpu_torch.parallel import sharding as shrd
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    arms = (("single device", None),) + meshes
    rs = []
    for _, mesh in arms:
        r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=3), bench["scene"],
                     cornell_camera(1920, 1080), mesh=mesh, device=dev)
        r.sun_azimuth, r.sun_elevation = 0.3, 0.6
        if kscene is not None:
            r.wscene = kscene
        rs.append(r)
    check(len({(r.in_w, r.in_h) for r in rs}) == 1, "mesh internal resolution differs")
    frame_ms = {label: [] for label, _ in arms}
    gathers = {}
    total = {}
    meshed = {}
    for f in range(1 + MESH_FRAMES):
        ref = None
        for (label, mesh), r in zip(arms, rs):
            n = 1 if mesh is None else mesh.size
            torch.cuda.synchronize()
            _reset_counts()
            shrd.GATHER_BYTES.update(copied=0, moved=0)
            t0 = time.monotonic()
            packed = r.render().cpu()
            torch.cuda.synchronize()
            ms = (time.monotonic() - t0) * 1e3
            counts = _read_counts()
            check(counts == want(n), f"mesh {route} {label} frame {f} launch counts {counts}")
            # primary and bounces 0-1 shaded in each of the n blocks
            check(shade.LAUNCHES["shade"] == 3 * n,
                  f"mesh {route} {label} frame {f}: {shade.LAUNCHES['shade']} shading "
                  f"launches, not {3 * n}")
            check(bounce.LAUNCHES == dict(scatter=3 * n, resolve=3 * n),
                  f"mesh {route} {label} frame {f}: bounce launches {bounce.LAUNCHES}, not "
                  f"{3 * n} each")
            color = r._last_aux["color"]
            if ref is None:
                ref = (packed, color)
            else:
                dc = (color - ref[1]).abs()
                check(torch.equal(packed, ref[0]) and torch.equal(color, ref[1]),
                      f"mesh {route} {label} frame {f} differs from the single-device "
                      f"frame: {int((packed != ref[0]).sum())} packed pixels, "
                      f"{int((dc > 0).any(dim=1).sum())} colour pixels (max abs "
                      f"{float(dc.max()):.3e})")
                # the kernel scene is replicated once, not every frame
                reps = r._kscene_replicas()
                check(r._kscenes[0] is r.wscene and meshed.setdefault(label, reps) is reps
                      and len({id(c) for c in reps.copies}) == len(mesh.distinct_devices),
                      f"mesh {route} {label} frame {f}: the kernel scene was replicated "
                      f"again")
            gathers[label] = dict(shrd.GATHER_BYTES)
            if f:
                frame_ms[label].append(ms)
                total = {k: total.get(k, 0) + v for k, v in counts.items()}
    return total, frame_ms, gathers, rs[0].in_w * rs[0].in_h


def phase_mesh(dev, bench, meshes=None):
    """The bench frame through Renderer(mesh=...) on `meshes` (default
    make_mesh(), every card of the machine, and a simulated 4-block mesh
    of cuda:0), in turns with the single-device Renderer of the same seed:
    packed frame and low-res colour bit-equal every frame, launches n times
    the single-device ones, ms/frame, the gathers' bytes; on the wide route
    (K1/K2/K3) and on the binary route (K6/K3, a caller's BinaryScene)."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary

    meshes = meshes or _meshes(dev)
    total = {}
    t0 = time.monotonic()
    bs = binary.prepare_binary(bench["scene"])
    prep_s = time.monotonic() - t0
    for route, kscene, want in (
            ("wide", None, lambda n: _want(wide_closest=3 * n, wide_shadow=5 * n,
                                           sortpos=6 * n)),
            ("binary", bs, lambda n: _want(binary_closest=3 * n, binary_shadow=5 * n,
                                           sortpos=6 * n))):
        counts, frame_ms, gathers, in_n = _mesh_route(route, dev, bench, meshes, kscene, want)
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        kernels = "K1 3n, K2 5n, K3 6n" if kscene is None else "K6 3n + 5n, K3 6n"
        log(f"mesh frames, {route} route: packed frame and aux color bit-equal to the "
            f"single-device Renderer on all {1 + MESH_FRAMES} frames of each mesh; "
            f"launches per frame {kernels}, shading 3n"
            + ("" if kscene is None else f"; BinaryScene prepared once in {prep_s:.3f} s "
               f"and replicated once by each mesh Renderer"))
        log(f"mesh frame ms in turns, {route} route ({smi_line()}), {MESH_FRAMES} frames "
            f"after a warm-up: "
            + "; ".join(f"{label} {[round(x, 3) for x in v]} (mean {np.mean(v):.3f})"
                        for label, v in frame_ms.items()))
        for label, mesh in meshes:
            per_device = (mesh.size - 1) / mesh.size * 109 * in_n
            log(f"mesh {label}, {route} route, gathers a frame: "
                f"{gathers[label]['copied']} B copied, {gathers[label]['moved']} B moved "
                f"between devices; a mesh of {mesh.size} distinct devices would move "
                f"{per_device:.0f} B to each ((n-1)/n x 109 B/px x {in_n} px: G-buffer "
                f"49, reservoirs 48, packed low-res + object ids 12)")
    return total


def _example(name):
    """examples/<name>.py of this checkout, loaded by path."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_config1_parity(dev):
    """BASELINE config 1 through examples/torch_parity_check.py's
    `mean_var` and `compare`: the default sphere scene at PARITY_SIZE^2,
    spp 1, max_depth 1, reuse off, over PARITY_SEEDS noise seeds, the
    kernels on the card against the plain versions on the CPU: the RMSE of
    the per-pixel means over the 95% of pixels away from discrete-decision
    boundaries within 1.5x the Monte-Carlo floor (`within_noise_floor`).
    Both sides draw the same seeds, so the per-pixel means are also held to
    the 64x64 card-vs-CPU bar: mean |diff| < 0.02 and under 1% of pixels
    off by more than 0.1."""
    parity = _example("torch_parity_check")
    shape = (PARITY_SIZE, 1, 1, PARITY_SEEDS)
    t0 = time.monotonic()
    mean_a, var_a = parity.mean_var(torch.device("cpu"), *shape)
    s_cpu = time.monotonic() - t0
    t0 = time.monotonic()
    mean_b, var_b = parity.mean_var(dev, *shape)
    s_card = time.monotonic() - t0
    check(np.isfinite(mean_b).all(), "config 1 means on the card are not finite")
    res = parity.compare(mean_a, var_a, mean_b, var_b, *shape)
    diff = np.abs(mean_a - mean_b)
    frac = float((diff.max(axis=1) > 0.1).mean())
    log(f"parity config 1 ({PARITY_SIZE}x{PARITY_SIZE}, spp 1, depth 1, {PARITY_SEEDS} "
        f"seeds; card {s_card:.1f} s, CPU plain versions {s_cpu:.1f} s): rmse_of_means "
        f"{res['rmse_of_means']:.6f}, rmse_robust_p95 {res['rmse_robust_p95']:.6f}, "
        f"noise_floor {res['noise_floor']:.6f}, robust/floor "
        f"{res['robust_over_floor']:.4f}, mean |diff| of the means {diff.mean():.6f}, "
        f"pixels > 0.1: {frac:.5%}, signal_rms {res['signal_rms']:.6f}")
    check(res["within_noise_floor"], f"config 1 parity: {res['rmse_robust_p95']:.6f} > "
          f"1.5 x {res['noise_floor']:.6f}")
    # both sides draw the same seeds through the same code, so the means
    # are also held per pixel, to the 64x64 card-vs-CPU bar (`_parity`)
    check(diff.mean() < 0.02, f"config 1 parity: mean |diff| of the means {diff.mean():.5f}")
    check(frac < 0.01, f"config 1 parity: {frac:.3%} pixels' means off by > 0.1")


def _binary_bar(bs, o, d, label):
    """K6 vs its plain version on one ray set: hit masks equal and t, prim,
    inst equal on every ray (bu, bv too), any-hit equal at t_max 5 and
    1e29, and the counting variant's (boxes, primitives) equal to those the
    plain skip walk tests (closest, and any-hit at 1e29). Returns the max
    |t_kernel - t_plain| (0 when bit-identical)."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    n = o.shape[0]
    tm = torch.full((n,), T_INF, device=o.device)
    t0 = time.monotonic()
    got = binary.trace_binary_raw(bs, o, d, tm)
    want = binary.trace_plain(bs, o, d, tm)
    torch.cuda.synchronize()
    hit_k, hit_p = got[1] >= 0, want[1] >= 0
    check(bool(torch.equal(hit_k, hit_p)),
          f"K6 {label}: hit masks differ on {int((hit_k != hit_p).sum())} rays")
    for name, a, b in zip(("t", "prim", "inst", "bu", "bv"), got, want):
        n_diff = int((a != b).sum())
        check(n_diff == 0, f"K6 {label}: {name} differs from plain on {n_diff} rays")
    err = float((got[0] - want[0]).abs().max())
    for t_max in (5.0, 1e29):
        tt = torch.full((n,), t_max, device=o.device)
        occ_k = binary.shadow_occlusion_binary(bs, o, d, tt)
        n_diff = int((occ_k != binary.shadow_plain(bs, o, d, tt)).sum())
        check(n_diff == 0, f"K6 any-hit {label} t_max={t_max}: {n_diff} of {n} differ")
    counts = []  # the counting variant against the skip walk's boxes and primitives
    for t_max, any_hit in ((T_INF, False), (1e29, True)):
        tt = torch.full((n,), t_max, device=o.device)
        plain = [0, 0]
        binary._walk_plain(bs, o, d, tt, any_hit, plain)
        counts.append(binary.count_work(bs, o, d, tt, any_hit))
        check(list(counts[-1]) == plain, f"K6 {label} any_hit={any_hit}: the counting "
              f"variant counts {counts[-1]}, the skip walk tests {plain}")
    log(f"K6 {label} n={n}: hits {int(hit_k.sum())}, hit masks equal, t/prim/inst/bu/bv "
        f"equal to plain on every ray, any-hit equal at t_max 5 and 1e29; counts equal "
        f"to the skip walk's (closest {counts[0]}, any-hit {counts[1]}) "
        f"({time.monotonic() - t0:.2f} s)")
    return err


def route_pair(ws, bs, bo, bd, act, tmb, tms, n_alive):
    """K1 beside K6 closest and K2 beside K6 any-hit on the same bench bounce
    lanes, in turns (K1, K6, K6, K1): one paired line for the route
    question, wide against binary tables."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary, wide

    calls = dict(
        k1=lambda: wide.trace_closest_wide_packed(ws, bo, bd, active=act),
        k6c=lambda: binary.trace_binary_raw(bs, bo, bd, tmb),
        k2=lambda: wide.shadow_occlusion_wide(ws, bo, bd, 1e29, active=act),
        k6s=lambda: binary.shadow_occlusion_binary(bs, bo, bd, tms))
    ms = {k: [] for k in calls}
    for order in (("k1", "k6c", "k2", "k6s"), ("k6s", "k2", "k6c", "k1")):
        for k in order:
            ms[k].append(cuda_ms(calls[k], 10))
    txt = {k: ", ".join(f"{v:.4f}" for v in vals) for k, vals in ms.items()}
    log(f"route pair on the {bo.shape[0]} bench bounce lanes ({n_alive} live), in "
        f"turns: closest K1 {txt['k1']} ms, K6 {txt['k6c']} ms; any-hit K2 {txt['k2']} "
        f"ms, K6 {txt['k6s']} ms")


def phase_k6(dev, results, bench):
    """K6 on the bench scene's primary rays and sorted bounce lanes."""
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    for line in cu.ptxas_info("binary_trace"):
        log(f"ptxas binary_trace.cu: {line}")
    t0 = time.monotonic()
    bs = binary.prepare_binary(bench["scene"])
    cap = binary.library()[0].binary_max_depth()
    log(f"K6 tables: {bs.nodes.shape[0]} nodes, {bs.tri.shape[0]} triangle leaf rows, "
        f"{bs.pairs.shape[0]} child-pair records ({bs.pairs.numel() * 4} B), "
        f"{bs.roots.shape[0]} root records ({bs.roots.numel() * 4} B), depth {bs.depth} "
        f"(cap {cap}; shared stack {bs.depth} x 128 x 4 B a block), prep "
        f"{time.monotonic() - t0:.2f} s")
    o, d = bench["o"], bench["d"]
    bo, bd, act, n_alive = bench["bo"], bench["bd"], bench["act"], bench["n_alive"]
    n = o.shape[0]
    err = _binary_bar(bs, _strided(o, n, SUBSET), _strided(d, n, SUBSET), "primary")
    so, sd = _strided(bo, n_alive, SUBSET), _strided(bd, n_alive, SUBSET)
    err = max(err, _binary_bar(bs, so, sd, "bounce (sorted, live lanes)"))
    # the deepest stack the kernel takes: cap x 128 x 4 B of shared memory a
    # block, past the 48 KB a launch gets without opting in
    deep = dataclasses.replace(bs, depth=cap)
    stm = torch.full((SUBSET,), T_INF, device=dev)
    same = all(bool(torch.equal(a, b)) for a, b in
               zip(binary.trace_binary_raw(deep, so, sd, stm),
                   binary.trace_binary_raw(bs, so, sd, stm)))
    same = same and bool(torch.equal(
        binary.shadow_occlusion_binary(deep, so, sd, stm),
        binary.shadow_occlusion_binary(bs, so, sd, stm)))
    check(same, f"K6 with a stack bound of {cap} differs from K6 at depth {bs.depth}")
    log(f"K6 with a stack bound of {cap} ({cap * 128 * 4} B of shared memory a block): "
        f"closest and any-hit equal to K6 at depth {bs.depth} on {SUBSET} bounce lanes")
    nb = bo.shape[0]
    tmb = torch.where(act, torch.full((nb,), T_INF, device=dev), torch.zeros(nb, device=dev))
    tms = torch.where(act, torch.full((nb,), 1e29, device=dev), torch.zeros(nb, device=dev))
    ms_c = cuda_ms(lambda: binary.trace_binary_raw(bs, bo, bd, tmb), 10)
    ms_s = cuda_ms(lambda: binary.shadow_occlusion_binary(bs, bo, bd, tms), 10)
    ms_p = cuda_ms(lambda: binary.trace_binary_raw(bs, o, d, torch.full((n,), T_INF,
                                                                         device=dev)), 10)
    route_pair(bench["ws"], bs, bo, bd, act, tmb, tms, n_alive)
    plain_c = cuda_ms(lambda: binary.trace_plain(bs, so, sd, stm), 1)
    plain_s = cuda_ms(lambda: binary.shadow_plain(bs, so, sd, torch.full_like(stm, 1e29)), 1)
    log(f"K6 bounce {nb} lanes ({n_alive} live): closest {ms_c:.4f} ms, any-hit "
        f"{ms_s:.4f} ms; primary {n} lanes: closest {ms_p:.4f} ms; plain on {SUBSET} "
        f"live bounce lanes: closest {plain_c:.4f} ms, any-hit {plain_s:.4f} ms")
    # what the kernel reads: the records, the leaf rows and the instance
    # tables; `flat`: the flat tables that the skip walk (the parent) read
    tables = (bs.pairs, bs.roots, bs.tri, bs.sph, bs.inst_i, bs.inst_f)
    flat = (bs.nodes, bs.node_i, bs.tri, bs.sph, bs.inst_i, bs.inst_f)
    w_c = binary.count_work(bs, bo, bd, tmb, any_hit=False)
    w_s = binary.count_work(bs, bo, bd, tms, any_hit=True)
    log(f"K6 bounce work: closest {w_c[0]} boxes, {w_c[1]} primitives, bound "
        f"{trace_bound(nb, w_c, False, BOX_OPS, tables, 20)} (over the flat tables "
        f"{trace_bound(nb, w_c, False, BOX_OPS, flat, 20)}); any-hit {w_s[0]} boxes, "
        f"{w_s[1]} primitives, bound {trace_bound(nb, w_s, True, BOX_OPS, tables)} "
        f"(over the flat tables {trace_bound(nb, w_s, True, BOX_OPS, flat)})")
    case = dict(bs={f: getattr(bs, f) for f in bs.__dataclass_fields__}, o=bo, d=bd,
                tm=tmb)
    log(f"K6 with a stack cap of 1 on the bench bounce lanes: the child process failed: "
        f"{_overflow_fails('K6', K6_OVERFLOW_CHILD, case)}")
    results["binary_closest"] = dict(max_abs_err=err, ms=ms_c, plain_ms=plain_c,
                                     **trace_bound(nb, w_c, False, BOX_OPS, tables, 20),
                                     library_ms=None)
    results["binary_shadow"] = dict(max_abs_err=0.0, ms=ms_s, plain_ms=plain_s,
                                    **trace_bound(nb, w_s, True, BOX_OPS, tables),
                                    library_ms=None)


def phase_k6_parity(dev):
    from ilgpu_raytracing_tpu_torch.models.cornell import (
        build_cornell_scene,
        cornell_camera,
    )
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary

    _, scene = build_cornell_scene(tess=4, sphere_tess=(8, 12), device="cpu")
    _parity(dev, "Cornell (BinaryScene)", scene, binary.prepare_binary, cornell_camera)


def phase_k6_main_path(dev, bench):
    """The bench frame through Renderer with r.wscene = prepare_binary(scene),
    held to the K1/K2 frame of the same seed and frame count."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import cornell_camera
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    def renderer():
        r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=3), bench["scene"],
                     cornell_camera(1920, 1080), device=dev)
        r.sun_azimuth, r.sun_elevation = 0.3, 0.6
        return r

    ref = renderer()
    for _ in range(1 + K6_FRAMES):
        ref.render()
    want = ref.frame_rgb().astype(np.int32)
    del ref
    r = renderer()
    t0 = time.monotonic()
    r.wscene = binary.prepare_binary(r.scene)
    log(f"K6 Renderer: BinaryScene prepared in {time.monotonic() - t0:.3f} s")
    counts = _drive("K6 bench frame (BinaryScene)", r, K6_FRAMES,
                    _want(binary_closest=3, binary_shadow=5, sortpos=6))
    got = r.frame_rgb().astype(np.int32)
    frac = float((np.abs(got - want).max(axis=-1) > 2).mean())
    log(f"K6 bench frame vs the K1/K2 frame of the same seed: {frac:.6%} of pixels off "
        f"by more than 2 levels, max {int(np.abs(got - want).max())} levels")
    check(frac < 0.01, f"K6 bench frame differs from the K1/K2 frame on {frac:.3%} pixels")
    return counts


def _first_round(fn, call):
    """Run call() with the round wrapper `fn` (a module attribute) wrapped to
    keep the arguments of its first call."""
    mod, name = fn
    real = getattr(mod, name)
    seen = []

    def spy(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return real(*args, **kw)

    setattr(mod, name, spy)
    try:
        out = call()
    finally:
        setattr(mod, name, real)
    return out, seen[0]


def _round_bar(label, launch, plain, scene, mask, o, d, tm, tile_rows):
    """One treelet round, kernel vs plain, on the first SUBSET lanes (whole
    packets): t and pp equal on every lane. Returns (max |dt|, plain ms)."""
    k = SUBSET // (tile_rows * 128)
    args = (scene, mask[:k].contiguous(), o[:SUBSET].contiguous(),
            d[:SUBSET].contiguous(), tm[:SUBSET].contiguous(), tile_rows)
    t_k, pp_k = launch(*args)
    t_p, pp_p = plain(*args)
    torch.cuda.synchronize()
    n_t, n_pp = int((t_k != t_p).sum()), int((pp_k != pp_p).sum())
    check(n_t == 0 and n_pp == 0,
          f"{label} round: t differs on {n_t}, pp on {n_pp} of {SUBSET} lanes")
    plain_ms = cuda_ms(lambda: plain(*args), 1)
    log(f"{label} one round on the first {SUBSET} sorted lanes ({k} packets): t and pp "
        f"equal to plain on every lane; plain {plain_ms:.4f} ms")
    return float((t_k - t_p).abs().max()), plain_ms


def phase_k7(dev, results, bench):
    """K7 through ops/treelet on the bench frame's sorted bounce lanes."""
    from ilgpu_raytracing_tpu_torch.ops import treelet as ops_treelet
    from ilgpu_raytracing_tpu_torch.ops.cuda import treelet, wide

    ws, bo, bd, act = bench["ws"], bench["bo"], bench["bd"], bench["act"]
    t0 = time.monotonic()
    ts = treelet.prepare_treelets(ws, 32)
    log(f"K7 treelets: {ts.n_treelets} over {ws.wide_child.numel() // 8} wide nodes "
        f"(+{(ts.wscene.wide_child.numel() - ws.wide_child.numel()) // 8} wrappers), "
        f"wide depth {ts.wscene.wide_depth}, prep {time.monotonic() - t0:.2f} s")
    t_ref, pp_ref = wide.trace_closest_wide_packed(ws, bo, bd, active=act)
    nb = bo.shape[0]

    _reset_counts()
    (t, pp, rounds), (args, _) = _first_round(
        (ops_treelet.tl, "run_treelet_trace"),
        lambda: ops_treelet.trace_closest_treelet_packed(ts, bo, bd, active=act,
                                                         with_rounds=True))
    counts = _read_counts()
    check(counts == _want(treelet=rounds, sortpos=1),
          f"K7 rounds launch counts {counts}")
    for label, (tt, pq) in (("rounds", (t, pp)),
                            ("single", ops_treelet.trace_closest_treelet_single(
                                ts, bo, bd, active=act)),
                            ("cleanup_after=1", ops_treelet.trace_closest_treelet_packed(
                                ts, bo, bd, active=act, cleanup_after=1))):
        n_t, n_pp = int((tt != t_ref).sum()), int((pq != pp_ref).sum())
        check(n_t == 0 and n_pp == 0,
              f"K7 {label}: t differs from K1 on {n_t}, pp on {n_pp} of {nb} lanes")
        log(f"K7 {label}: t and pp equal to K1 on all {nb} lanes")
    ms_rounds = cuda_ms(lambda: ops_treelet.trace_closest_treelet_packed(
        ts, bo, bd, active=act), 3)
    ms_single = cuda_ms(lambda: ops_treelet.trace_closest_treelet_single(
        ts, bo, bd, active=act), 3)
    ms_clean = cuda_ms(lambda: ops_treelet.trace_closest_treelet_packed(
        ts, bo, bd, active=act, cleanup_after=1), 3)
    log(f"K7 calls on {nb} lanes: rounds {ms_rounds:.4f} ms ({rounds} rounds, "
        f"{counts['treelet']} K7 launches, {counts['sortpos']} K3), single "
        f"{ms_single:.4f} ms (1 K7 launch), cleanup_after=1 {ms_clean:.4f} ms "
        f"(1 K7 + 1 K1 launch)")
    _ts, mask, o_s, d_s, tm, tile_rows = args
    err, plain_ms = _round_bar("K7", treelet.run_treelet_trace, treelet.round_plain,
                               ts, mask, o_s, d_s, tm, tile_rows)
    ms = cuda_ms(lambda: treelet.run_treelet_trace(ts, mask, o_s, d_s, tm, tile_rows), 10)
    work = treelet.count_work(ts, mask, o_s, d_s, tm, tile_rows)
    log(f"K7 first round on {nb} lanes: kernel {ms:.4f} ms, {work[0]} boxes, "
        f"{work[1]} primitives")
    tables = treelet.treelet_arrays(ts) + (mask,)
    results["treelet"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              **trace_bound(nb, work, False, BOX_OPS, tables),
                              library_ms=None)
    return counts


def phase_k8(dev, results, ss, lanes):
    """K8 through ops/treelet on the terrain's treelet-sorted bounce lanes."""
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import treelet as ops_treelet
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream, streamtreelet

    for line in cu.ptxas_info("streamtreelet_trace"):
        log(f"ptxas streamtreelet_trace.cu: {line}")
    bo, bd, act = lanes["bo"], lanes["bd"], lanes["act"]
    t0 = time.monotonic()
    sts = streamtreelet.prepare_treelets_stream(ss, 32)
    log(f"K8 treelets: {sts.n_treelets}, +{(sts.sscene.wide_child.numel() - ss.wide_child.numel()) // 8} "
        f"wrapper nodes, wide depth (node-group stack entries) {sts.sscene.wide_depth}, "
        f"prep {time.monotonic() - t0:.2f} s")
    t_ref, pp_ref = stream.trace_closest_stream_packed(ss, bo, bd, active=act)
    nb = bo.shape[0]
    _reset_counts()
    (t, pp, rounds), (args, _) = _first_round(
        (ops_treelet.stl, "run_treelet_stream_trace"),
        lambda: ops_treelet.trace_closest_treelet_stream_packed(sts, bo, bd, active=act,
                                                                with_rounds=True))
    counts = _read_counts()
    check(counts == _want(streamtreelet=rounds, sortpos=1),
          f"K8 rounds launch counts {counts}")
    n_t, n_pp = int((t != t_ref).sum()), int((pp != pp_ref).sum())
    check(n_t == 0 and n_pp == 0,
          f"K8 rounds: t differs from K4 on {n_t}, pp on {n_pp} of {nb} lanes")
    log(f"K8 rounds: t and pp equal to K4 on all {nb} lanes")
    ms_rounds = cuda_ms(lambda: ops_treelet.trace_closest_treelet_stream_packed(
        sts, bo, bd, active=act), 3)
    log(f"K8 rounds call on {nb} lanes: {ms_rounds:.4f} ms ({rounds} rounds, "
        f"{counts['streamtreelet']} K8 launches, {counts['sortpos']} K3)")
    _sts, mask, o_s, d_s, tm, tile_rows = args
    err, plain_ms = _round_bar("K8", streamtreelet.run_treelet_stream_trace,
                               streamtreelet.round_plain, sts, mask, o_s, d_s, tm,
                               tile_rows)
    ms = cuda_ms(lambda: streamtreelet.run_treelet_stream_trace(
        sts, mask, o_s, d_s, tm, tile_rows), 10)
    work = streamtreelet.count_work(sts, mask, o_s, d_s, tm, tile_rows)
    tables = streamtreelet.treelet_stream_arrays(sts) + (mask,)
    log(f"K8 first round on {nb} lanes: kernel {ms:.4f} ms, {work[0]} boxes, "
        f"{work[1]} primitives, bound {trace_bound(nb, work, False, QBOX_OPS, tables)}; "
        f"from the earlier walk's counts {PRIOR_K4_K8_WORK['k8_round']}: "
        f"{trace_bound(nb, PRIOR_K4_K8_WORK['k8_round'], False, QBOX_OPS, tables)}")
    results["streamtreelet"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    **trace_bound(nb, work, False, QBOX_OPS, tables),
                                    library_ms=None)
    return counts


def phase_terrain_prep(dev):
    """The 1,048,576-triangle terrain of examples/large_mesh.py: host BVH
    build (SAH, leaf 64) and streaming prep, timed apart."""
    from ilgpu_raytracing_tpu_torch.models.terrain import build_terrain_scene
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream

    t0 = time.monotonic()
    _, scene = build_terrain_scene(device=dev)
    t_build = time.monotonic() - t0
    t0 = time.monotonic()
    ss = stream.prepare_stream(scene)
    torch.cuda.synchronize()
    t_prep = time.monotonic() - t0
    check(scene.n_tris == 1_048_576, f"terrain has {scene.n_tris} triangles")
    n_rows = ss.tri_rows.shape[0]
    log(f"terrain: {scene.n_tris} tris, BVH build {t_build:.3f} s, prepare_stream "
        f"{t_prep:.3f} s; {ss.wide_child.numel() // 8} wide nodes, {n_rows} leaf rows "
        f"({ss.tri_rows.numel() * 4} bytes of tri_rows), most rows in a leaf "
        f"{ss.rows_per_leaf}, wide depth (node-group stack entries) {ss.wide_depth}")
    return scene, ss


def _stream_bar(ss, o, d, label):
    """K4/K5 vs plain on one ray set, to the bar of
    tests/test_stream_kernel.py: hit masks equal, no |dt| > 1e-3 where both
    hit, prim agreement > 99.5%, K5 equal at t_max 5 and 1e29. Returns K4's
    max |dt| and 1.0 if K5 differs anywhere."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    n = o.shape[0]
    tm = torch.full((n,), T_INF, device=o.device)
    t0 = time.monotonic()
    t_k, pp_k = stream.trace_closest_stream_packed(ss, o, d)
    t_p, pp_p = stream.trace_closest_plain(ss, o, d, tm)
    torch.cuda.synchronize()
    hit_k, hit_p = pp_k >= 0, pp_p >= 0
    n_hit_diff = int((hit_k != hit_p).sum())
    check(n_hit_diff == 0, f"K4 {label}: hit masks differ on {n_hit_diff} rays")
    both = hit_k & hit_p
    dt = (t_k - t_p).abs()[both]
    k4_err = float(dt.max()) if bool(both.any()) else 0.0
    n_far = int((dt > 1e-3).sum())
    check(n_far == 0, f"K4 {label}: |dt| > 1e-3 on {n_far} rays")
    agree = float((pp_k == pp_p)[both].float().mean()) if bool(both.any()) else 1.0
    check(agree > 0.995, f"K4 {label}: prim agreement {agree:.5f}")
    log(f"K4 {label} n={n}: hits {int(hit_k.sum())}, hit masks equal, max |dt| "
        f"{k4_err:.3e}, prim agreement {agree:.6f} ({time.monotonic() - t0:.2f} s)")
    k5_err = 0.0
    for t_max in (5.0, 1e29):
        t0 = time.monotonic()
        occ_k = stream.shadow_occlusion_stream(ss, o, d, t_max)
        occ_p = stream.shadow_plain(ss, o, d, torch.full((n,), t_max, device=o.device))
        n_diff = int((occ_k != occ_p).sum())
        check(n_diff == 0, f"K5 {label} t_max={t_max}: {n_diff} of {n} differ")
        log(f"K5 {label} t_max={t_max:g}: occluded {int(occ_k.sum())}, equal to "
            f"plain on all {n} rays ({time.monotonic() - t0:.2f} s)")
    return k4_err, k5_err


def _strided(x, n_live, k):
    """k rays at an even stride over the first n_live rows of x."""
    idx = torch.arange(0, n_live, max(1, n_live // k), device=x.device)[:k]
    return x[idx].contiguous()


def _k5_equals_k4(ss, o, d, active, label):
    """K5's occlusion equal to K4's hit mask (pp >= 0) at the same t_max, 5
    and 1e29, on every lane of a population: the two share the leaf
    predicates, and a hit below t_max exists exactly when K4 finds one."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream

    for t_max in (5.0, 1e29):
        occ = stream.shadow_occlusion_stream(ss, o, d, t_max, active=active)
        hit = stream.trace_closest_stream_packed(ss, o, d, active=active, t_max=t_max)[1] >= 0
        n_diff = int((occ != hit).sum())
        check(n_diff == 0, f"K5 {label} t_max={t_max}: differs from K4's hit mask on "
                           f"{n_diff} of {o.shape[0]} lanes")
        log(f"K5 {label} t_max={t_max:g}: occluded {int(occ.sum())}, equal to K4's hit "
            f"mask on all {o.shape[0]} lanes")


OVERFLOW_CHILD = """
import sys, torch
from ilgpu_raytracing_tpu_torch.ops.cuda import stream, wide
x = torch.load(sys.argv[1], map_location="cuda")
prefix = sys.argv[2]
lib, _ = {"stream": stream, "wide": wide}[prefix].library()
tables = [a.data_ptr() if torch.is_tensor(a) else a for a in x["tables"]]
t, pp = wide.launch_walk(lib, prefix, tables, 1, x["o"], x["d"], x["tm"], False)
torch.cuda.synchronize()
print("the walk returned", int((pp >= 0).sum()), "hits")
"""

K6_OVERFLOW_CHILD = """
import sys, torch
from ilgpu_raytracing_tpu_torch.ops.cuda import binary
x = torch.load(sys.argv[1], map_location="cuda")
bs = binary.BinaryScene(**x["bs"])
bs.depth = 1
prim = binary._launch(bs, x["o"], x["d"], x["tm"], any_hit=False)[1]
torch.cuda.synchronize()
print("the walk returned", int((prim >= 0).sum()), "hits")
"""


def _overflow_fails(label, child, case: dict, *args) -> str:
    """A closest-hit walk called with a stack cap of 1 (K1 and K4 need up
    to wide depth - 1 entries, K6 up to its depth) in a child process: the
    walk's device-side assert must fail the synchronizing call. `child` is
    OVERFLOW_CHILD (the entry of the library `args[0]`, K1 "wide" or K4
    "stream", with `case` = its scene arguments as tensors and ints, the
    lanes and t_max) or K6_OVERFLOW_CHILD (`case` = the BinaryScene's
    fields, the lanes and t_max). Returns the first line of the error that
    names the assert."""
    from ilgpu_raytracing_tpu_torch.utils.build import BUILD_DIR

    path = os.path.join(BUILD_DIR, f"{label}_overflow_case.pt")
    torch.save(case, path)
    try:
        proc = subprocess.run([sys.executable, "-c", child, path, *args],
                              capture_output=True, text=True, timeout=300,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
    finally:
        os.unlink(path)
    said = [ln for ln in proc.stderr.splitlines() if "assert" in ln.lower()]
    check(proc.returncode != 0 and bool(said),
          f"{label} passed its stack bound without an error: rc {proc.returncode}, "
          f"{proc.stdout[-300:]} {proc.stderr[-500:]}")
    return said[0].strip()


def phase_k4_k5(dev, results, scene, ss):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.terrain import terrain_camera
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu
    from ilgpu_raytracing_tpu_torch.ops import rays
    from ilgpu_raytracing_tpu_torch.ops.cuda import binary, stream
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    for line in cu.ptxas_info("stream_trace"):
        log(f"ptxas stream_trace.cu: {line}")
    depth = binary.tree_depth(scene.blas_ifields.cpu().numpy(),
                              scene.inst_blas_root.cpu().numpy())[1]
    log(f"terrain binary BVH ({scene.tri_v0.shape[0]} triangles): depth {depth}; K6's "
        f"stack holds {binary.library()[0].binary_max_depth()}")
    in_w, in_h = RenderConfig().internal_resolution(1920, 1080)
    o, d = rays.generate_primary_rays(terrain_camera(1920, 1080), in_w, in_h, dev)
    o = o.contiguous()
    n = o.shape[0]
    log(f"terrain rays: {n} primary, held to the plain walk on {SUBSET} of each "
        f"population")
    k4_err, k5_err = _stream_bar(ss, _strided(o, n, SUBSET), _strided(d, n, SUBSET),
                                 "primary")
    k4_primary_ms = cuda_ms(lambda: stream.trace_closest_stream_packed(ss, o, d), 10)
    tables = (ss.anyhit_nodes, ss.wide_perm, ss.tri_rows, ss.sph_rows, ss.inst_i,
              ss.inst_f)
    wp = stream.count_work(ss, o, d, torch.full((n,), T_INF, device=dev), any_hit=False)
    log(f"K4 primary {n} lanes: kernel {k4_primary_ms:.4f} ms; {wp[0]} boxes, {wp[1]} "
        f"primitives, bound {trace_bound(n, wp, False, QBOX_OPS, tables)}; from the "
        f"earlier walk's counts {PRIOR_K4_K8_WORK['k4_primary']}: "
        f"{trace_bound(n, PRIOR_K4_K8_WORK['k4_primary'], False, QBOX_OPS, tables)}")

    hit = stream.trace_closest_stream(ss, o, d)
    bo, bd, act, n_alive = _bounce_rays(scene, hit, o, d, 11, (None, ss.sortkey_bounds))
    e4, e5 = _stream_bar(ss, _strided(bo, n_alive, SUBSET), _strided(bd, n_alive, SUBSET),
                         "bounce (treelet-sorted, live lanes)")
    k4_err, k5_err = max(k4_err, e4), max(k5_err, e5)
    nb = 2 * n
    tmb = torch.where(act, torch.full((nb,), T_INF, device=dev), torch.zeros(nb, device=dev))
    tms = torch.where(act, torch.full((nb,), 1e29, device=dev), torch.zeros(nb, device=dev))
    k4_ms = cuda_ms(lambda: stream.trace_closest_stream_packed(ss, bo, bd, active=act), 10)
    k5_ms = cuda_ms(lambda: stream.shadow_occlusion_stream(ss, bo, bd, 1e29, active=act), 10)
    t0 = time.monotonic()
    k4_plain = cuda_ms(lambda: stream.trace_closest_plain(ss, bo, bd, tmb), 1)
    k5_plain = cuda_ms(lambda: stream.shadow_plain(ss, bo, bd, tms), 1)
    log(f"K4 bounce {nb} lanes ({n_alive} live): kernel {k4_ms:.4f} ms, plain "
        f"{k4_plain:.4f} ms")
    log(f"K5 bounce {nb} lanes ({n_alive} live): kernel {k5_ms:.4f} ms, plain "
        f"{k5_plain:.4f} ms (plain timings {time.monotonic() - t0:.1f} s)")
    k5_tables = (ss.anyhit_nodes, ss.tri_rows, ss.sph_rows, ss.inst_i, ss.inst_f)
    w4 = stream.count_work(ss, bo, bd, tmb, any_hit=False)
    w5 = stream.count_work(ss, bo, bd, tms, any_hit=True)
    steps, warp_max = stream.anyhit_warp_steps(ss, bo, bd, tms)
    log(f"K4 bounce work: {w4[0]} boxes, {w4[1]} primitives, bound "
        f"{trace_bound(nb, w4, False, QBOX_OPS, tables)}; from the earlier walk's "
        f"counts {PRIOR_K4_K8_WORK['k4_bounce']}: "
        f"{trace_bound(nb, PRIOR_K4_K8_WORK['k4_bounce'], False, QBOX_OPS, tables)}; "
        f"K5: {w5[0]} boxes, "
        f"{w5[1]} primitives; K5 SIMD efficiency (lanes' boxes + primitives over 32 x "
        f"each warp's slowest lane's): {steps} / (32 x {warp_max}) = "
        f"{steps / (32.0 * warp_max):.4f}")
    _k5_equals_k4(ss, o, d, None, "primary")
    _k5_equals_k4(ss, bo, bd, act, "bounce (treelet-sorted)")
    k4_tables = [ss.anyhit_nodes, ss.wide_perm, ss.tri_rows, ss.sph_rows, ss.inst_i,
                 ss.inst_f, ss.inst_i.shape[0]]
    case = dict(tables=k4_tables, o=bo, d=bd, tm=tmb)
    log(f"K4 with a stack cap of 1 on the terrain's bounce lanes: the child process "
        f"failed: {_overflow_fails('K4', OVERFLOW_CHILD, case, 'stream')}")
    results["stream_closest"] = dict(max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain,
                                     **trace_bound(nb, w4, False, QBOX_OPS, tables),
                                     library_ms=None)
    results["stream_shadow"] = dict(max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain,
                                    **trace_bound(nb, w5, True, QBOX_OPS, k5_tables),
                                    library_ms=None)
    return dict(bo=bo, bd=bd, act=act, n_alive=n_alive)


def phase_terrain_parity(dev):
    from ilgpu_raytracing_tpu_torch.models.terrain import (
        build_terrain_scene,
        terrain_camera,
    )
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream

    _, scene = build_terrain_scene(grid_x=64, grid_z=32, device="cpu")
    _parity(dev, "small terrain (StreamScene)", scene, stream.prepare_stream,
            terrain_camera)


def phase_terrain_main(dev, scene):
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.terrain import terrain_camera
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    t0 = time.monotonic()
    r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=8), scene,
                 terrain_camera(1920, 1080), device=dev)
    check(isinstance(r.wscene, stream.StreamScene), "terrain did not get a StreamScene")
    log(f"terrain Renderer ready in {time.monotonic() - t0:.3f} s (streaming prep)")
    depth = r.cfg.max_depth
    counts = _drive("terrain main path", r, TERRAIN_FRAMES,
                    _want(stream_closest=depth, stream_shadow=depth + 2, sortpos=2 * depth),
                    restir_per_frame=depth, sortkey_per_frame=dict(treelet=2 * depth),
                    shade_per_frame=depth, bounce_per_frame=depth)
    _sortkey_bar("terrain", r)
    _shade_bar("terrain", _shade_calls("terrain", r))
    _bounce_bar("terrain", r)
    return counts


def _courtyard(device):
    """The Sponza-like courtyard: its asset written into a temporary
    directory under the build directory and loaded back through the
    OBJ/MTL parser (median BVH, leaf 8)."""
    from ilgpu_raytracing_tpu_torch.models.sponza_like import build_sponza_like_scene
    from ilgpu_raytracing_tpu_torch.utils.build import BUILD_DIR

    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        _, scene = build_sponza_like_scene(d, device=device)
    check(scene.has_alpha and scene.n_tris == 94,
          f"courtyard: has_alpha {scene.has_alpha}, {scene.n_tris} triangles")
    log(f"courtyard on {device}: {scene.n_tris} tris, {scene.mat_kd.shape[0]} materials, "
        f"{scene.tex_offset.shape[0]} textures ({scene.texels.shape[0]} texels), "
        f"written, parsed and built in {time.monotonic() - t0:.3f} s")
    return scene


def phase_courtyard_k1_k2(dev, results):
    """K1/K2 vs the plain walk on the courtyard's 1280x720 primary rays. The
    kernels test no alpha mask: they are held to the walk of the opaque
    tables (WideScene.scene has has_alpha off), with barycentrics on. K1 is
    timed there with the bound from its boxes and primitives."""
    from ilgpu_raytracing_tpu_torch.models.sponza_like import sponza_camera
    from ilgpu_raytracing_tpu_torch.ops import rays
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide
    from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF

    scene = _courtyard(dev)
    ws = wide.prepare_scene(scene)
    check(ws.needs_bary and not ws.scene.has_alpha,
          f"courtyard WideScene: needs_bary {ws.needs_bary}, plain tables has_alpha "
          f"{ws.scene.has_alpha}")
    log(f"courtyard WideScene: {ws.wide_child.numel() // 8} wide nodes, wide depth "
        f"{ws.wide_depth}, needs_bary {ws.needs_bary}")
    o, d = rays.generate_primary_rays(sponza_camera(1280, 720), 1280, 720, dev)
    o = o.contiguous()
    k1_err, k2_err = _trace_bar(ws, o, d, "courtyard primary (opaque tables)")
    for name, err in (("wide_closest", k1_err), ("wide_shadow", k2_err)):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    n = o.shape[0]
    tm = torch.full((n,), T_INF, device=dev)
    ms = cuda_ms(lambda: wide.trace_closest_wide_packed(ws, o, d), 10)
    plain_ms = cuda_ms(lambda: wide.trace_closest_plain(ws, o, d, tm), 1)
    work = wide.count_work(ws, o, d, tm, any_hit=False)
    tables = (ws.nodes, ws.tri_rows, ws.sph_rows, ws.inst_i, ws.inst_f)
    log(f"K1 courtyard primary {n} lanes: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
        f"{work[0]} boxes, {work[1]} primitives, bound "
        f"{trace_bound(n, work, False, BOX_OPS, tables)}")
    return scene


def phase_courtyard_parity(dev):
    from ilgpu_raytracing_tpu_torch.models.sponza_like import sponza_camera
    from ilgpu_raytracing_tpu_torch.ops.cuda import stream, wide

    scene = _courtyard("cpu")
    _parity(dev, "courtyard (WideScene: peel around K1)", scene, wide.prepare_scene,
            sponza_camera)
    _parity(dev, "courtyard (StreamScene: peel around K4)", scene, stream.prepare_stream,
            sponza_camera)


def phase_courtyard_main(dev, scene):
    """The courtyard frame through Renderer: every trace peels around K1, K3
    sorts the bounce batches, path_trace runs in 2 chunks of trace lanes.
    Spies on the peel entries and on integrator._path_trace_block count the
    rounds of every trace and the chunks of the timed frames. Then the same
    tables with has_alpha off (the opaque control) and the alpha frame in
    one chunk, in turns with it."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.sponza_like import sponza_camera
    from ilgpu_raytracing_tpu_torch.ops import alpha, integrator
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    def renderer(sc, **knobs):
        r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=3, **knobs), sc,
                     sponza_camera(1920, 1080), device=dev)
        r.sun_azimuth, r.sun_elevation = 0.3, 0.6
        return r

    r = renderer(scene)
    check(isinstance(r.wscene, wide.WideScene), "the courtyard did not get a WideScene")
    rounds = {"closest": [], "shadow": []}
    chunks = []

    @contextlib.contextmanager
    def spies():
        real = (alpha.trace_closest_peel, alpha.shadow_occlusion_peel,
                integrator._path_trace_block)

        def spy(fn, key):
            def run(*a, **kw):
                out, i = fn(*a, with_iters=True, **kw)
                rounds[key].append(i)
                return out
            return run

        def block(*a):
            chunks.append(a[3].shape[0])
            return real[2](*a)

        alpha.trace_closest_peel = spy(real[0], "closest")
        alpha.shadow_occlusion_peel = spy(real[1], "shadow")
        integrator._path_trace_block = block
        try:
            yield
        finally:
            (alpha.trace_closest_peel, alpha.shadow_occlusion_peel,
             integrator._path_trace_block) = real

    f = COURTYARD_FRAMES
    counts = _drive("courtyard main path", r, f, _want(wide_closest=None, sortpos=12),
                    spies)
    n_rounds = sum(rounds["closest"]) + sum(rounds["shadow"])
    n_calls = len(rounds["closest"]) + len(rounds["shadow"])
    check(chunks == [r.in_w * r.in_h // 2] * (2 * f),
          f"courtyard path_trace chunks of the timed frames: {chunks}")
    check(counts["wide_closest"] == n_rounds,
          f"courtyard: {counts['wide_closest']} K1 launches, {n_rounds} peel rounds")
    for key, vals in rounds.items():
        log(f"courtyard {key} peels: {len(vals) / f:g} a frame, rounds per trace: "
            f"mean {np.mean(vals):.4f}, min {min(vals)}, max {max(vals)}, "
            f"{vals[:len(vals) // f]} in the first timed frame")
    log(f"courtyard: path_trace in {len(chunks) // f} chunks of {chunks[0]} pixels a "
        f"frame; peel rounds per trace {n_rounds / n_calls:.4f}; K1 launches per frame "
        f"{counts['wide_closest'] / f:g} (the peel rounds); host reads of pending.any() "
        f"per frame {(n_rounds + n_calls) / f:g}")

    # the opaque control, and the alpha frame unchunked (chunk_pixels=0): what
    # the peel costs, and what the 2 chunks cost
    arms = {"alpha": r, "opaque": renderer(dataclasses.replace(scene, has_alpha=False)),
            "alpha 1 chunk": renderer(scene, chunk_pixels=0)}
    for name in ("opaque", "alpha 1 chunk"):
        arms[name].render().cpu()  # warm-up
    torch.cuda.synchronize()
    ms = {k: [] for k in arms}
    for k in range(COURTYARD_PAIRS):
        for name in (arms if k % 2 == 0 else reversed(arms)):
            tf = time.monotonic()
            arms[name].render().cpu()
            torch.cuda.synchronize()
            ms[name].append((time.monotonic() - tf) * 1e3)
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"courtyard alpha vs opaque control in turns ({COURTYARD_PAIRS} frames each, ms): "
        + "; ".join(f"{k} {[round(x, 3) for x in v]}" for k, v in ms.items())
        + "; medians " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f"; ratio alpha / opaque {med['alpha'] / med['opaque']:.4f}, alpha 1 chunk / "
        f"opaque {med['alpha 1 chunk'] / med['opaque']:.4f}")
    return counts


def _settings_bar(label, want, got, deferred: bool):
    """The integrator-setting arm `got` against the default arm `want` after
    the same frame: colour within the JAX package's bar for the deferred
    queue (rtol 3e-5, atol 3e-6, tests/test_deferred_shadows.py) or
    bit-equal for the lane layout; eff and the reservoirs bit-equal (every
    field for the layout; w_sum, m, pdf, light_id for the queue, as JAX's
    test holds them); the packed frame bit-equal for the layout. Returns
    the max |colour difference|."""
    ca, cb = want._last_aux["color"], got._last_aux["color"]
    err = float((ca - cb).abs().max())
    if deferred:
        close = torch.isclose(cb, ca, rtol=3e-5, atol=3e-6)
        check(bool(close.all()), f"{label}: colour outside rtol 3e-5, atol 3e-6 on "
                                 f"{int((~close).sum())} values (max |diff| {err:.3e})")
        fields = ("w_sum", "m", "pdf", "light_id")
    else:
        check(bool(torch.equal(ca, cb)), f"{label}: colour differs (max |diff| {err:.3e})")
        check(bool(torch.equal(want._last_packed, got._last_packed)),
              f"{label}: packed frame differs")
        fields = tuple(vars(want.state.res_cur))
    check(float(want._last_aux["eff_rays"]) == float(got._last_aux["eff_rays"]),
          f"{label}: eff {float(got._last_aux['eff_rays'])} != "
          f"{float(want._last_aux['eff_rays'])}")
    for f in fields:
        check(bool(torch.equal(getattr(want.state.res_cur, f),
                               getattr(got.state.res_cur, f))),
              f"{label}: reservoir field {f} differs")
    return err


def phase_settings(dev, bench):
    """The two integrator settings on the 1080p bench frame, each against
    the default arm after the same frame, the three arms rendered in turns
    with one warm-up each: `deferred_shadows` (one frame-wide sorted
    any-hit dispatch) and `spp_pixel_major` (a pixel's samples on adjacent
    lanes). Launch counts are read around each arm's timed frames."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import cornell_camera
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    knobs = {"default": {}, "deferred_shadows": dict(deferred_shadows=True),
             "spp_pixel_major": dict(spp_pixel_major=True)}
    arms = {}
    for name, kw in knobs.items():
        r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=3, **kw), bench["scene"],
                     cornell_camera(1920, 1080), device=dev)
        r.sun_azimuth, r.sun_elevation = 0.3, 0.6
        arms[name] = r
    order = list(arms)
    ms = {k: [] for k in arms}
    counts = {k: _want() for k in arms}
    err = {"deferred_shadows": 0.0, "spp_pixel_major": 0.0}
    for k in range(1 + SETTINGS_FRAMES):
        for name in (order if k % 2 == 0 else order[::-1]):
            _reset_counts()
            tf = time.monotonic()
            arms[name].render().cpu()
            torch.cuda.synchronize()
            if k > 0:  # frame 0 is the arm's warm-up
                ms[name].append((time.monotonic() - tf) * 1e3)
                for c, v in _read_counts().items():
                    counts[name][c] += v
        for name in err:
            err[name] = max(err[name], _settings_bar(
                f"{name} frame {k}", arms["default"], arms[name],
                name == "deferred_shadows"))
    f = SETTINGS_FRAMES
    per_frame = {k: {c: v / f for c, v in cs.items() if v} for k, cs in counts.items()}
    want = {"default": _want(wide_closest=3, wide_shadow=5, sortpos=6),
            "deferred_shadows": _want(wide_closest=3, wide_shadow=2, sortpos=3),
            "spp_pixel_major": _want(wide_closest=3, wide_shadow=5, sortpos=6)}
    for name in arms:
        check(counts[name] == {c: v * f for c, v in want[name].items()},
              f"{name} launches per frame {per_frame[name]}")
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(f"settings on the 1080p bench frame, {1 + f} frames each, in turns: colour vs "
        f"the default arm max |diff| deferred_shadows {err['deferred_shadows']:.3e} "
        f"(bar rtol 3e-5, atol 3e-6), spp_pixel_major {err['spp_pixel_major']:.3e} "
        f"(bit-equal, packed frame too); eff and reservoirs bit-equal on every frame")
    log("settings launches per frame: " + "; ".join(
        f"{k} {v}" for k, v in per_frame.items()))
    log("settings frame ms in turns: " + "; ".join(
        f"{k} {[round(x, 3) for x in v]}" for k, v in ms.items())
        + "; medians " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f"; ratio deferred / default {med['deferred_shadows'] / med['default']:.4f}, "
        f"pixel-major / default {med['spp_pixel_major'] / med['default']:.4f}")
    _queue_k2(arms["default"], arms["deferred_shadows"])
    total = _want()
    for cs in counts.values():
        for c, v in cs.items():
            total[c] += v
    return total


def _queue_k2(default, deferred):
    """K2 at the deferred queue's shape: the arguments of every K2 call of
    one more frame of each arm, kept by a spy; the queue's one launch over
    (max_depth + 1) x 1,802,240 lanes timed beside the sum of the default
    frame's launches that it replaces (the sorted ReSTIR and sky batches),
    with the queue launch's boxes, primitives and bound. Not launches of
    the main path."""
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide

    real = wide.shadow_occlusion_wide
    calls = {"default": [], "deferred": []}
    try:
        for name, r in (("default", default), ("deferred", deferred)):
            wide.shadow_occlusion_wide = (
                lambda *a, _k=name, **kw: calls[_k].append((a, kw)) or real(*a, **kw))
            r.render().cpu()
    finally:
        wide.shadow_occlusion_wide = real
    torch.cuda.synchronize()
    biggest = max(calls["default"], key=lambda c: c[0][1].shape[0])[0][1].shape[0]
    replaced = [c for c in calls["default"] if c[0][1].shape[0] == biggest]
    (ws, o, d, t_max), kw = max(calls["deferred"], key=lambda c: c[0][1].shape[0])
    n = o.shape[0]
    check(n == len(replaced) * biggest, f"queue K2 launch of {n} lanes replaces "
          f"{len(replaced)} of {biggest}")
    ms_q = cuda_ms(lambda: real(ws, o, d, t_max, **kw), 5)
    ms_r = [cuda_ms(lambda a=a, k=k: real(*a, **k), 5) for a, k in replaced]
    act = kw["active"]
    tms = torch.where(act, torch.full((n,), float(t_max), device=o.device),
                      torch.zeros(n, device=o.device))
    work = wide.count_work(ws, o, d, tms, any_hit=True)
    tables = (ws.nodes, ws.tri_rows, ws.sph_rows, ws.inst_i, ws.inst_f)
    log(f"K2 at the deferred queue's launch: {n} lanes ({int(act.sum())} live) "
        f"{ms_q:.4f} ms, {work[0]} boxes, {work[1]} primitives, bound "
        f"{trace_bound(n, work, True, BOX_OPS, tables)}; the default frame's "
        f"{len(replaced)} launches of {biggest} lanes it replaces: "
        f"{', '.join(f'{x:.4f}' for x in ms_r)} ms, sum {sum(ms_r):.4f} ms")


def _orbit_camera(phase, w, h):
    from ilgpu_raytracing_tpu_torch.models.camera import Camera

    return Camera.look_at(
        (3.2 * np.sin(phase * 0.25), 0.2, 3.2 * np.cos(phase * 0.25)),
        (0, 0, 0), (0, 1, 0), 40.0, w / h)


def _bob(base, verts, n_sphere, phase):
    """examples/animate.py's motion: the sphere's vertices (the last
    `n_sphere` of the mesh) bob by 0.15 sin(phase)."""
    moved = base.copy()
    moved[-n_sphere:, 1] += np.float32(0.15 * np.sin(phase))
    return moved[verts]


def phase_config4(dev):
    """BASELINE config 4 at 1080p: examples/animate.py's loop on the bench
    Cornell scene (sphere_tess (48, 72): 49 x 72 sphere vertices bob), each
    frame refit_mesh_instance -> Renderer.set_scene -> set_camera (orbit)
    -> render with progressive accumulation, copied to the host. set_scene
    is timed by spies on the table rebuild from the last tables
    (wide.refit_tables) and on the full prep: the read-back and leaf
    packing (wide.prepare), the 8-wide collapse (wide.prepare_wide) and the
    upload (wide.wide_from_numpy); the renderer's `scene_tables` counter
    must show the one full prep of its construction and a refit a frame.
    Then the card's refit tables against a full prep of the same scene on
    the card, bit for bit, their K1 primary hits against the plain walk on
    the same tables and against K1 on a fresh build of the moved geometry,
    and a 64x64 refit frame pair, card vs CPU."""
    from ilgpu_raytracing_tpu_torch.config import RenderConfig
    from ilgpu_raytracing_tpu_torch.models.cornell import (
        build_cornell_scene,
        cornell_camera,
    )
    from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder, refit_mesh_instance
    from ilgpu_raytracing_tpu_torch.ops import rays
    from ilgpu_raytracing_tpu_torch.ops.cuda import wide
    from ilgpu_raytracing_tpu_torch.ops.route import SCENE_TABLES
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    builder, scene = build_cornell_scene(tess=24, sphere_tess=(48, 72), blas_leaf_size=8,
                                         bvh_method="sah", device=dev)
    inst = builder.instances[0]
    verts = slice(inst.vertex_first, inst.vertex_first + inst.vertex_count)
    base = builder.positions.copy()
    n_sphere = 49 * 72
    tables0 = dict(SCENE_TABLES)
    r = Renderer(1920, 1080, RenderConfig(spp=2, max_depth=3, progressive_accumulation=True),
                 scene, _orbit_camera(0.0, 1920, 1080), device=dev)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    spent = {"refit_tables": 0.0, "prepare": 0.0, "prepare_wide": 0.0,
             "wide_from_numpy": 0.0}

    @contextlib.contextmanager
    def prep_spies():
        real = {k: getattr(wide, k) for k in spent}

        def timed(name):
            def run(*a, **kw):
                t0 = time.monotonic()
                out = real[name](*a, **kw)
                torch.cuda.synchronize()
                spent[name] += time.monotonic() - t0
                return out
            return run

        for k in spent:
            setattr(wide, k, timed(k))
        try:
            yield
        finally:
            for k, fn in real.items():
                setattr(wide, k, fn)

    n_frames = 1 + CONFIG4_FRAMES
    rows = []
    with prep_spies():
        for f in range(n_frames):
            if f == 1:  # frame 0 is the warm-up
                _reset_counts()
            phase = 2.0 * np.pi * f / n_frames
            for k in spent:
                spent[k] = 0.0
            t0 = time.monotonic()
            new = refit_mesh_instance(builder, r.scene, 0, _bob(base, verts, n_sphere, phase))
            torch.cuda.synchronize()
            t1 = time.monotonic()
            r.set_scene(new)
            torch.cuda.synchronize()
            t2 = time.monotonic()
            r.set_camera(_orbit_camera(phase, 1920, 1080))
            packed = r.render().cpu()
            torch.cuda.synchronize()
            t3 = time.monotonic()
            rows.append(dict(refit=(t1 - t0) * 1e3, set_scene=(t2 - t1) * 1e3,
                             render=(t3 - t2) * 1e3,
                             **{k: v * 1e3 for k, v in spent.items()}))
    launches = _read_counts()
    timed_rows = rows[1:]
    per_frame = {k: v / CONFIG4_FRAMES for k, v in launches.items()}
    log(f"config 4 (1080p, {r.in_w}x{r.in_h} internal, per-frame refit of "
        f"{inst.prim_count} triangles / {inst.blas_node_count} BLAS nodes, progressive "
        f"accumulation, orbiting camera): {CONFIG4_FRAMES} timed frames after 1 warm-up")
    for i, row in enumerate(rows):
        log(f"config 4 frame {i}{' (warm-up)' if i == 0 else ''} ms: refit "
            f"{row['refit']:.3f}, set_scene {row['set_scene']:.3f} (refit_tables "
            f"{row['refit_tables']:.3f}; full prep: read-back + leaf packing "
            f"{row['prepare']:.3f}, 8-wide collapse "
            f"{row['prepare_wide'] - row['wide_from_numpy']:.3f}, upload "
            f"{row['wide_from_numpy']:.3f}), render + copy {row['render']:.3f}")
    tables = {k: v - tables0[k] for k, v in SCENE_TABLES.items()}
    log(f"config 4 scene_tables over construction + {n_frames} set_scene calls: {tables}")
    check(tables == {"prepared": 1, "refitted": n_frames},
          f"config 4 scene_tables {tables}: want 1 full prep, then a refit a frame")
    mean = {k: float(np.mean([row[k] for row in timed_rows])) for k in rows[0]}
    log(f"config 4 mean ms/frame over the timed frames: refit {mean['refit']:.3f}, "
        f"set_scene {mean['set_scene']:.3f}, render + copy {mean['render']:.3f}, total "
        f"{mean['refit'] + mean['set_scene'] + mean['render']:.3f}")
    t0 = time.monotonic()
    r.scene.blas_ifields.cpu(), r.scene.tri_prim_idx.cpu()
    log(f"config 4: the refit's read-back of blas_ifields + tri_prim_idx "
        f"({r.scene.blas_ifields.numel() * 4 + r.scene.tri_prim_idx.numel() * 4} B) "
        f"{(time.monotonic() - t0) * 1e3:.3f} ms")
    log(f"config 4 launches per frame: {per_frame}")
    check(per_frame == _want(wide_closest=3, wide_shadow=5, sortpos=6),
          f"config 4 launch counts {per_frame}")
    img = packed.numpy()
    check(bool(torch.isfinite(r._last_aux["color"]).all()), "config 4 colour has NaN/Inf")
    check(len(np.unique(img)) > 1 and img.shape == (1920 * 1080,),
          f"config 4 frame: shape {img.shape}, {len(np.unique(img))} colours")
    # the orbiting camera moves every frame, so every frame restarts the
    # accumulation, as in examples/animate.py
    check(r.state.accum_count == 1, f"config 4 accumulation count {r.state.accum_count}")

    # the card's refit tables against a full prep of the same scene, bit
    # for bit (tests/test_torch_refit_tables.py's bar on the CPU)
    full = wide.prepare_scene(r.scene)
    differ = [k for k in ("wide_bounds", "wide_child", "wide_perm", "nodes", "tri_rows",
                          "sph_rows", "tri_v0e", "inst_w2o", "inst_i", "inst_f")
              if not torch.equal(getattr(r.wscene, k).view(torch.int32),
                                 getattr(full, k).view(torch.int32))]
    differ += [k for k in ("meta", "stack_cap", "wide_depth", "leaf_width", "needs_bary")
               if getattr(r.wscene, k) != getattr(full, k)]
    check(not differ, f"config 4: the card's refit tables differ from a full prep in {differ}")
    log(f"config 4 refit tables on the card after {n_frames} refits equal a full prep "
        f"bit for bit ({full.wide_child.numel() // 8} wide nodes, {full.tri_rows.shape[0]} "
        f"leaf rows)")

    # the refit tables against the plain walk on them, and against a fresh
    # build of the moved geometry (tests/test_bvh.py's bar: hit masks equal,
    # t within 1e-5)
    in_w, in_h = r.in_w, r.in_h
    o, d = rays.generate_primary_rays(r.camera, in_w, in_h, dev)
    o = o.contiguous()
    k1_err, k2_err = _trace_bar(r.wscene, o, d, "config 4 primary (refit tables)")
    fresh_b = SceneBuilder(blas_leaf_size=8, bvh_method="sah")
    for m in builder.materials:
        fresh_b.add_material(m)
    fresh_b.add_mesh_instance(builder.positions[verts], builder.tri_indices, tri_mat=builder.tri_mat)
    fresh = wide.prepare_scene(fresh_b.commit(dev))
    t_r, pp_r = wide.trace_closest_wide_packed(r.wscene, o, d)
    t_f, pp_f = wide.trace_closest_wide_packed(fresh, o, d)
    hit_r, hit_f = pp_r >= 0, pp_f >= 0
    check(bool(torch.equal(hit_r, hit_f)),
          f"config 4: refit and fresh-build hit masks differ on {int((hit_r != hit_f).sum())} rays")
    both = hit_r & hit_f
    close = torch.isclose(t_r[both], t_f[both], rtol=1e-5, atol=1e-5)
    check(bool(close.all()), f"config 4: refit t off the fresh build's on {int((~close).sum())} rays")
    log(f"config 4 K1 on the refit tables vs K1 on a fresh SAH build of the moved geometry, "
        f"{o.shape[0]} primary rays: hit masks equal ({int(hit_r.sum())} hits), max |dt| "
        f"{float((t_r[both] - t_f[both]).abs().max()):.3e}, prim differs on "
        f"{int((pp_r != pp_f)[both].sum())}")

    # 64x64 refit frame pair, card vs CPU
    sb, small = build_cornell_scene(tess=4, sphere_tess=(8, 12), device="cpu")
    si = sb.instances[0]
    sv = slice(si.vertex_first, si.vertex_first + si.vertex_count)
    small = refit_mesh_instance(sb, small, 0, _bob(sb.positions.copy(), sv, 9 * 12, 1.3))
    _parity(dev, "Cornell refit", small, wide.prepare_scene, cornell_camera)
    return launches, (k1_err, k2_err)


def phase_session(dev):
    """The interactive session at 1080p on the default 6-sphere scene: a
    scripted input of W, mouse look, Shift+D, scroll, Space and one step fed
    through an EventPump, with a presenter that keeps frame_rgb() and the
    HUD text."""
    from ilgpu_raytracing_tpu_torch.runtime.controller import InputState
    from ilgpu_raytracing_tpu_torch.runtime.interactive import (
        EventPump,
        InteractiveSession,
        scripted_input,
    )
    from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

    r = Renderer(1920, 1080, device=dev)
    r.render().cpu()  # warm-up
    script = scripted_input([
        InputState(w=True), InputState(mouse_dx=40.0, mouse_dy=-10.0),
        InputState(d=True, shift=True), InputState(scroll_dy=2.0), InputState(up=True),
    ])
    pump = EventPump()

    def provider(frame):
        if frame < 5:
            return script(frame)
        if frame == 5:
            pump.key_down("a")
            pump.mouse_move(100, 100)
            pump.mouse_move(130, 90)
            return pump.poll()
        return None

    shown = []
    start = r.camera
    sess = InteractiveSession(r, provider,
                              presenter=lambda rgb, hud: shown.append((rgb.copy(), hud)))
    _reset_counts()
    t0 = time.monotonic()
    n = sess.run()
    dt = time.monotonic() - t0
    launches = _read_counts()
    check(n == 6 and len(shown) == 6, f"session ran {n} frames, presented {len(shown)}")
    check(not np.allclose(r.camera.origin, start.origin), "session camera did not move")
    check(not np.allclose(r.camera.forward, start.forward), "session camera did not turn")
    check(all(rgb.shape == (1080, 1920, 3) for rgb, _ in shown), "session frame shape")
    check(not np.array_equal(shown[0][0], shown[-1][0]), "session frames are all the same")
    check(sess.controller.fov_degrees == 56.0, f"session fov {sess.controller.fov_degrees}")
    per_frame = {k: v / n for k, v in launches.items()}
    check(per_frame == _want(wide_closest=3, wide_shadow=5, sortpos=6),
          f"session launch counts {per_frame}")
    log(f"interactive session 1080p ({r.in_w}x{r.in_h} internal, default 6-sphere scene): "
        f"{n} frames in {dt:.4f} s, ms/frame {dt / n * 1e3:.3f} (input, render, "
        f"frame_rgb copy, present); HUD '{shown[-1][1]}'; camera moved "
        f"{float(np.linalg.norm(r.camera.origin - start.origin)):.4f}, fov "
        f"{sess.controller.fov_degrees}; launches per frame {per_frame}")
    return launches


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "vs_baseline_effective", "detail"}
BENCH_DETAIL_KEYS = {"fps_1080p_presented", "mrays_effective", "window_s",
                     "rays_dispatched_per_frame", "rays_effective_per_frame",
                     "internal_res", "tris", "spp", "max_depth", "frames", "device"}


def phase_bench_torch(dev):
    """`bench_torch.run` at its full size (the 1080p bench frame, one
    warm-up and 3 windows of 6 frames, each frame copied to the host): its
    JSON line, its fields, and K1 3, K2 5, K3 6 launches a frame over every
    frame it renders."""
    import bench_torch

    torch.cuda.synchronize()
    _reset_counts()
    res = bench_torch.run(dev)
    torch.cuda.synchronize()
    launches = _read_counts()
    print(json.dumps(res), flush=True)
    det = res["detail"]
    frames = 1 + len(det["window_s"]) * det["frames"]  # the warm-up too
    check(set(res) == BENCH_KEYS and set(det) == BENCH_DETAIL_KEYS,
          f"bench_torch keys {sorted(res)} / {sorted(det)}")
    check(res["metric"] == "mrays_per_sec_1080p_cornell_path_trace"
          and res["unit"] == "Mrays/s/chip", f"bench_torch metric {res['metric']}")
    check(det["rays_dispatched_per_frame"] == 11_714_560 and det["internal_res"] == [1280, 704]
          and det["tris"] == 15_552 and len(det["window_s"]) == 3 and det["frames"] == 6,
          f"bench_torch detail {det}")
    check(det["device"] == smi_line(), f"bench_torch device {det['device']!r}")
    check(np.isfinite(res["value"]) and res["value"] > 0
          and 0 < det["rays_effective_per_frame"] <= det["rays_dispatched_per_frame"],
          f"bench_torch value {res['value']}, effective {det['rays_effective_per_frame']}")
    check(launches == _want(wide_closest=3 * frames, wide_shadow=5 * frames,
                            sortpos=6 * frames),
          f"bench_torch launch counts {launches} over {frames} frames")
    # the frame copy alone: bench_torch copies each packed 1080p frame (int64)
    # to pageable host memory, on the frame's stream
    packed = torch.zeros((1920 * 1080,), dtype=torch.int64, device=dev)
    copy_ms = cuda_ms(lambda: packed.cpu(), 10)
    log(f"bench_torch: {res['value']} Mrays/s dispatched, windows {det['window_s']} s, "
        f"launches per frame K1 3, K2 5, K3 6 over {frames} frames; the frame copy "
        f"({packed.numel() * 8} B to pageable memory) alone {copy_ms:.4f} ms, "
        f"{copy_ms / (min(det['window_s']) * 1e3 / det['frames']):.2%} of the "
        f"minimum window's frame")
    return launches


def _check_png(path: str, w: int, h: int) -> None:
    from PIL import Image  # the port's save_png writes through PIL

    img = np.asarray(Image.open(path).convert("RGB"))
    check(img.shape == (h, w, 3), f"{path}: shape {img.shape}, want {(h, w, 3)}")
    check(len(np.unique(img.reshape(-1, 3), axis=0)) > 1, f"{path} is blank")


def phase_examples(dev):
    """Each examples/torch_*.py `main` on the card at small sizes, its
    output captured and printed, the launches of each run counted from 0:
    PNGs exist, have the asked size and more than one colour;
    torch_large_mesh's 262,144-triangle terrain takes the StreamScene route
    and launches K4 and K5; torch_parity_check's line is within the noise
    floor; torch_fly without a display returns 1 with its message."""
    import io

    total = {}
    d = "--device", str(dev)
    with tempfile.TemporaryDirectory() as tmp:
        def png(name):
            return os.path.join(tmp, name)

        runs = [
            ("torch_render_default", [*d, "--width", "256", "--height", "256",
                                      "--frames", "2", "--out", png("default.png")]),
            *[("torch_render_cornell", [*d, "--width", "320", "--height", "240",
                                        "--frames", "2", "--bvh", bvh,
                                        "--out", png(f"cornell_{bvh}.png")])
              for bvh in ("sah", "median", "lbvh")],
            ("torch_animate", [*d, "--width", "160", "--height", "120", "--frames", "3",
                               "--outdir", png("anim")]),
            ("torch_large_mesh", [*d, "--width", "640", "--height", "360", "--frames", "2",
                                  "--grid-x", "512", "--grid-z", "256",
                                  "--out", png("terrain.png")]),
            ("torch_sponza_like", [*d, "--width", "320", "--height", "180", "--frames", "2",
                                   "--out", png("sponza.png")]),
            ("torch_parity_check", [*d, "--size", "128", "--seeds", "4"]),
            ("torch_fly", [*d]),
        ]
        for name, argv in runs:
            mod = _example(name)
            display = os.environ.pop("DISPLAY", None) if name == "torch_fly" else None
            buf = io.StringIO()
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.monotonic()
            try:
                with contextlib.redirect_stdout(buf):
                    rc = mod.main(argv)
            finally:
                if display is not None:
                    os.environ["DISPLAY"] = display
            torch.cuda.synchronize()
            secs = time.monotonic() - t0
            counts = _read_counts()
            out = buf.getvalue()
            for line in out.splitlines():
                log(f"  {name}: {line}")
            log(f"example {name} {' '.join(argv)}: rc {rc}, {secs:.2f} s, launches "
                f"{({k: v for k, v in counts.items() if v})}")
            if name == "torch_fly":
                check(rc == 1 and "no display available" in out,
                      f"torch_fly without a display: rc {rc}, {out!r}")
                check(not any(counts.values()), "torch_fly launched a kernel")
                continue
            check(rc == 0, f"{name} returned {rc}")
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            if name == "torch_parity_check":
                res = json.loads(out.strip().splitlines()[-1])
                check(res["within_noise_floor"], f"torch_parity_check: {res}")
                continue
            check(counts["sortpos"] > 0, f"{name}: K3 not launched")
            if name == "torch_large_mesh":
                check("tracer: StreamScene" in out and counts["stream_closest"] > 0
                      and counts["stream_shadow"] > 0 and counts["wide_closest"] == 0,
                      f"torch_large_mesh did not take the streaming route: {counts}")
            else:
                check(counts["wide_closest"] > 0, f"{name}: K1 not launched")
            w, h = int(argv[argv.index("--width") + 1]), int(argv[argv.index("--height") + 1])
            if name == "torch_animate":
                for f in range(int(argv[argv.index("--frames") + 1])):
                    _check_png(os.path.join(png("anim"), f"frame_{f:03d}.png"), w, h)
            else:
                _check_png(argv[argv.index("--out") + 1], w, h)
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    from ilgpu_raytracing_tpu_torch.ops import cuda as cu

    t_start = time.monotonic()
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    log(f"device: {kind}; nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    secs = cu.build_all()
    log(f"build: nvcc {' '.join(cu.NVCC_FLAGS)}: {secs:.2f} s")

    results: dict[str, dict] = {}

    def timed(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        log(f"phase {name}: {time.monotonic() - t0:.1f} s")
        return out

    timed("K3", phase_k3, dev, results)
    bench = timed("K1/K2", phase_k1_k2, dev, results)
    timed("other scenes", phase_other_scenes, dev)
    timed("Cornell parity", phase_parity, dev)
    cornell_counts = timed("Cornell main path", phase_main_path, dev, bench)
    timed("ReSTIR", phase_restir, dev, bench)
    timed("shade", phase_shade, dev, bench)
    timed("bounce", phase_bounce, dev, bench)
    bench_counts = timed("bench_torch", phase_bench_torch, dev)
    mesh_counts = timed("mesh", phase_mesh, dev, bench)
    timed("parity", phase_config1_parity, dev)
    timed("K6", phase_k6, dev, results, bench)
    timed("K6 parity", phase_k6_parity, dev)
    k6_counts = timed("K6 main path", phase_k6_main_path, dev, bench)
    k7_counts = timed("K7", phase_k7, dev, results, bench)
    settings_counts = timed("integrator settings", phase_settings, dev, bench)
    del bench
    config4_counts, c4_err = timed("config 4", phase_config4, dev)
    for name, err in zip(("wide_closest", "wide_shadow"), c4_err):
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
    session_counts = timed("interactive session", phase_session, dev)
    court = timed("courtyard K1/K2", phase_courtyard_k1_k2, dev, results)
    timed("courtyard parity", phase_courtyard_parity, dev)
    court_counts = timed("courtyard main path", phase_courtyard_main, dev, court)
    del court
    terrain, ss = timed("terrain prep", phase_terrain_prep, dev)
    lanes = timed("K4/K5", phase_k4_k5, dev, results, terrain, ss)
    k8_counts = timed("K8", phase_k8, dev, results, ss, lanes)
    del ss, lanes
    timed("terrain parity", phase_terrain_parity, dev)
    terrain_counts = timed("terrain main path", phase_terrain_main, dev, terrain)
    del terrain
    example_counts = timed("examples", phase_examples, dev)

    pallas = "ilgpu_raytracing_tpu/ops/pallas/"
    csrc = "ilgpu_raytracing_tpu_torch/csrc/"
    subsets = "65,536-ray subsets of the primary rays and sorted bounce lanes"
    meta = {
        "wide_closest": (csrc + "wide_trace.cu", pallas + "wide_kernel.py:952",
                         "hit masks equal to the plain walk, relative t mismatch above "
                         "1e-3 on < 0.5% of rays (bench, 6-sphere, transformed scenes, "
                         "the courtyard's opaque tables); the peel around it on the "
                         "64x64 courtyard frame at the golden bar against the plain "
                         "peel on the CPU"),
        "wide_shadow": (csrc + "wide_trace.cu", pallas + "wide_kernel.py:1073",
                        "occlusion equal to the plain walk on > 99.5% of rays at t_max "
                        "5 and 1e29 (bench, 6-sphere, transformed scenes, the "
                        "courtyard's opaque tables)"),
        "sortpos": (csrc + "sortpos.cu", pallas + "sortpos_kernel.py:135",
                    "positions equal to the plain counting sort on every lane at 129, "
                    "16, 258 bins and on the edge sets (one bin, descending, n = 1, "
                    "1,000, 1,802,241, bins 1 and 384); a key out of range fails; "
                    "12 launches a courtyard frame"),
        "stream_closest": (csrc + "stream_trace.cu", pallas + "stream_kernel.py:906",
                           f"hit masks equal, no |dt| > 1e-3, prim agreement > 99.5% "
                           f"on {subsets}"),
        "stream_shadow": (csrc + "stream_trace.cu", pallas + "stream_kernel.py:996",
                          f"occlusion equal to plain at t_max 5 and 1e29 on {subsets}, "
                          f"and to K4's hit mask on all 901,120 primary and 1,802,240 "
                          f"bounce lanes"),
        "binary_closest": (csrc + "binary_trace.cu", pallas + "traverse_kernel.py:487",
                           f"t, prim, inst, bu, bv equal to plain on every ray of "
                           f"{subsets}; 1080p frame within 2 levels of the K1/K2 "
                           f"frame on > 99% of pixels"),
        "binary_shadow": (csrc + "binary_trace.cu", pallas + "traverse_kernel.py:487",
                          f"occlusion equal to plain at t_max 5 and 1e29 on {subsets}"),
        "treelet": (csrc + "treelet_trace.cu", pallas + "treelet_kernel.py:595",
                    "one round's t, pp equal to plain on 65,536 lanes; rounds, single, "
                    "cleanup_after=1 t, pp equal to K1 on all 1,802,240 lanes"),
        "streamtreelet": (csrc + "streamtreelet_trace.cu",
                          pallas + "streamtreelet_kernel.py:360",
                          "one round's t, pp equal to plain on 65,536 lanes; rounds t, "
                          "pp equal to K4 on all 1,802,240 lanes"),
    }
    # launches: each kernel's count over the runs of the main paths (the
    # timed frames of the four Renderer paths, one call of each treelet
    # entry); K3 runs on all of them. Every bar was checked above, so a
    # kernel that reaches this line met it.
    paths = (cornell_counts, k6_counts, k7_counts, court_counts, terrain_counts,
             k8_counts, settings_counts, config4_counts, session_counts, mesh_counts,
             bench_counts, example_counts)
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=sum(c[name] for c in paths), bar=bar, result="met",
             **results[name])
        for name, (src, rep, bar) in meta.items()
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} was not launched on its main path")
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
