"""Wavefront path-trace integrator (port of ops/integrator.py).

`primary_visibility` fills the G-buffer with one batched trace + deferred
shading; `path_trace` vectorizes all spp samples into one lane batch and
runs an unrolled bounce loop in which every bounce issues ONE sorted
closest trace and ONE sorted shadow trace: ReSTIR DI at the first diffuse
vertex (candidates-only deeper), mirror / glass / lambert as masked lane
updates, Russian roulette from `rr_start_depth`, visibility-ray RR, the
once-per-frame bounce-0 sun occlusion trace, an any-hit sky test at the
final bounce, and a per-sample NaN scrub and fold.

With a kernel scene the traces go through its kernels -- the wide K1/K2
(ops/cuda/wide.py) for a WideScene, the streaming K4/K5
(ops/cuda/stream.py) for a StreamScene, the binary K6 (ops/cuda/binary.py)
for a BinaryScene -- and the counting sort K3 (ops/cuda/sortpos.py); each
runs its CUDA kernel on CUDA tensors and its plain version on CPU tensors.
Without one the traces go to the plain tracer of ops/traverse.py directly.
On a scene with alpha cutouts every trace peels around the kernel scene's
closest-hit kernel (ops/alpha.py); the plain tracer tests the masks in its
loop. Pixel batches above `chunk_pixels` run as equal chunks, trace lanes
(spp x pixels) counted on the plain-tracer and alpha paths. Under a device
mesh (runtime/renderer.render_frame_mesh) both entry points take one
device's contiguous pixel block (`pixels`). Two settings
reshape the dispatches without changing what is traced:
`spp_pixel_major` (a pixel's samples on adjacent lanes) and
`deferred_shadows` (every visibility ray of the frame in one sorted
any-hit dispatch after the bounce loop).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.materials import (
    SHADING_GLASS,
    SHADING_LAMBERT,
    SHADING_MIRROR,
)
from ilgpu_raytracing_tpu_torch.models.scene import SceneData
from ilgpu_raytracing_tpu_torch.ops import alpha as alpha_ops
from ilgpu_raytracing_tpu_torch.ops import layout
from ilgpu_raytracing_tpu_torch.ops import rays as rays_mod
from ilgpu_raytracing_tpu_torch.ops import restir as restir_mod
from ilgpu_raytracing_tpu_torch.ops import sky as sky_ops
from ilgpu_raytracing_tpu_torch.ops import sort as sort_mod
from ilgpu_raytracing_tpu_torch.ops import traverse
from ilgpu_raytracing_tpu_torch.ops.cuda import binary as binary_mod
from ilgpu_raytracing_tpu_torch.ops.cuda import stream as stream_mod
from ilgpu_raytracing_tpu_torch.ops.cuda import wide as wide_mod
from ilgpu_raytracing_tpu_torch.ops.sampling import sample_hemisphere_cosine
from ilgpu_raytracing_tpu_torch.utils import rng as rng_mod
from ilgpu_raytracing_tpu_torch.utils import vec


@dataclasses.dataclass
class GBuffer:
    """Primary-visibility surface attributes, flat (N,) SoA
    (reference GpuGBuffer, RTRay.cs:80-109)."""

    pos: torch.Tensor  # (N,3) world position (origin + 1e6*dir on miss)
    normal: torch.Tensor  # (N,3)
    albedo: torch.Tensor  # (N,3)
    shading: torch.Tensor  # (N,) i32 (-1 on miss)
    ior: torch.Tensor  # (N,)
    obj_id: torch.Tensor  # (N,) i32 disocclusion key
    hit: torch.Tensor  # (N,) bool

    def map(self, fn) -> "GBuffer":
        return GBuffer(**{k: fn(v) for k, v in vars(self).items()})


def _pick_n_chunks(n: int, target: int) -> int:
    """Smallest divisor count keeping chunks <= target (1 = no chunking)."""
    if target <= 0 or n <= target:
        return 1
    c = -(-n // target)
    while c <= 256:
        if n % c == 0:
            return c
        c += 1
    return 1


def _kernels(kscene):
    """(packed closest, decode, any-hit) wrappers of a kernel scene: the
    streaming kernels K4/K5 for a StreamScene, the wide K1/K2 otherwise."""
    if isinstance(kscene, stream_mod.StreamScene):
        return (stream_mod.trace_closest_stream_packed,
                stream_mod.decode_stream_hits, stream_mod.shadow_occlusion_stream)
    return (wide_mod.trace_closest_wide_packed, wide_mod.decode_wide_hits,
            wide_mod.shadow_occlusion_wide)


def _closest_record(kscene):
    """closest(o, d, active) -> HitRecord: the kernel scene's closest-hit
    kernel, K6 for a BinaryScene, K1/K4 (packed record decoded) otherwise."""
    if isinstance(kscene, binary_mod.BinaryScene):
        return lambda oo, dd, act: binary_mod.trace_closest_binary(
            kscene, oo, dd, active=act)
    packed, decode, _ = _kernels(kscene)

    def closest(oo, dd, act):
        t, pp = packed(kscene, oo, dd, active=act)
        return decode(kscene, oo, dd, t, pp)

    return closest


def _trace(scene, kscene, o, d, active=None, sort=False, morton_bounds=None,
           treelet_bounds=None):
    """Closest-hit dispatch: the kernel scene's closest-hit kernel (sorted
    around K3 for bounce batches) when one is given, the plain tracer
    otherwise. K6 and the alpha peel return a whole HitRecord, which the
    sort restores field by field (ops/sort.sorted_closest); opaque K1/K4
    return the packed record, restored as two fields and decoded in the
    caller's lane order."""
    if kscene is None:
        return traverse.trace_closest(scene, o, d, active=active)
    if scene.has_alpha or isinstance(kscene, binary_mod.BinaryScene):
        closest = _closest_record(kscene)
        if scene.has_alpha:
            closest = functools.partial(alpha_ops.trace_closest_peel, closest, scene)
        if sort and active is not None:
            return sort_mod.sorted_closest(closest, o, d, active, morton_bounds,
                                           treelet_bounds)
        return closest(o, d, active)
    packed, decode, _ = _kernels(kscene)
    if sort and active is not None:
        return sort_mod.sorted_closest_packed(
            lambda oo, dd, act: packed(kscene, oo, dd, active=act),
            lambda t, pp: decode(kscene, o, d, t, pp),
            o, d, active, morton_bounds, treelet_bounds,
        )
    t, pp = packed(kscene, o, d, active=active)
    return decode(kscene, o, d, t, pp)


def _shadow(scene, kscene, o, d, t_max: float, active=None, sort=False,
            morton_bounds=None, treelet_bounds=None):
    """Any-hit dispatch (K2, K5 or K6, sorted around K3 for bounce batches;
    on an alpha scene the any-hit band peeled around the closest-hit
    kernel). The sorted path needs a scalar t_max (a per-lane limit would
    have to ride the permutation)."""
    if kscene is None:
        return traverse.shadow_occlusion(scene, o, d, t_max, active=active)
    if scene.has_alpha:
        closest = _closest_record(kscene)

        def run(oo, dd, act):
            return alpha_ops.shadow_occlusion_peel(closest, scene, oo, dd, t_max, act)
    else:
        if isinstance(kscene, binary_mod.BinaryScene):
            any_hit = binary_mod.shadow_occlusion_binary
        else:
            _, _, any_hit = _kernels(kscene)

        def run(oo, dd, act):
            return any_hit(kscene, oo, dd, t_max, active=act)

    if sort and active is not None:
        if not isinstance(t_max, (int, float)):
            raise ValueError("sorted shadow path requires a scalar t_max")
        return sort_mod.sorted_shadow(run, o, d, active, morton_bounds,
                                      treelet_bounds)
    return run(o, d, active)


def primary_visibility(scene: SceneData, camera, width: int, height: int,
                       chunk_pixels: int = 0, wscene=None,
                       pixels: slice | None = None) -> GBuffer:
    """Primary trace + deferred shading, in equal chunks of at most
    `chunk_pixels` pixels (one batch when 0). With `pixels` (a slice of
    positions: one device's block of a mesh) only those pixels."""
    u, v = rays_mod.pixel_centers(width, height, scene.device)
    if pixels is not None:
        u, v = u[pixels], v[pixels]
    c = _pick_n_chunks(u.shape[0], chunk_pixels)
    parts = []
    for uc, vc in zip(u.chunk(c), v.chunk(c)):
        o, d = rays_mod.generate_rays(camera, uc, vc)
        o = o.contiguous()
        hit = _trace(scene, wscene, o, d)
        surf = traverse.shade_hits(scene, hit, o, d)
        parts.append(GBuffer(
            pos=surf.pos, normal=surf.normal, albedo=surf.albedo,
            shading=surf.shading, ior=surf.ior, obj_id=surf.obj_id, hit=hit.hit,
        ))
    if c == 1:
        return parts[0]
    return GBuffer(**{k: torch.cat([getattr(p, k) for p in parts])
                      for k in vars(parts[0])})


def _offset_origin(pos, n, d, eps):
    """Normal-offset ray origin (MakeRayWithNormalOffset, RTRay.cs:552-558)."""
    s = torch.where(vec.dot(n, d) >= 0.0, 1.0, -1.0)
    return pos + n * (eps * s)[..., None]


def _merge_reservoirs(dst, src, mask):
    return restir_mod.Reservoirs(**{
        k: restir_mod.where_rows(mask, getattr(src, k), getattr(dst, k))
        for k in vars(dst)
    })


def _path_trace_block(scene: SceneData, gb_full: GBuffer, gb: GBuffer,
                      pixel_idx, camera, prev_camera, res_prev, res_cur_init,
                      frame, noise_key, sun_dir, cfg: RenderConfig,
                      width: int, height: int, wscene=None):
    """Path-trace the pixels `pixel_idx` with all spp samples vectorized
    into one (spp*m,) lane batch: lane s*m + i carries sample s of pixel i
    (sample-major), or lane i*spp + s with `cfg.spp_pixel_major`, a pure
    lane permutation (the same RNG stream, trace result and fold order for
    every (pixel, sample), so the frame is bit-identical). Later samples
    overwrite earlier reservoir winners, as the reference's sequential
    ping-pong merge does.

    With `cfg.deferred_shadows` on a kernel scene without alpha (`wscene`
    given and `scene.has_alpha` off), every bounce's ReSTIR visibility ray
    and the final bounce's sky-visibility ray are queued and traced as one
    frame-wide sorted any-hit dispatch after the bounce loop; the radiance
    then sums in queue order, equal to the inline frame up to float
    summation order. The JAX package applies the queue only with a Pallas
    scene (`pscene`), which it has on the TPU and not on the CPU; the
    port's CPU Renderer carries the plain-version kernel scene, so on the
    CPU the port applies the queue where JAX on the CPU would not: the
    counterpart of JAX with a `pscene`. The sun-dedup trace stays outside
    the queue."""
    dev = scene.device
    m = pixel_idx.shape[0]
    spp = max(1, cfg.spp)
    n = spp * m
    cam_origin = torch.as_tensor(camera.origin, dtype=torch.float32, device=dev)
    sky_top, sky_bottom = cfg.sky_tint_top, cfg.sky_tint_bottom
    sun_radiance = cfg.sun_radiance

    # scene-bounds quantization for the origin-Morton sort key
    morton_bounds = None
    if cfg.sort_bounce_rays and cfg.sort_origin_morton:
        bmin = torch.amin(scene.inst_bmin, dim=0)
        bmax = torch.amax(scene.inst_bmax, dim=0)
        morton_bounds = (bmin, 1.0 / torch.clamp(bmax - bmin, min=1e-6))
    # streaming scenes: destination-treelet key instead of origin Morton
    treelet_bounds = None
    if (cfg.sort_bounce_rays and cfg.sort_stream_treelet_key
            and isinstance(wscene, stream_mod.StreamScene)):
        treelet_bounds = wscene.sortkey_bounds

    # lane layout (config.spp_pixel_major): sample-major stacks whole
    # sample tiles; pixel-major keeps a pixel's spp lanes adjacent
    pixel_major = cfg.spp_pixel_major and spp > 1

    def tile(x):
        if pixel_major:
            return x.repeat_interleave(spp, dim=0)
        return x.repeat((spp,) + (1,) * (x.dim() - 1))

    # deferred shadow queue (config.deferred_shadows): visibility rays never
    # drive path continuation or reservoir writes, so they can all be traced
    # in one sorted dispatch after the bounce loop
    defer_shadows = (cfg.deferred_shadows and wscene is not None
                     and not scene.has_alpha)
    shadow_queue: list[dict] | None = [] if defer_shadows else None

    px, py = layout.xy_from_position(pixel_idx, width, height)
    pu = (px.to(torch.float32) + 0.5) / float(max(1, width))
    pv = (py.to(torch.float32) + 0.5) / float(max(1, height))
    _, primary_d = rays_mod.generate_rays(camera, pu, pv)
    miss_sky = tile(sky_ops.sky_radiance(primary_d, sky_top, sky_bottom))

    gb_px = gb
    gb = gb.map(tile)
    pixel_idx = tile(pixel_idx)
    view_i = vec.normalize(gb.pos - cam_origin)  # ViewDirFromCam (RTRay.cs:156)
    lum_w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=torch.float32, device=dev)

    def glass_ior(ior):
        # ior <= 0 falls back to 1.5 (RTRay.cs:251-252)
        return torch.where(ior > 0.0, ior, torch.full_like(ior, 1.5))

    def vis_rr(state, contrib_rgb, act, salt):
        """(traced_mask, scale): visibility-ray RR survivors trace and
        scale their contribution by 1/p; scale is None when off."""
        if cfg.shadow_rr_lum <= 0.0:
            return act, None
        # the terms in a fixed order (vec.dot): a matmul's reduction can
        # depend on the batch size, and a mesh block is a smaller batch
        c = torch.clamp(vec.dot(contrib_rgb, lum_w), min=0.0)
        p = torch.clamp(c * (1.0 / cfg.shadow_rr_lum), cfg.shadow_rr_pmin, 1.0)
        u = rng_mod.side_float(state, salt)
        return act & (u < p), torch.where(u < p, 1.0 / p, torch.zeros_like(p))

    zeros3 = lambda x: torch.zeros_like(x)

    def bounce_step(carry, depth: int, allow_reuse: bool, sun_occ0=None,
                    sun_dir_n=None, final: bool = False):
        (pos, nrm, alb, shade, ior, thr, li, alive, view, state, wrote,
         res_cur, eff) = carry

        is_mirror = alive & (shade == SHADING_MIRROR)
        is_glass = alive & (shade == SHADING_GLASS)
        is_lambert = alive & (shade == SHADING_LAMBERT)

        # ---- mirror (RTRay.cs:235-244) ----
        dir_mirror = vec.reflect(view, nrm)

        # ---- glass (RTRay.cs:246-275) ----
        outside = vec.dot(view, nrm) < 0.0
        n_use = torch.where(outside[..., None], nrm, -nrm)
        one = torch.ones_like(ior)
        eta_i = torch.where(outside, one, glass_ior(ior))
        eta_t = torch.where(outside, glass_ior(ior), one)
        dir_refl = vec.reflect(view, n_use)
        refr_ok, dir_refr = vec.refract(view, n_use, eta_i, eta_t)
        cos_i = torch.abs(vec.dot(view, n_use))
        fresnel = vec.schlick_fresnel(cos_i, eta_i, eta_t)
        state, xi = rng_mod.next_float(state)
        choose_refl = (~refr_ok) | (xi < fresnel)
        dir_glass = torch.where(choose_refl[..., None], dir_refl, dir_refr)
        offn_glass = torch.where(choose_refl[..., None], n_use, -n_use)
        alb_black = torch.all(alb == 0.0, dim=-1)
        trans_tint = torch.where(alb_black[..., None], torch.ones_like(alb), alb)
        eta_scale = (eta_i * eta_i) / (eta_t * eta_t)
        thr_glass_mult = torch.where(
            choose_refl[..., None], torch.ones_like(alb),
            trans_tint * eta_scale[..., None],
        )

        # ---- lambert: ReSTIR DI (RTRay.cs:277-298); reuse only at the
        # first diffuse vertex of the peeled first bounce ----
        reuse_ok = is_lambert & (~wrote)
        no = torch.zeros_like(reuse_ok)
        en_t = reuse_ok if (cfg.enable_temporal_reuse and allow_reuse) else no
        en_s = reuse_ok if (cfg.enable_spatial_reuse and allow_reuse) else no
        static_reuse = allow_reuse and (
            cfg.enable_temporal_reuse or cfg.enable_spatial_reuse
        )
        state, res_out, sel = restir_mod.restir_direct(
            scene, gb_full, res_prev, state, is_lambert, pos, nrm, alb,
            pixel_idx, width, height, frame, prev_camera, cam_origin,
            sun_dir, sun_radiance, sky_top, sky_bottom, en_t, en_s,
            cfg.local_candidates, cfg.delta_candidates,
            static_reuse=static_reuse,
            reference_weighting=cfg.restir_reference_weighting,
            reps=spp, reps_pixel_major=pixel_major,
        )
        shadow_o = _offset_origin(pos, nrm, sel["wi"], cfg.eps_n)
        contrib_w = torch.where(
            (is_lambert & sel["ok"])[..., None], thr * sel["contrib"],
            zeros3(thr),
        )
        if sun_occ0 is not None:
            # bounce 0: the sun's occlusion from the G-buffer point was
            # traced once per frame; substitute it only where the stored wi
            # is exactly this frame's sun (imports can carry a stale one)
            exact = torch.all(sel["wi"] == sun_dir_n[None, :], dim=-1)
            sun_sel = sel["is_sun"] & sel["ok"] & exact
            li = li + torch.where(
                (sun_sel & (~sun_occ0))[..., None], contrib_w, zeros3(contrib_w)
            )
            q_act = sel["ok"] & (~sun_sel)
        else:
            q_act = sel["ok"]
        q_act, q_scale = vis_rr(state, contrib_w, q_act, 0x53484457)
        if q_scale is not None:
            contrib_w = contrib_w * q_scale[..., None]
        if shadow_queue is not None:
            shadow_queue.append(dict(o=shadow_o, d=sel["wi"], contrib=contrib_w,
                                     act=q_act))
        else:
            occluded = _shadow(
                scene, wscene, shadow_o, sel["wi"], 1e29, active=q_act,
                sort=cfg.sort_bounce_rays, morton_bounds=morton_bounds,
                treelet_bounds=treelet_bounds,
            )
            li = li + torch.where(
                (q_act & (~occluded))[..., None], contrib_w, zeros3(contrib_w)
            )
        # queued or traced, each lane counts once, here
        eff = eff + torch.sum(q_act.to(torch.float32))
        write_mask = is_lambert & (~wrote)
        res_cur = _merge_reservoirs(res_cur, res_out, write_mask)
        wrote = wrote | is_lambert

        # indirect lambert bounce + Russian roulette (RTRay.cs:300-317)
        state, dir_diffuse = sample_hemisphere_cosine(nrm, state)
        thr_lambert = thr * alb
        max_c = torch.clamp(
            torch.amax(thr_lambert, dim=-1), cfg.rr_clamp_lo, cfg.rr_clamp_hi
        )
        state, u_rr = rng_mod.next_float(state)
        rr_on = is_lambert & (depth >= cfg.rr_start_depth)
        rr_kill = rr_on & (u_rr > max_c)
        rr_scale = torch.where(rr_on & (~rr_kill), 1.0 / max_c, torch.ones_like(max_c))

        # ---- combine branches ----
        new_dir = torch.where(
            is_mirror[..., None], dir_mirror,
            torch.where(is_glass[..., None], dir_glass, dir_diffuse),
        )
        offn = torch.where(is_glass[..., None], offn_glass, nrm)
        thr = torch.where(
            is_mirror[..., None], thr * alb,
            torch.where(
                is_glass[..., None], thr * thr_glass_mult,
                torch.where(is_lambert[..., None],
                            thr_lambert * rr_scale[..., None], thr),
            ),
        )
        thr = torch.where(rr_kill[..., None], zeros3(thr), thr)

        trace_active = alive & (~rr_kill)
        eff = eff + torch.sum(trace_active.to(torch.float32))
        ray_o = _offset_origin(pos, offn, new_dir, cfg.eps_n)
        if final and not scene.has_alpha:
            # the final scatter ray only feeds a sky-visibility test: run
            # the early-exit any-hit walk and skip hit shading. Alpha
            # scenes keep the closest path: the any-hit band of their
            # shadow peel is deliberately not the closest-hit cutout
            # (SceneDeviceViews.cs:297-315)
            sky_w = torch.where(
                trace_active[..., None],
                thr * sky_ops.sky_radiance(new_dir, sky_top, sky_bottom),
                zeros3(thr),
            )
            sky_act, sky_scale = vis_rr(state, sky_w, trace_active, 0x534B5952)
            if sky_scale is not None:
                sky_w = sky_w * sky_scale[..., None]
                eff = eff - torch.sum((trace_active & (~sky_act)).to(torch.float32))
            if shadow_queue is not None:
                # sky radiance lands where the queued trace reports not
                # occluded; `alive` is unused after the last bounce
                shadow_queue.append(dict(o=ray_o, d=new_dir, contrib=sky_w,
                                         act=sky_act))
                alive = torch.zeros_like(trace_active)
            else:
                occluded = _shadow(
                    scene, wscene, ray_o, new_dir, 1e29, active=sky_act,
                    sort=cfg.sort_bounce_rays, morton_bounds=morton_bounds,
                    treelet_bounds=treelet_bounds,
                )
                missed = sky_act & (~occluded)
                li = li + torch.where(missed[..., None], sky_w, zeros3(sky_w))
                alive = sky_act & occluded
        else:
            hit = _trace(
                scene, wscene, ray_o, new_dir, active=trace_active,
                sort=cfg.sort_bounce_rays, morton_bounds=morton_bounds,
                treelet_bounds=treelet_bounds,
            )
            surf = traverse.shade_hits(scene, hit, ray_o, new_dir)
            missed = trace_active & (~hit.hit)
            li = li + torch.where(
                missed[..., None],
                thr * sky_ops.sky_radiance(new_dir, sky_top, sky_bottom),
                zeros3(thr),
            )
            alive = trace_active & hit.hit
            keep = alive[..., None]
            pos = torch.where(keep, surf.pos, pos)
            nrm = torch.where(keep, surf.normal, nrm)
            alb = torch.where(keep, surf.albedo, alb)
            shade = torch.where(alive, surf.shading, shade)
            ior = torch.where(alive, surf.ior, ior)
            view = torch.where(keep, new_dir, view)

        return (pos, nrm, alb, shade, ior, thr, li, alive, view, state, wrote,
                res_cur, eff)

    # noise streams stay keyed to the CANONICAL pixel id (y*width+x)
    canonical_idx = py * width + px

    # bounce-0 sun occlusion is sample-invariant: one coherent trace per
    # frame from the lambert G-buffer points, shared by all samples
    sun_dir_n = vec.normalize(torch.as_tensor(sun_dir, dtype=torch.float32, device=dev))
    if cfg.dedup_sun_shadow:
        wi_sun0 = torch.broadcast_to(sun_dir_n, gb_px.pos.shape)
        lam0 = gb_px.hit & (gb_px.shading == SHADING_LAMBERT)
        sun_o0 = _offset_origin(gb_px.pos, vec.normalize(gb_px.normal),
                                wi_sun0, cfg.eps_n)
        sun_occ0 = tile(_shadow(scene, wscene, sun_o0, wi_sun0.contiguous(),
                                1e29, active=lam0))
        eff0 = torch.sum(lam0.to(torch.float32))
    else:
        sun_occ0 = None
        eff0 = torch.zeros((), dtype=torch.float32, device=dev)

    # the lane carrying (pixel i, sample s) gets the same stream under
    # either layout
    sample_ids = torch.arange(spp, dtype=torch.int64, device=dev)
    sample_ids = sample_ids.repeat(m) if pixel_major else sample_ids.repeat_interleave(m)
    state = rng_mod.seed_from_index(
        tile(canonical_idx), width, frame, sample_ids, cfg.rng_salt, noise_key
    )
    li0 = torch.where(gb.hit[..., None], torch.zeros_like(miss_sky), miss_sky)
    carry = (
        gb.pos, vec.normalize(gb.normal), gb.albedo, gb.shading, gb.ior,
        torch.ones((n, 3), dtype=torch.float32, device=dev), li0, gb.hit,
        view_i, state, torch.zeros((n,), dtype=torch.bool, device=dev),
        res_cur_init.map(tile), eff0,
    )
    n_bounce = max(1, cfg.max_depth)
    for depth in range(n_bounce):
        carry = bounce_step(
            carry, depth, allow_reuse=(depth == 0),
            sun_occ0=sun_occ0 if depth == 0 else None,
            sun_dir_n=sun_dir_n if depth == 0 else None,
            final=(depth == n_bounce - 1),
        )
    li, wrote, res_vec, eff = carry[6], carry[10], carry[11], carry[12]

    if shadow_queue:
        # one frame-wide sorted any-hit dispatch over every queued segment
        # (max_depth ReSTIR batches and the final sky batch), then each
        # segment's radiance in queue order
        n_seg = len(shadow_queue)
        q_act = torch.cat([q["act"] for q in shadow_queue])
        occ = _shadow(
            scene, wscene, torch.cat([q["o"] for q in shadow_queue]),
            torch.cat([q["d"] for q in shadow_queue]), 1e29,
            active=q_act, sort=cfg.sort_bounce_rays, morton_bounds=morton_bounds,
            treelet_bounds=treelet_bounds,
        )
        vis = (q_act & (~occ)).reshape(n_seg, n)
        for b, q in enumerate(shadow_queue):
            li = li + torch.where(vis[b][..., None], q["contrib"], zeros3(q["contrib"]))

    # fold per pixel in sample order: scrubbed radiance sum; reservoirs keep
    # the LAST sample that wrote (the same numbers in the same order under
    # either lane layout)
    def sample_slice(x, s):
        if pixel_major:
            return x.reshape(m, spp, *x.shape[1:])[:, s]
        return x.reshape(spp, m, *x.shape[1:])[s]

    l_sum = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        l_sum = l_sum + vec.safe_color(sample_slice(li, s), cfg.safe_color_max)
    color = l_sum * (1.0 / float(spp))
    res_cur = res_cur_init
    for s in range(spp):
        res_cur = _merge_reservoirs(
            res_cur, res_vec.map(lambda x: sample_slice(x, s)),
            sample_slice(wrote, s),
        )
    depth_out = vec.length(gb_px.pos - cam_origin)
    return color, depth_out, gb_px.obj_id, res_cur, eff


def path_trace(scene: SceneData, gb: GBuffer, camera, prev_camera, res_prev,
               res_cur_init, frame, noise_key, sun_dir, cfg: RenderConfig,
               width: int, height: int, wscene=None, pixels: slice | None = None):
    """Shade the G-buffer with spp samples of multi-bounce transport.

    Returns (color (N,3) linear, depth (N,), obj_id (N,), res_cur,
    eff_rays), eff_rays being the count of alive trace lanes dispatched
    (primary rays excluded). `frame` and `noise_key` are host integers.

    Pixel batches above the chunk target run as equal chunks, one after
    the other. Each chunk's ReSTIR reuse still gathers from the full-image
    G-buffer and `res_prev`, so the chunked frame equals the unchunked one
    bit for bit. With `pixels` (a slice of positions: one device's block of
    a mesh) only those pixels are traced, chunked by the same rule: `gb`
    and `res_prev` stay full-image, `res_cur_init` and the outputs cover
    the slice, and every lane keeps its global pixel index (its noise
    stream), so the blocks together equal the whole frame bit for bit."""
    start, stop = (0, width * height) if pixels is None else (pixels.start, pixels.stop)
    n = stop - start
    target = cfg.chunk_pixels
    if target and (wscene is None or scene.has_alpha):
        # the plain tracer and the alpha peel chunk by trace lanes, as the
        # JAX package does (its while loops over spp*m lanes)
        target = max(1, target // max(1, cfg.spp))
    c = _pick_n_chunks(n, target)
    m = n // c
    pixel_idx = torch.arange(start, stop, dtype=torch.int32, device=scene.device)
    outs = []
    for k in range(c):
        rows = slice(k * m, (k + 1) * m)
        glob = slice(start + k * m, start + (k + 1) * m)
        outs.append(_path_trace_block(
            scene, gb, gb.map(lambda x: x[glob]), pixel_idx[rows], camera,
            prev_camera, res_prev, res_cur_init.map(lambda x: x[rows]), frame,
            noise_key, sun_dir, cfg, width, height, wscene,
        ))
    if c == 1:
        return outs[0]
    color, depth, obj_id, res, eff = zip(*outs)
    res_cur = restir_mod.Reservoirs(**{
        k: torch.cat([getattr(r, k) for r in res]) for k in vars(res[0])})
    return (torch.cat(color), torch.cat(depth), torch.cat(obj_id), res_cur,
            torch.stack(eff).sum())
