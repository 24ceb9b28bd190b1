"""Wavefront path-trace integrator (port of ops/integrator.py).

`primary_visibility` fills the G-buffer with one batched trace + deferred
shading; `path_trace` vectorizes all spp samples into one lane batch and
runs an unrolled bounce loop in which every bounce issues ONE sorted
closest trace and ONE sorted shadow trace: ReSTIR DI at the first diffuse
vertex (candidates-only deeper), mirror / glass / lambert as masked lane
updates, Russian roulette from `rr_start_depth`, visibility-ray RR, the
once-per-frame bounce-0 sun occlusion trace, an any-hit sky test at the
final bounce, and a per-sample NaN scrub and fold. A bounce's lane updates
are two steps around its traces, `scatter` (after ReSTIR) and `resolve`
(after the traces and hit shading): on CUDA tensors one launch each of
csrc/bounce.cu, elsewhere their PyTorch bodies.

Every trace goes through ops/route.py, which chooses the kernel from the
kernel scene (`wscene`; None for the plain tracer of ops/traverse.py) and
sorts bounce batches around the counting sort K3. Pixel batches above
`chunk_pixels` run as equal chunks, trace lanes (spp x pixels) counted on
the plain-tracer and alpha paths. Under a device mesh
(runtime/renderer.render_frame_mesh) both entry points take one device's
contiguous pixel block (`pixels`) and that device's replica of the kernel
scene. Two settings reshape the dispatches without changing what is
traced: `spp_pixel_major` (a pixel's samples on adjacent lanes) and
`deferred_shadows` (every visibility ray of the frame in one sorted
any-hit dispatch after the bounce loop).
"""

from __future__ import annotations

import dataclasses

import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.materials import (
    SHADING_GLASS,
    SHADING_LAMBERT,
    SHADING_MIRROR,
)
from ilgpu_raytracing_tpu_torch.models.scene import SceneData
from ilgpu_raytracing_tpu_torch.ops import layout
from ilgpu_raytracing_tpu_torch.ops import rays as rays_mod
from ilgpu_raytracing_tpu_torch.ops import restir as restir_mod
from ilgpu_raytracing_tpu_torch.ops import route
from ilgpu_raytracing_tpu_torch.ops import sky as sky_ops
from ilgpu_raytracing_tpu_torch.ops import traverse
from ilgpu_raytracing_tpu_torch.ops.cuda import bounce as bounce_kernel
from ilgpu_raytracing_tpu_torch.ops.sampling import sample_hemisphere_cosine
from ilgpu_raytracing_tpu_torch.utils import rng as rng_mod
from ilgpu_raytracing_tpu_torch.utils import telemetry, vec


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


@telemetry.spanned("primary")
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
        hit = route.closest(scene, wscene, o, d)
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


# side-stream salts of the two visibility-ray roulettes
SALT_SHADOW_RR = 0x53484457
SALT_SKY_RR = 0x534B5952


@dataclasses.dataclass
class PathLanes:
    """A bounce's per-lane carry, flat (n,) SoA. `state` is the RNG state
    the bounce's ReSTIR call takes: the bounce's glass draw has advanced it
    already (`resolve` draws it for the next bounce, the seeding for the
    first)."""

    pos: torch.Tensor  # (n,3)
    nrm: torch.Tensor  # (n,3)
    alb: torch.Tensor  # (n,3)
    shade: torch.Tensor  # (n,) i32
    ior: torch.Tensor  # (n,)
    thr: torch.Tensor  # (n,3) path throughput
    li: torch.Tensor  # (n,3) radiance gathered
    alive: torch.Tensor  # (n,) bool
    view: torch.Tensor  # (n,3) incoming direction
    state: torch.Tensor  # (n,) uint32 values in int64
    wrote: torch.Tensor  # (n,) bool: a reservoir was written
    res_cur: restir_mod.Reservoirs


@dataclasses.dataclass
class Scattered:
    """`scatter`'s per-lane results: what the visibility trace, the scatter
    trace and `resolve` read. `sky_w` and `sky_act` only on the final
    bounce of a scene without alpha (the sky any-hit test), else None."""

    li: torch.Tensor  # (n,3) with the bounce-0 sun substitution added
    shadow_o: torch.Tensor  # (n,3) visibility-ray origin (its direction is sel["wi"])
    contrib_w: torch.Tensor  # (n,3) radiance an unoccluded visibility ray adds
    q_act: torch.Tensor  # (n,) bool: the visibility ray is traced
    res_cur: restir_mod.Reservoirs  # merged with ReSTIR's where first written
    wrote: torch.Tensor  # (n,) bool
    new_dir: torch.Tensor  # (n,3) scatter direction
    ray_o: torch.Tensor  # (n,3) scatter-ray origin
    thr: torch.Tensor  # (n,3) throughput after the bounce
    trace_active: torch.Tensor  # (n,) bool: the scatter ray is traced
    state: torch.Tensor  # (n,) after the scatter's draws
    sky_w: torch.Tensor | None = None  # (n,3) sky radiance if the ray escapes
    sky_act: torch.Tensor | None = None  # (n,) bool: the sky ray is traced


def _glass_ior(ior):
    # ior <= 0 falls back to 1.5 (RTRay.cs:251-252)
    return torch.where(ior > 0.0, ior, torch.full_like(ior, 1.5))


def _vis_rr(cfg: RenderConfig, state, contrib_rgb, act, salt):
    """(traced_mask, scale): visibility-ray RR survivors trace and scale
    their contribution by 1/p; scale is None when off."""
    if cfg.shadow_rr_lum <= 0.0:
        return act, None
    lum_w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=torch.float32,
                         device=contrib_rgb.device)
    # the terms in a fixed order (vec.dot): a matmul's reduction can
    # depend on the batch size, and a mesh block is a smaller batch
    c = torch.clamp(vec.dot(contrib_rgb, lum_w), min=0.0)
    p = torch.clamp(c * (1.0 / cfg.shadow_rr_lum), cfg.shadow_rr_pmin, 1.0)
    u = rng_mod.side_float(state, salt)
    return act & (u < p), torch.where(u < p, 1.0 / p, torch.zeros_like(p))


def scatter(lanes: PathLanes, state_rs, res_out, sel, cfg: RenderConfig, depth: int,
            sky: bool, sun_occ0=None, sun_dir_n=None) -> Scattered:
    """A bounce's lane updates between ReSTIR and the traces: the material
    branches, the visibility ray, the reservoir merge, the lambert sample,
    Russian roulette and the scatter ray; with `sky` also the sky ray's
    radiance and roulette. `state_rs` and `res_out`, `sel` are ReSTIR's
    results for `lanes.state`; `sun_occ0` and `sun_dir_n` are the bounce-0
    sun substitution's. On CUDA tensors this is `scatter_kernel`, elsewhere
    `scatter_plain`; the two are equal bit for bit on the card."""
    fn = scatter_kernel if lanes.pos.device.type == "cuda" else scatter_plain
    return fn(lanes, state_rs, res_out, sel, cfg, depth, sky, sun_occ0, sun_dir_n)


def scatter_plain(lanes: PathLanes, state_rs, res_out, sel, cfg: RenderConfig,
                  depth: int, sky: bool, sun_occ0=None, sun_dir_n=None) -> Scattered:
    """`scatter` in PyTorch: the CPU path, and the definition that
    csrc/bounce.cu's `scatter` is held to."""
    pos, nrm, alb, shade, ior, thr = (lanes.pos, lanes.nrm, lanes.alb, lanes.shade,
                                      lanes.ior, lanes.thr)
    alive, view, wrote = lanes.alive, lanes.view, lanes.wrote
    zeros3 = torch.zeros_like
    sky_top, sky_bottom = cfg.sky_tint_top, cfg.sky_tint_bottom

    is_mirror = alive & (shade == SHADING_MIRROR)
    is_glass = alive & (shade == SHADING_GLASS)
    is_lambert = alive & (shade == SHADING_LAMBERT)

    # ---- mirror (RTRay.cs:235-244) ----
    dir_mirror = vec.reflect(view, nrm)

    # ---- glass (RTRay.cs:246-275) ----
    outside = vec.dot(view, nrm) < 0.0
    n_use = torch.where(outside[..., None], nrm, -nrm)
    one = torch.ones_like(ior)
    eta_i = torch.where(outside, one, _glass_ior(ior))
    eta_t = torch.where(outside, _glass_ior(ior), one)
    dir_refl = vec.reflect(view, n_use)
    refr_ok, dir_refr = vec.refract(view, n_use, eta_i, eta_t)
    cos_i = torch.abs(vec.dot(view, n_use))
    fresnel = vec.schlick_fresnel(cos_i, eta_i, eta_t)
    # the glass draw: next_float's value is the state it returns, the one
    # ReSTIR was handed
    xi = rng_mod._unit_float(lanes.state)
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

    # ---- lambert: ReSTIR DI's visibility ray (RTRay.cs:277-298) ----
    state = state_rs
    shadow_o = _offset_origin(pos, nrm, sel["wi"], cfg.eps_n)
    contrib_w = torch.where(
        (is_lambert & sel["ok"])[..., None], thr * sel["contrib"],
        zeros3(thr),
    )
    li = lanes.li
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
    q_act, q_scale = _vis_rr(cfg, state, contrib_w, q_act, SALT_SHADOW_RR)
    if q_scale is not None:
        contrib_w = contrib_w * q_scale[..., None]
    write_mask = is_lambert & (~wrote)
    res_cur = _merge_reservoirs(lanes.res_cur, res_out, write_mask)
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
    ray_o = _offset_origin(pos, offn, new_dir, cfg.eps_n)
    out = Scattered(li=li, shadow_o=shadow_o, contrib_w=contrib_w, q_act=q_act,
                    res_cur=res_cur, wrote=wrote, new_dir=new_dir, ray_o=ray_o, thr=thr,
                    trace_active=trace_active, state=state)
    if sky:
        sky_w = torch.where(
            trace_active[..., None],
            thr * sky_ops.sky_radiance(new_dir, sky_top, sky_bottom),
            zeros3(thr),
        )
        sky_act, sky_scale = _vis_rr(cfg, state, sky_w, trace_active, SALT_SKY_RR)
        if sky_scale is not None:
            sky_w = sky_w * sky_scale[..., None]
        out.sky_w, out.sky_act = sky_w, sky_act
    return out


def scatter_kernel(lanes: PathLanes, state_rs, res_out, sel, cfg: RenderConfig,
                   depth: int, sky: bool, sun_occ0=None, sun_dir_n=None) -> Scattered:
    """`scatter` as one launch of csrc/bounce.cu (ops/cuda/bounce.py)."""
    t, kw = scatter_launch_args(lanes, state_rs, res_out, sel, cfg, depth, sky, sun_occ0,
                                sun_dir_n)
    o = bounce_kernel.scatter(t, **kw)
    res = restir_mod.Reservoirs(**{k: o.pop("res_" + k) for k in bounce_kernel.RES_FIELDS})
    return Scattered(res_cur=res, **o)


def scatter_launch_args(lanes: PathLanes, state_rs, res_out, sel, cfg: RenderConfig,
                        depth: int, sky: bool, sun_occ0=None, sun_dir_n=None):
    """(inputs by name, switches) of `scatter`'s launch
    (ops/cuda/bounce.scatter)."""
    t = {k: getattr(lanes, k) for k in bounce_kernel.LANE_FIELDS}
    t.update({"cur_" + k: getattr(lanes.res_cur, k) for k in bounce_kernel.RES_FIELDS})
    t.update({"out_" + k: getattr(res_out, k) for k in bounce_kernel.RES_FIELDS})
    # as in scatter_plain, the sun's direction counts only with its occlusion
    t.update(state_rs=state_rs, ok=sel["ok"], sel_wi=sel["wi"], contrib=sel["contrib"],
             is_sun=sel["is_sun"], sun_occ=sun_occ0,
             sun_dir=sun_dir_n if sun_occ0 is not None else None)
    vis_rr = cfg.shadow_rr_lum > 0.0
    return t, dict(sky=sky, rr_on=depth >= cfg.rr_start_depth, vis_rr=vis_rr,
                   eps_n=cfg.eps_n, inv_lum=1.0 / cfg.shadow_rr_lum if vis_rr else 0.0,
                   pmin=cfg.shadow_rr_pmin, rr_lo=cfg.rr_clamp_lo, rr_hi=cfg.rr_clamp_hi,
                   sky_top=cfg.sky_tint_top, sky_bottom=cfg.sky_tint_bottom)


def resolve(lanes: PathLanes, sc: Scattered, cfg: RenderConfig, shadow_occ=None,
            sky_occ=None, hit=None, surf=None) -> PathLanes:
    """A bounce's lane updates after its traces: the visibility result
    (`shadow_occ`; None when the ray was queued) added, then the escaped
    scatter ray's sky radiance; the carry moved to the hit surface
    (`hit`, `surf`: the scatter trace's closest hit and its shading) or,
    with `sc.sky_w` (the final bounce's sky test), `alive` from the sky
    ray's occlusion `sky_occ` (None when queued: no lane stays alive); and
    the next bounce's glass draw. Every lane is updated, dead or alive. On
    CUDA tensors this is `resolve_kernel`, elsewhere `resolve_plain`; the
    two are equal bit for bit on the card."""
    fn = resolve_kernel if lanes.pos.device.type == "cuda" else resolve_plain
    return fn(lanes, sc, cfg, shadow_occ, sky_occ, hit, surf)


def resolve_plain(lanes: PathLanes, sc: Scattered, cfg: RenderConfig, shadow_occ=None,
                  sky_occ=None, hit=None, surf=None) -> PathLanes:
    """`resolve` in PyTorch: the CPU path, and the definition that
    csrc/bounce.cu's `resolve` is held to."""
    zeros3 = torch.zeros_like
    li = sc.li
    if shadow_occ is not None:
        li = li + torch.where(
            (sc.q_act & (~shadow_occ))[..., None], sc.contrib_w, zeros3(sc.contrib_w)
        )
    pos, nrm, alb, shade, ior, view = (lanes.pos, lanes.nrm, lanes.alb, lanes.shade,
                                       lanes.ior, lanes.view)
    if sc.sky_w is not None:
        if sky_occ is None:
            # sky radiance lands where the queued trace reports not
            # occluded; `alive` is unused after the last bounce
            alive = torch.zeros_like(sc.trace_active)
        else:
            missed = sc.sky_act & (~sky_occ)
            li = li + torch.where(missed[..., None], sc.sky_w, zeros3(sc.sky_w))
            alive = sc.sky_act & sky_occ
    else:
        missed = sc.trace_active & (~hit.hit)
        li = li + torch.where(
            missed[..., None],
            sc.thr * sky_ops.sky_radiance(sc.new_dir, cfg.sky_tint_top, cfg.sky_tint_bottom),
            zeros3(sc.thr),
        )
        alive = sc.trace_active & hit.hit
        keep = alive[..., None]
        pos = torch.where(keep, surf.pos, pos)
        nrm = torch.where(keep, surf.normal, nrm)
        alb = torch.where(keep, surf.albedo, alb)
        shade = torch.where(alive, surf.shading, shade)
        ior = torch.where(alive, surf.ior, ior)
        view = torch.where(keep, sc.new_dir, view)
    state, _ = rng_mod.next_uint(sc.state)  # the next bounce's glass draw
    return PathLanes(pos=pos, nrm=nrm, alb=alb, shade=shade, ior=ior, thr=sc.thr, li=li,
                     alive=alive, view=view, state=state, wrote=sc.wrote,
                     res_cur=sc.res_cur)


def resolve_kernel(lanes: PathLanes, sc: Scattered, cfg: RenderConfig, shadow_occ=None,
                   sky_occ=None, hit=None, surf=None) -> PathLanes:
    """`resolve` as one launch of csrc/bounce.cu (ops/cuda/bounce.py)."""
    t, kw = resolve_launch_args(lanes, sc, cfg, shadow_occ, sky_occ, hit, surf)
    o = bounce_kernel.resolve(t, **kw)
    if kw["sky"]:  # the carry stays where the final bounce found it
        o.update({k: getattr(lanes, k) for k in bounce_kernel.CARRY_FIELDS})
    return PathLanes(**o, thr=sc.thr, wrote=sc.wrote, res_cur=sc.res_cur)


def resolve_launch_args(lanes: PathLanes, sc: Scattered, cfg: RenderConfig, shadow_occ=None,
                        sky_occ=None, hit=None, surf=None):
    """(inputs by name, switches) of `resolve`'s launch
    (ops/cuda/bounce.resolve)."""
    t = dict(li=sc.li, q_act=sc.q_act, contrib_w=sc.contrib_w, shadow_occ=shadow_occ,
             state=sc.state)
    sky = sc.sky_w is not None
    if sky:
        t.update(sky_w=sc.sky_w, sky_act=sc.sky_act, sky_occ=sky_occ)
    else:
        t.update(trace_active=sc.trace_active, thr=sc.thr, new_dir=sc.new_dir, hit_t=hit.t,
                 surf_pos=surf.pos, surf_nrm=surf.normal, surf_alb=surf.albedo,
                 surf_shade=surf.shading, surf_ior=surf.ior,
                 **{k: getattr(lanes, k) for k in bounce_kernel.CARRY_FIELDS})
    return t, dict(sky=sky, sky_top=cfg.sky_tint_top, sky_bottom=cfg.sky_tint_bottom)


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
    sort = route.sort_key(scene, wscene, cfg)  # None: the bounces trace unsorted

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

    def bounce_step(lanes: PathLanes, eff, depth: int, allow_reuse: bool, sun_occ0=None,
                    sun_dir_n=None, final: bool = False):
        # ---- lambert: ReSTIR DI (RTRay.cs:277-298); reuse only at the
        # first diffuse vertex of the peeled first bounce ----
        is_lambert = lanes.alive & (lanes.shade == SHADING_LAMBERT)
        reuse_ok = is_lambert & (~lanes.wrote)
        no = torch.zeros_like(reuse_ok)
        en_t = reuse_ok if (cfg.enable_temporal_reuse and allow_reuse) else no
        en_s = reuse_ok if (cfg.enable_spatial_reuse and allow_reuse) else no
        static_reuse = allow_reuse and (
            cfg.enable_temporal_reuse or cfg.enable_spatial_reuse
        )
        with telemetry.span("restir"):
            state_rs, res_out, sel = restir_mod.restir_direct(
                scene, gb_full, res_prev, lanes.state, is_lambert, lanes.pos, lanes.nrm,
                lanes.alb, pixel_idx, width, height, frame, prev_camera, cam_origin,
                sun_dir, sun_radiance, sky_top, sky_bottom, en_t, en_s,
                cfg.local_candidates, cfg.delta_candidates,
                static_reuse=static_reuse,
                reference_weighting=cfg.restir_reference_weighting,
                reps=spp, reps_pixel_major=pixel_major,
            )
        # the final scatter ray only feeds a sky-visibility test: run the
        # early-exit any-hit walk and skip hit shading. Alpha scenes keep
        # the closest path: the any-hit band of their shadow peel is
        # deliberately not the closest-hit cutout (SceneDeviceViews.cs:297-315)
        sky = final and not scene.has_alpha
        sc = scatter(lanes, state_rs, res_out, sel, cfg, depth, sky, sun_occ0, sun_dir_n)
        shadow_occ = sky_occ = hit = surf = None
        if shadow_queue is not None:
            shadow_queue.append(dict(o=sc.shadow_o, d=sel["wi"], contrib=sc.contrib_w,
                                     act=sc.q_act))
        else:
            with telemetry.span("shadow"):
                shadow_occ = route.any_hit(scene, wscene, sc.shadow_o, sel["wi"], 1e29,
                                           active=sc.q_act, sort=sort)
        # queued or traced, each lane counts once, here
        eff = eff + torch.sum(sc.q_act.to(torch.float32))
        eff = eff + torch.sum(sc.trace_active.to(torch.float32))
        if sky:
            if cfg.shadow_rr_lum > 0.0:
                eff = eff - torch.sum((sc.trace_active & (~sc.sky_act)).to(torch.float32))
            if shadow_queue is not None:
                shadow_queue.append(dict(o=sc.ray_o, d=sc.new_dir, contrib=sc.sky_w,
                                         act=sc.sky_act))
            else:
                with telemetry.span("trace"):
                    sky_occ = route.any_hit(scene, wscene, sc.ray_o, sc.new_dir, 1e29,
                                            active=sc.sky_act, sort=sort)
        else:
            with telemetry.span("trace"):
                hit = route.closest(scene, wscene, sc.ray_o, sc.new_dir,
                                    active=sc.trace_active, sort=sort)
            with telemetry.span("shade"):
                surf = traverse.shade_hits(scene, hit, sc.ray_o, sc.new_dir)
        return resolve(lanes, sc, cfg, shadow_occ, sky_occ, hit, surf), eff

    # noise streams stay keyed to the CANONICAL pixel id (y*width+x)
    canonical_idx = py * width + px

    # bounce-0 sun occlusion is sample-invariant: one coherent trace per
    # frame from the lambert G-buffer points, shared by all samples
    sun_dir_n = vec.normalize(torch.as_tensor(sun_dir, dtype=torch.float32, device=dev))
    if cfg.dedup_sun_shadow:
        with telemetry.span("sun_shadow"):
            wi_sun0 = torch.broadcast_to(sun_dir_n, gb_px.pos.shape)
            lam0 = gb_px.hit & (gb_px.shading == SHADING_LAMBERT)
            sun_o0 = _offset_origin(gb_px.pos, vec.normalize(gb_px.normal),
                                    wi_sun0, cfg.eps_n)
            sun_occ0 = tile(route.any_hit(scene, wscene, sun_o0, wi_sun0.contiguous(),
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
    # the first bounce's glass draw
    state, _ = rng_mod.next_uint(state)
    li0 = torch.where(gb.hit[..., None], torch.zeros_like(miss_sky), miss_sky)
    lanes = PathLanes(
        pos=gb.pos, nrm=vec.normalize(gb.normal), alb=gb.albedo, shade=gb.shading,
        ior=gb.ior, thr=torch.ones((n, 3), dtype=torch.float32, device=dev), li=li0,
        alive=gb.hit, view=view_i, state=state,
        wrote=torch.zeros((n,), dtype=torch.bool, device=dev),
        res_cur=res_cur_init.map(tile),
    )
    eff = eff0
    n_bounce = max(1, cfg.max_depth)
    for depth in range(n_bounce):
        with telemetry.span("bounce", depth=depth):
            lanes, eff = bounce_step(
                lanes, eff, depth, allow_reuse=(depth == 0),
                sun_occ0=sun_occ0 if depth == 0 else None,
                sun_dir_n=sun_dir_n if depth == 0 else None,
                final=(depth == n_bounce - 1),
            )
    li, wrote, res_vec = lanes.li, lanes.wrote, lanes.res_cur

    if shadow_queue:
        # one frame-wide sorted any-hit dispatch over every queued segment
        # (max_depth ReSTIR batches and the final sky batch), then each
        # segment's radiance in queue order
        with telemetry.span("deferred_shadow"):
            n_seg = len(shadow_queue)
            q_act = torch.cat([q["act"] for q in shadow_queue])
            occ = route.any_hit(
                scene, wscene, torch.cat([q["o"] for q in shadow_queue]),
                torch.cat([q["d"] for q in shadow_queue]), 1e29, active=q_act,
                sort=sort,
            )
            vis = (q_act & (~occ)).reshape(n_seg, n)
            for b, q in enumerate(shadow_queue):
                li = li + torch.where(vis[b][..., None], q["contrib"],
                                      torch.zeros_like(q["contrib"]))

    # fold per pixel in sample order: scrubbed radiance sum; reservoirs keep
    # the LAST sample that wrote (the same numbers in the same order under
    # either lane layout)
    def sample_slice(x, s):
        if pixel_major:
            return x.reshape(m, spp, *x.shape[1:])[:, s]
        return x.reshape(spp, m, *x.shape[1:])[s]

    with telemetry.span("fold"):
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
