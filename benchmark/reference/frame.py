"""The reference frame: one step of the path tracer in plain PyTorch.

A frozen restatement of the renderer's plain frame path for the scenes the
benchmark builds (one mesh and spheres, every instance at the identity;
triangles may carry a diffuse texture and an alpha-cutout mask):
primary visibility and deferred shading, the wavefront path trace with all
samples in one lane batch (ReSTIR DI over sky and sun candidates with
temporal and spatial reuse from the previous frame, mirror, glass and
lambert bounces, Russian roulette, visibility-ray roulette, the shared
bounce-0 sun ray and the final any-hit sky test), the per-pixel fold,
progressive accumulation, tone map and pack, and the TAAU resolve to the
output resolution. Ray queries go to the reference's own structure
(`accel`), which tests the alpha masks in its walk; textures are read by
`texture`. On a scene with any alpha mask the last bounce traces its
scatter ray for the closest hit and takes the sky where it misses, as the
renderer does there, in place of the opaque scenes' any-hit sky test with
its roulette. It imports nothing of the program under test.

`render_frame` takes the frame's inputs and the state carried in from the
previous frame and returns the presented frame and the state it hands on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import accel
from benchmark.reference import ops
from benchmark.reference import texture

SHADING_LAMBERT, SHADING_MIRROR, SHADING_GLASS = 0, 1, 2
LIGHT_ENV, LIGHT_SUN = 1, 2
EPS_MIN = 1e-6
RES_FIELDS = ("L", "wi", "pdf", "w", "w_sum", "m", "light_id", "W")


@dataclasses.dataclass
class Res:
    """Per-pixel reservoirs (candidate radiance, direction, pdf, target,
    weight sum, count, light kind, contribution weight)."""

    L: torch.Tensor
    wi: torch.Tensor
    pdf: torch.Tensor
    w: torch.Tensor
    w_sum: torch.Tensor
    m: torch.Tensor
    light_id: torch.Tensor
    W: torch.Tensor

    @staticmethod
    def empty(n: int, device) -> "Res":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        zi = lambda: torch.zeros((n,), dtype=torch.int32, device=device)
        return Res(L=z(n, 3), wi=z(n, 3), pdf=z(n), w=z(n), w_sum=z(n), m=zi(),
                   light_id=zi(), W=z(n))

    def map(self, fn) -> "Res":
        return Res(**{k: fn(getattr(self, k)) for k in RES_FIELDS})


@dataclasses.dataclass
class State:
    """What one frame hands the next."""

    res_prev: Res
    res_cur: Res
    taa_color: torch.Tensor  # (out_n,) int64 packed history
    taa_obj: torch.Tensor  # (out_n,) int32
    taa_valid: bool
    accum: torch.Tensor  # (low_n, 3)
    accum_count: int

    @staticmethod
    def empty(low_n: int, out_n: int, device) -> "State":
        return State(res_prev=Res.empty(low_n, device), res_cur=Res.empty(low_n, device),
                     taa_color=torch.zeros((out_n,), dtype=torch.int64, device=device),
                     taa_obj=torch.full((out_n,), -1, dtype=torch.int32, device=device),
                     taa_valid=False,
                     accum=torch.zeros((low_n, 3), dtype=torch.float32, device=device),
                     accum_count=0)


def internal_resolution(s: dict, out_w: int, out_h: int) -> tuple[int, int]:
    """render_scale per axis, capped at max_ray_pixels and min_rt_dim,
    rounded down to 64-pixel blocks."""
    w = max(1, int(round(out_w * s["render_scale"])))
    h = max(1, int(round(out_h * s["render_scale"])))
    if w * h > s["max_ray_pixels"]:
        k = (s["max_ray_pixels"] / float(w * h)) ** 0.5
        w = max(s["min_rt_dim"], int(w * k))
        h = max(s["min_rt_dim"], int(h * k))
    lo = s["min_rt_dim"] if min(out_w, out_h) >= s["min_rt_dim"] else 1
    w, h = max(lo, w), max(lo, h)
    if w >= 64 and h >= 64:
        w -= w % 64
        h -= h % 64
    return w, h


# ---------------- scene tables for shading ----------------


@dataclasses.dataclass
class Scene:
    """Geometry for ray queries plus the shading rows of every primitive."""

    acc: accel.Accel
    tri_rows: torch.Tensor  # (T, 12): e1 e2 kd two_sided shading ior; one row of 0 where T is 0
    sph_rows: torch.Tensor  # (S, 9): center radius base_albedo shading ior; likewise
    # a textured scene's: the texture pool, corner UVs (T, 3, 2) and diffuse
    # texture (T,) of each triangle
    pool: texture.Pool | None = None
    tri_uv: torch.Tensor | None = None
    tri_dtex: torch.Tensor | None = None
    has_alpha: bool = False


def make_scene(spec: dict, device, round_to=None) -> Scene:
    """From a scene spec (`benchmark/scenes/<kind>.py`): materials, one
    mesh (positions, tris, tri_mat; it may have no triangles) and spheres;
    a textured spec adds `textures`, the mesh's `tri_uv` and the
    materials' `diffuse_tex`, `alpha_tex` and `alpha_cutoff`."""
    mesh, mats, spheres = spec["mesh"], spec["materials"], spec["spheres"]
    textured = "textures" in spec
    if textured and any(mats[s["material"]].get("diffuse_tex", -1) >= 0 for s in spheres):
        raise ValueError("the reference reads no texture on a sphere")
    tm = np.asarray(mesh["tri_mat"], np.int64)
    per_tri = lambda key, default, dt: torch.as_tensor(
        np.array([m.get(key, default) for m in mats])[tm], dtype=dt, device=device)
    pool = texture.pool(spec["textures"], device, round_to) if textured else None
    tri_uv = (torch.as_tensor(np.asarray(mesh["tri_uv"], np.float32), device=device)
              if textured else None)
    has_alpha = textured and any(m.get("alpha_tex", -1) >= 0 for m in mats)
    masks = accel.Masks(tri_uv, per_tri("alpha_tex", -1, torch.int64),
                        per_tri("alpha_cutoff", 0.5, torch.float32), pool) if has_alpha else None
    acc = accel.build(mesh["positions"], mesh["tris"], spheres, device, round_to, masks)
    mk = lambda key: np.array([m[key] for m in mats], np.float32)
    kd, two, shade, ior = (mk("kd"), mk("two_sided"), mk("shading"), mk("ior"))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    if tm.shape[0]:
        tri_rows = torch.cat([acc.e1, acc.e2, t(kd[tm]), t(two[tm])[:, None],
                              t(shade[tm])[:, None], t(ior[tm])[:, None]], dim=1)
    else:
        tri_rows = torch.zeros((1, 12), dtype=torch.float32, device=device)
    if spheres:
        base = []
        for s in spheres:
            m_kd = np.asarray(mats[s["material"]]["kd"], np.float32)
            base.append(np.asarray(s["albedo"], np.float32) if np.all(m_kd == 0.0) else m_kd)
        sph_rows = torch.cat([acc.sph_center, acc.sph_radius[:, None], t(np.stack(base)),
                              t([float(s["shading"]) for s in spheres])[:, None],
                              t([s["ior"] for s in spheres])[:, None]], dim=1)
    else:
        sph_rows = torch.zeros((1, 9), dtype=torch.float32, device=device)
    return Scene(acc=acc, tri_rows=tri_rows, sph_rows=sph_rows, pool=pool, tri_uv=tri_uv,
                 tri_dtex=per_tri("diffuse_tex", -1, torch.int64) if textured else None,
                 has_alpha=has_alpha)


def shade_hits(sc: Scene, hit: accel.Hits, o, d):
    """Surface attributes at each hit: position, shading normal (two-sided
    triangles face the ray), albedo (a textured triangle's from its
    diffuse texture at the hit's UV, in place of kd), shading mode, ior,
    object id (the global triangle id, -1 for spheres and misses)."""
    n = o.shape[0]
    is_sph = hit.kind == accel.KIND_SPHERE
    is_tri = hit.kind == accel.KIND_TRI
    prim = torch.clamp(hit.prim, min=0).long()
    trow = sc.tri_rows[prim.clamp(max=sc.tri_rows.shape[0] - 1)]
    srow = sc.sph_rows[prim.clamp(max=sc.sph_rows.shape[0] - 1)]
    ident = sc.acc.identity.expand(n, 3, 4)
    pos_w = o + d * hit.t[..., None]
    d_obj = ops.transform_vector(ident, d)
    p_obj = ops.transform_point(ident, pos_w)
    n_sph_obj = ops.normalize(p_obj - srow[:, 0:3])
    n_tri_obj = ops.normalize(ops.cross(trow[:, 0:3], trow[:, 3:6]))
    flip = (trow[:, 9] != 0.0) & (ops.dot(n_tri_obj, d_obj) > 0.0)
    n_tri_obj = torch.where(flip[..., None], -n_tri_obj, n_tri_obj)
    n_obj = torch.where(is_sph[..., None], n_sph_obj, n_tri_obj)
    normal_w = ops.normalize(ops.transform_vector(ident, n_obj))
    tri_albedo = trow[:, 6:9]
    if sc.pool is not None:
        last = sc.tri_uv.shape[0] - 1
        u, v = texture.uv_at(sc.tri_uv[prim.clamp(max=last)], hit.bu, hit.bv)
        dtex = sc.tri_dtex[prim.clamp(max=last)]
        tri_albedo = torch.where((dtex >= 0)[..., None],
                                 texture.bilinear(sc.pool, sc.pool.rgb, dtex, u, v), tri_albedo)
    albedo = torch.where(is_sph[..., None], srow[:, 4:7], tri_albedo)
    shading = torch.where(is_sph, srow[:, 7].to(torch.int32), trow[:, 10].to(torch.int32))
    ior_raw = torch.where(is_sph, srow[:, 8], trow[:, 11])
    ior = torch.where(ior_raw > 0.0, ior_raw, torch.ones_like(ior_raw))
    obj_id = torch.where(is_tri, hit.prim, -1).to(torch.int32)
    miss = ~hit.hit
    up = torch.tensor([0.0, 1.0, 0.0], dtype=o.dtype, device=o.device)
    return dict(pos=torch.where(miss[..., None], o + d * 1e6, pos_w),
                normal=torch.where(miss[..., None], up, normal_w),
                albedo=torch.where(miss[..., None], torch.zeros_like(albedo), albedo),
                shading=torch.where(miss, -1, shading).to(torch.int32),
                ior=torch.where(miss, torch.ones_like(ior), ior),
                obj_id=torch.where(miss, -1, obj_id).to(torch.int32), hit=hit.hit)


# ---------------- ReSTIR DI ----------------


def _rows(mask, a, b):
    return torch.where(mask[..., None] if a.dim() > mask.dim() else mask, a, b)


def _update(res: Res, state, wi, pdf_sel, li, score, s_hat, light_id, mask):
    zero = torch.zeros_like(score)
    add = torch.where(mask, score, zero)
    new_sum = res.w_sum + add
    accept_p = torch.where(new_sum > 0.0, add / torch.clamp(new_sum, min=EPS_MIN), zero)
    state, u = ops.next_float(state)
    take = mask & (u < accept_p)
    if not isinstance(light_id, torch.Tensor):
        light_id = torch.full_like(res.m, int(light_id))
    return state, Res(L=_rows(take, li, res.L), wi=_rows(take, wi, res.wi),
                      pdf=torch.where(take, pdf_sel, res.pdf),
                      w=torch.where(take, s_hat, res.w),
                      w_sum=torch.where(mask, new_sum, res.w_sum),
                      m=res.m + mask.to(torch.int32),
                      light_id=torch.where(take, light_id, res.light_id), W=res.W)


def _reproject(pos, prev: dict, width: int, height: int):
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=pos.device)
    p = pos - f(prev["origin"])
    x = ops.dot(p, f(prev["right"]))
    y = ops.dot(p, f(prev["up"]))
    z = ops.dot(p, f(prev["forward"]))
    ok = z > 1e-4
    z_safe = torch.where(ok, z, torch.ones_like(z))
    tan_half = torch.tan(0.5 * f(prev["fov_y"]))
    ndc_x = x / (z_safe * tan_half * f(prev["aspect"]))
    ndc_y = y / (z_safe * tan_half)
    px = torch.floor(0.5 * (ndc_x + 1.0) * width).to(torch.int32)
    py = torch.floor(0.5 * (ndc_y + 1.0) * height).to(torch.int32)
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    idx = ops.position_from_xy(px, py, width, height)
    return torch.where(ok & inside, idx, -1).to(torch.int32)


def _pack_res(res: Res):
    return torch.cat([res.L, res.wi, res.pdf[:, None], res.w[:, None], res.w_sum[:, None],
                      res.m.to(torch.float32)[:, None],
                      res.light_id.to(torch.float32)[:, None], res.W[:, None]], dim=1)


def _pack_gb(gb: dict):
    return torch.cat([gb["pos"], gb["normal"], gb["obj_id"].to(torch.float32)[:, None]], dim=1)


def _import_rows(res, state, row, gbr, valid, own_obj, own_z, cam_origin, n, albedo,
                 mix_local, mix_delta, sun_radiance, sky_top, sky_bottom):
    obj_b = gbr[:, 6].to(torch.int32)
    n_b = ops.normalize(gbr[:, 3:6])
    z_b = ops.length(gbr[:, 0:3] - cam_origin)
    ndot = ops.dot(n, n_b)
    rel = torch.abs(own_z - z_b) / torch.clamp(own_z, min=1e-3)
    valid = valid & ((own_obj == obj_b) | ((ndot >= 0.85) & (rel < 0.05)))
    m = row[:, 9].to(torch.int32)
    w, w_sum, W = row[:, 7], row[:, 8], row[:, 11]
    valid = valid & (m > 0) & (w > 0.0) & (w_sum > 0.0) & (W > 0.0)
    wi = row[:, 3:6]
    is_sun = row[:, 10].to(torch.int32) == LIGHT_SUN
    sun_l = torch.as_tensor(sun_radiance, dtype=torch.float32, device=wi.device)
    li = torch.where(is_sun[..., None], sun_l, ops.sky_radiance(wi, sky_top, sky_bottom))
    nl = torch.clamp(ops.dot(n, wi), min=0.0)
    pdf_here = torch.where(is_sun, torch.full_like(nl, max(EPS_MIN, mix_delta)),
                           torch.clamp(ops.cos_hemisphere_pdf(n, wi) * mix_local, min=EPS_MIN))
    s_hat = ops.luminance(albedo * li * (nl * ops.INV_PI)[..., None])
    eff = s_hat * W
    lid = torch.where(is_sun, LIGHT_SUN, LIGHT_ENV).to(torch.int32)
    state, res = _update(res, state, wi, pdf_here, li, eff, s_hat, lid, valid)
    return state, res, n_b, valid


_NEIGHBOR_BASE = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1), (1, 1))


def _rotate(cx: int, cy: int, ro: int):
    return ((cx, cy), (-cy, cx), (-cx, -cy), (cy, -cx))[ro]


def _spatial_fetcher(res_packed, gb_packed, width: int, height: int, frame: int):
    dev = res_packed.device
    arr = torch.cat([res_packed, gb_packed], dim=1)
    c = arr.shape[1]
    pad = torch.zeros((height + 4, width + 4, c), dtype=arr.dtype, device=dev)
    pad[2:2 + height, 2:2 + width] = ops.to_image(arr, width, height)
    xs = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    ys = torch.arange(height, dtype=torch.int64, device=dev)[:, None]
    fh = ops.hash32(ops.u32(int(frame), dev) ^ ops.hash32(ops.u32(0xB31F5AB1, dev)))
    h = ops.hash32(ops.u32(ys * width + xs) ^ fh)
    rot = (h & 3).to(torch.int32)
    rad = 1 + ((h >> 2) & 1).to(torch.int32)

    def fetch(slot: int, pixel_idx):
        cx, cy = _NEIGHBOR_BASE[slot]
        sel = torch.zeros((height, width, c), dtype=arr.dtype, device=dev)
        for ro in range(4):
            rcx, rcy = _rotate(cx, cy, ro)
            for ra in (1, 2):
                dx, dy = rcx * ra, rcy * ra
                shifted = pad[2 + dy: 2 + dy + height, 2 + dx: 2 + dx + width]
                inb = (xs + dx >= 0) & (xs + dx < width) & (ys + dy >= 0) & (ys + dy < height)
                sel = torch.where(((rot == ro) & (rad == ra) & inb)[..., None], shifted, sel)
        chunk = ops.from_image(sel)[pixel_idx.long()]
        return chunk[:, :12], chunk[:, 12:]

    return fetch


def restir_direct(s: dict, gb: dict, res_prev: Res, state, active, pos, n, albedo,
                  pixel_idx, width, height, frame, prev_cam, cam_origin, sun_dir,
                  en_t, en_s, static_reuse: bool, reps: int):
    """Candidates, temporal and spatial reuse and selection of one
    visibility sample per lane. Returns (state, reservoirs, selection)."""
    local, delta = s["local_candidates"], s["delta_candidates"]
    mix_local, mix_delta = float(local) / float(local + delta), float(delta) / float(local + delta)
    sky_top, sky_bottom, sun_radiance = s["sky_tint_top"], s["sky_tint_bottom"], s["sun_radiance"]
    dev = pos.device
    res = Res.empty(pos.shape[0], dev)
    for _ in range(local):
        state, wi = ops.sample_hemisphere_cosine(n, state)
        nl = torch.clamp(ops.dot(n, wi), min=0.0)
        pdf_local = torch.clamp(ops.cos_hemisphere_pdf(n, wi), min=EPS_MIN)
        pdf_sel = torch.clamp(pdf_local * mix_local, min=EPS_MIN)
        li = ops.sky_radiance(wi, sky_top, sky_bottom)
        s_hat = ops.luminance(albedo * li * (nl * ops.INV_PI)[..., None])
        state, res = _update(res, state, wi, pdf_sel, li, s_hat / pdf_sel, s_hat,
                             LIGHT_ENV, active)
    wi_sun = torch.broadcast_to(ops.normalize(ops.f32(sun_dir, dev)), pos.shape)
    nl = torch.clamp(ops.dot(n, wi_sun), min=0.0)
    pdf_sel = torch.full_like(nl, max(EPS_MIN, mix_delta))
    li_sun = torch.broadcast_to(ops.f32(sun_radiance, dev), pos.shape)
    s_hat = ops.luminance(albedo * li_sun * (nl * ops.INV_PI)[..., None])
    state, res = _update(res, state, wi_sun, pdf_sel, li_sun, s_hat / pdf_sel, s_hat,
                         LIGHT_SUN, active)

    imports = []
    if static_reuse:
        res_packed, gb_packed = _pack_res(res_prev), _pack_gb(gb)
        m_px = pos.shape[0] // max(1, reps)
        px_rows = pixel_idx[:m_px]
        expand = (lambda x: x.repeat(reps, 1)) if reps > 1 else (lambda x: x)
        own_px = px_rows.long()
        own_sl = expand(torch.cat([gb["pos"][own_px],
                                   gb["obj_id"][own_px].to(torch.float32)[:, None]], dim=1))
        own_obj = own_sl[:, 3].to(torch.int32)
        own_z = ops.length(own_sl[:, 0:3] - cam_origin)
        args = (own_obj, own_z, cam_origin, n, albedo, mix_local, mix_delta, sun_radiance,
                sky_top, sky_bottom)
        prev_idx = _reproject(pos, prev_cam, width, height)
        n_res = res_packed.shape[0]
        both = torch.cat([res_packed, gb_packed], dim=1)
        rows = both[prev_idx.long().clamp(0, n_res - 1)]
        valid = active & en_t & (prev_idx >= 0) & (prev_idx < n_res)
        state, res, n_b, vld = _import_rows(res, state, rows[:, :12], rows[:, 12:], valid, *args)
        imports.append((n_b, vld))
        fetch = _spatial_fetcher(res_packed, gb_packed, width, height, frame)
        for slot in range(len(_NEIGHBOR_BASE)):
            row12, gbr7 = fetch(slot, px_rows)
            state, res, n_b, vld = _import_rows(res, state, expand(row12), expand(gbr7),
                                                active & en_s, *args)
            imports.append((n_b, vld))

    ok = active & (res.m > 0) & (res.w_sum > 0.0) & (res.w > 0.0)
    wi_sel = res.wi
    is_sun = res.light_id == LIGHT_SUN
    nl_sel = torch.clamp(ops.dot(n, wi_sel), min=0.0)
    ok = ok & (nl_sel > 0.0)
    sun_l = ops.f32(sun_radiance, dev)
    li_sel = torch.where(is_sun[..., None], sun_l, ops.sky_radiance(wi_sel, sky_top, sky_bottom))
    z_sub = torch.zeros_like(res.w_sum)
    for n_src, vld in imports:
        z_sub = z_sub + (vld & (ops.dot(n_src, wi_sel) <= 0.0)).to(torch.float32)
    z_count = torch.clamp(res.m.to(torch.float32) - z_sub, min=1.0)
    w_ucw = res.w_sum / z_count / torch.clamp(res.w, min=EPS_MIN)
    res = dataclasses.replace(res, W=torch.where(ok, w_ucw, torch.zeros_like(w_ucw)))
    f_sel = albedo * li_sel * (nl_sel * ops.INV_PI)[..., None]
    return state, res, dict(ok=ok, wi=wi_sel, contrib=f_sel * w_ucw[..., None], is_sun=is_sun)


# ---------------- integrator ----------------


def _offset_origin(pos, n, d, eps):
    s = torch.where(ops.dot(n, d) >= 0.0, 1.0, -1.0)
    return pos + n * (eps * s)[..., None]


class Tracer:
    """Ray queries of one frame; with `round_to` every ray's origin and
    direction is rounded to that precision first (the control). Counts the
    live lanes of each kind of query: the rays the path tracer keeps alive
    after misses, Russian roulette and visibility-ray roulette."""

    def __init__(self, sc: Scene, round_to=None):
        self.sc, self.round_to = sc, round_to
        self.closest_lanes = 0
        self.anyhit_lanes = 0

    def _r(self, x):
        return x if self.round_to is None else x.to(self.round_to).to(torch.float32)

    @staticmethod
    def _live(o, active) -> int:
        return int(o.shape[0]) if active is None else int(active.sum())

    def closest(self, o, d, active=None):
        self.closest_lanes += self._live(o, active)
        return accel.trace_closest(self.sc.acc, self._r(o), self._r(d), active)

    def occluded(self, o, d, active=None):
        self.anyhit_lanes += self._live(o, active)
        return accel.occluded(self.sc.acc, self._r(o), self._r(d), 1e29, active)


def primary_visibility(tr: Tracer, cam: dict, width: int, height: int, dev):
    u, v = ops.pixel_centers(width, height, dev)
    o, d = ops.generate_rays(cam, u, v)
    o = o.contiguous()
    return shade_hits(tr.sc, tr.closest(o, d), o, d)


def path_trace(s: dict, tr: Tracer, gb: dict, cam: dict, prev_cam: dict, res_prev: Res,
               res_cur_init: Res, frame: int, noise_key: int, sun_dir, width: int,
               height: int):
    """All spp samples of every pixel in one (spp * m,) lane batch, sample-
    major. Returns (color (m, 3), obj_id, res_cur)."""
    dev = gb["pos"].device
    m = width * height
    spp = max(1, s["spp"])
    n = spp * m
    pixel_idx = torch.arange(0, m, dtype=torch.int32, device=dev)
    cam_origin = ops.f32(cam["origin"], dev)
    sky_top, sky_bottom = s["sky_tint_top"], s["sky_tint_bottom"]
    eps_n = s["eps_n"]

    def tile(x):
        return x.repeat((spp,) + (1,) * (x.dim() - 1))

    px, py = ops.xy_from_position(pixel_idx, width, height)
    pu = (px.to(torch.float32) + 0.5) / float(max(1, width))
    pv = (py.to(torch.float32) + 0.5) / float(max(1, height))
    _, primary_d = ops.generate_rays(cam, pu, pv)
    miss_sky = tile(ops.sky_radiance(primary_d, sky_top, sky_bottom))
    gb_px = gb
    gbt = {k: tile(v) for k, v in gb.items()}
    pix = tile(pixel_idx)
    view_i = ops.normalize(gbt["pos"] - cam_origin)
    lum_w = torch.tensor([0.2126, 0.7152, 0.0722], dtype=torch.float32, device=dev)

    def glass_ior(ior):
        return torch.where(ior > 0.0, ior, torch.full_like(ior, 1.5))

    def vis_rr(state, contrib_rgb, act, salt):
        if s["shadow_rr_lum"] <= 0.0:
            return act, None
        c = torch.clamp(ops.dot(contrib_rgb, lum_w), min=0.0)
        p = torch.clamp(c * (1.0 / s["shadow_rr_lum"]), s["shadow_rr_pmin"], 1.0)
        u = ops.side_float(state, salt)
        return act & (u < p), torch.where(u < p, 1.0 / p, torch.zeros_like(p))

    zeros3 = torch.zeros_like

    def bounce(carry, depth: int, allow_reuse: bool, sun_occ0, sun_dir_n, final: bool):
        pos, nrm, alb, shade, ior, thr, li, alive, view, state, wrote, res_cur = carry
        is_mirror = alive & (shade == SHADING_MIRROR)
        is_glass = alive & (shade == SHADING_GLASS)
        is_lambert = alive & (shade == SHADING_LAMBERT)
        dir_mirror = ops.reflect(view, nrm)
        outside = ops.dot(view, nrm) < 0.0
        n_use = torch.where(outside[..., None], nrm, -nrm)
        one = torch.ones_like(ior)
        eta_i = torch.where(outside, one, glass_ior(ior))
        eta_t = torch.where(outside, glass_ior(ior), one)
        dir_refl = ops.reflect(view, n_use)
        refr_ok, dir_refr = ops.refract(view, n_use, eta_i, eta_t)
        cos_i = torch.abs(ops.dot(view, n_use))
        fresnel = ops.schlick_fresnel(cos_i, eta_i, eta_t)
        state, xi = ops.next_float(state)
        choose_refl = (~refr_ok) | (xi < fresnel)
        dir_glass = torch.where(choose_refl[..., None], dir_refl, dir_refr)
        offn_glass = torch.where(choose_refl[..., None], n_use, -n_use)
        alb_black = torch.all(alb == 0.0, dim=-1)
        trans_tint = torch.where(alb_black[..., None], torch.ones_like(alb), alb)
        eta_scale = (eta_i * eta_i) / (eta_t * eta_t)
        thr_glass_mult = torch.where(choose_refl[..., None], torch.ones_like(alb),
                                     trans_tint * eta_scale[..., None])

        reuse_ok = is_lambert & (~wrote)
        no = torch.zeros_like(reuse_ok)
        en_t = reuse_ok if (s["enable_temporal_reuse"] and allow_reuse) else no
        en_s = reuse_ok if (s["enable_spatial_reuse"] and allow_reuse) else no
        static_reuse = allow_reuse and (s["enable_temporal_reuse"] or s["enable_spatial_reuse"])
        state, res_out, sel = restir_direct(
            s, gb, res_prev, state, is_lambert, pos, nrm, alb, pix, width, height, frame,
            prev_cam, cam_origin, sun_dir, en_t, en_s, static_reuse, spp)
        shadow_o = _offset_origin(pos, nrm, sel["wi"], eps_n)
        contrib_w = torch.where((is_lambert & sel["ok"])[..., None], thr * sel["contrib"],
                                zeros3(thr))
        if sun_occ0 is not None:
            exact = torch.all(sel["wi"] == sun_dir_n[None, :], dim=-1)
            sun_sel = sel["is_sun"] & sel["ok"] & exact
            li = li + torch.where((sun_sel & (~sun_occ0))[..., None], contrib_w,
                                  zeros3(contrib_w))
            q_act = sel["ok"] & (~sun_sel)
        else:
            q_act = sel["ok"]
        q_act, q_scale = vis_rr(state, contrib_w, q_act, 0x53484457)
        if q_scale is not None:
            contrib_w = contrib_w * q_scale[..., None]
        occ = tr.occluded(shadow_o, sel["wi"], active=q_act)
        li = li + torch.where((q_act & (~occ))[..., None], contrib_w, zeros3(contrib_w))
        write_mask = is_lambert & (~wrote)
        res_cur = Res(**{k: _rows(write_mask, getattr(res_out, k), getattr(res_cur, k))
                         for k in RES_FIELDS})
        wrote = wrote | is_lambert

        state, dir_diffuse = ops.sample_hemisphere_cosine(nrm, state)
        thr_lambert = thr * alb
        max_c = torch.clamp(torch.amax(thr_lambert, dim=-1), s["rr_clamp_lo"], s["rr_clamp_hi"])
        state, u_rr = ops.next_float(state)
        rr_on = is_lambert & (depth >= s["rr_start_depth"])
        rr_kill = rr_on & (u_rr > max_c)
        rr_scale = torch.where(rr_on & (~rr_kill), 1.0 / max_c, torch.ones_like(max_c))
        new_dir = torch.where(is_mirror[..., None], dir_mirror,
                              torch.where(is_glass[..., None], dir_glass, dir_diffuse))
        offn = torch.where(is_glass[..., None], offn_glass, nrm)
        thr = torch.where(
            is_mirror[..., None], thr * alb,
            torch.where(is_glass[..., None], thr * thr_glass_mult,
                        torch.where(is_lambert[..., None], thr_lambert * rr_scale[..., None],
                                    thr)))
        thr = torch.where(rr_kill[..., None], zeros3(thr), thr)
        trace_active = alive & (~rr_kill)
        ray_o = _offset_origin(pos, offn, new_dir, eps_n)
        if final and not tr.sc.has_alpha:
            sky_w = torch.where(trace_active[..., None],
                                thr * ops.sky_radiance(new_dir, sky_top, sky_bottom), zeros3(thr))
            sky_act, sky_scale = vis_rr(state, sky_w, trace_active, 0x534B5952)
            if sky_scale is not None:
                sky_w = sky_w * sky_scale[..., None]
            occ = tr.occluded(ray_o, new_dir, active=sky_act)
            li = li + torch.where((sky_act & (~occ))[..., None], sky_w, zeros3(sky_w))
            alive = sky_act & occ
        else:
            hit = tr.closest(ray_o, new_dir, active=trace_active)
            surf = shade_hits(tr.sc, hit, ray_o, new_dir)
            missed = trace_active & (~hit.hit)
            li = li + torch.where(missed[..., None],
                                  thr * ops.sky_radiance(new_dir, sky_top, sky_bottom),
                                  zeros3(thr))
            alive = trace_active & hit.hit
            keep = alive[..., None]
            pos = torch.where(keep, surf["pos"], pos)
            nrm = torch.where(keep, surf["normal"], nrm)
            alb = torch.where(keep, surf["albedo"], alb)
            shade = torch.where(alive, surf["shading"], shade)
            ior = torch.where(alive, surf["ior"], ior)
            view = torch.where(keep, new_dir, view)
        return pos, nrm, alb, shade, ior, thr, li, alive, view, state, wrote, res_cur

    canonical_idx = py * width + px
    sun_dir_n = ops.normalize(ops.f32(sun_dir, dev))
    if s["dedup_sun_shadow"]:
        wi_sun0 = torch.broadcast_to(sun_dir_n, gb_px["pos"].shape)
        lam0 = gb_px["hit"] & (gb_px["shading"] == SHADING_LAMBERT)
        sun_o0 = _offset_origin(gb_px["pos"], ops.normalize(gb_px["normal"]), wi_sun0, eps_n)
        sun_occ0 = tile(tr.occluded(sun_o0, wi_sun0.contiguous(), active=lam0))
    else:
        sun_occ0 = None
    sample_ids = torch.arange(spp, dtype=torch.int64, device=dev).repeat_interleave(m)
    state = ops.seed_from_index(tile(canonical_idx), width, frame, sample_ids, s["rng_salt"],
                                noise_key)
    li0 = torch.where(gbt["hit"][..., None], torch.zeros_like(miss_sky), miss_sky)
    carry = (gbt["pos"], ops.normalize(gbt["normal"]), gbt["albedo"], gbt["shading"],
             gbt["ior"], torch.ones((n, 3), dtype=torch.float32, device=dev), li0, gbt["hit"],
             view_i, state, torch.zeros((n,), dtype=torch.bool, device=dev),
             res_cur_init.map(tile))
    n_bounce = max(1, s["max_depth"])
    for depth in range(n_bounce):
        carry = bounce(carry, depth, depth == 0, sun_occ0 if depth == 0 else None,
                       sun_dir_n if depth == 0 else None, depth == n_bounce - 1)
    li, wrote, res_vec = carry[6], carry[10], carry[11]

    def sample_slice(x, k):
        return x.reshape(spp, m, *x.shape[1:])[k]

    l_sum = torch.zeros((m, 3), dtype=torch.float32, device=dev)
    for k in range(spp):
        l_sum = l_sum + ops.safe_color(sample_slice(li, k), s["safe_color_max"])
    color = l_sum * (1.0 / float(spp))
    res_cur = res_cur_init
    for k in range(spp):
        mask = sample_slice(wrote, k)
        res_cur = Res(**{f: _rows(mask, sample_slice(getattr(res_vec, f), k),
                                  getattr(res_cur, f)) for f in RES_FIELDS})
    return color, gb_px["obj_id"], res_cur


# ---------------- TAAU ----------------


def _axis_taps(out_size: int, in_size: int, offset: float, device):
    p = np.arange(out_size, dtype=np.float32)
    ratio = np.float32(float(in_size) / float(out_size))
    s = (p + np.float32(0.5)) * ratio - np.float32(0.5)
    if offset:
        s = s + np.float32(offset)
    i1 = np.clip(np.floor(s).astype(np.int32), 0, in_size - 1)
    i2 = np.minimum(i1 + 1, in_size - 1)
    f = s - i1.astype(np.float32)
    tt = f * (np.float32(2.0) - f)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(i1.astype(np.int64)), t(i2.astype(np.int64)), t(tt)


def _nearest_taps(out_size: int, in_size: int, device):
    p = np.arange(out_size, dtype=np.float32)
    ratio = np.float32(float(in_size) / float(out_size))
    s = (p + np.float32(0.5)) * ratio - np.float32(0.5)
    return torch.as_tensor(np.clip(np.round(s).astype(np.int64), 0, in_size - 1), device=device)


def taa_resolve(s: dict, low_color, low_obj, hist_color, hist_obj, hist_valid: bool,
                in_w: int, in_h: int, out_w: int, out_h: int):
    """TAAU: smoothstep taps of the low-res frame in linear light, a 3x3
    neighbourhood clamp of the history, a reset on an object-id change,
    the feedback blend and a light unsharp mask. Returns (out, obj)."""
    low_img = ops.unpack_srgb(ops.to_image(low_color, in_w, in_h))
    dev = low_color.device

    def sample_x(img, offset):
        x1, x2, ttx = _axis_taps(out_w, img.shape[1], offset, dev)
        w = ttx[None, :, None]
        return img[:, x1] * (1.0 - w) + img[:, x2] * w

    def sample_y(img, offset):
        y1, y2, tty = _axis_taps(out_h, img.shape[0], offset, dev)
        w = tty[:, None, None]
        return img[y1] * (1.0 - w) + img[y2] * w

    tx = {ox: sample_x(low_img, ox * 0.5) for ox in (-1, 0, 1)}
    cur = sample_y(tx[0], 0.0)
    nmin, nmax = cur, cur
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            if ox == 0 and oy == 0:
                continue
            c = sample_y(tx[ox], oy * 0.5)
            nmin = torch.minimum(nmin, c)
            nmax = torch.maximum(nmax, c)
    obj_img = ops.to_image(low_obj, in_w, in_h)
    obj = obj_img[_nearest_taps(out_h, in_h, dev)][:, _nearest_taps(out_w, in_w, dev)]
    cur, nmin, nmax, obj = (cur.reshape(-1, 3), nmin.reshape(-1, 3), nmax.reshape(-1, 3),
                            obj.reshape(-1))
    hist = ops.unpack_srgb(hist_color)
    reset = (hist_obj != obj) | (not bool(hist_valid))
    hist_clamped = torch.minimum(torch.maximum(hist, nmin), nmax)
    a = torch.where(reset, 1.0, s["taa_feedback"])
    acc = hist_clamped * (1.0 - a)[..., None] + cur * a[..., None]
    sh = s["taa_sharpness"]
    sharpen = acc * (1.0 + 2.0 * sh) - (nmin + nmax) * (0.5 * sh)
    acc = acc * (1.0 - sh) + sharpen * sh
    return ops.pack_srgb(acc), obj


# ---------------- the frame ----------------


def render_frame(s: dict, tr: Tracer, cam: dict, prev_cam: dict, state: State, frame: int,
                 noise_key: int, sun_dir, accum_reset: bool, out_w: int, out_h: int,
                 lowp_color=None):
    """One frame. `state` is what the previous frame handed on, its
    reservoirs already swapped (this frame reads `res_prev`). Returns
    (presented frame (out_n,) int64 0xAARRGGBB row-major, new state)."""
    if not s["enable_taau"] or s["restir_reference_weighting"] or s["spp_pixel_major"]:
        raise ValueError("the reference frame covers TAAU on, unbiased reuse weights and "
                         "sample-major lanes")
    in_w, in_h = internal_resolution(s, out_w, out_h)
    dev = state.taa_color.device
    gb = primary_visibility(tr, cam, in_w, in_h, dev)
    color, obj_id, res_cur = path_trace(s, tr, gb, cam, prev_cam, state.res_prev,
                                        state.res_cur, frame, noise_key, sun_dir, in_w, in_h)
    if lowp_color is not None:
        color = color.to(lowp_color).to(torch.float32)
    if s["progressive_accumulation"]:
        accum = color if accum_reset else state.accum + color
        count = 1 if accum_reset else state.accum_count + 1
        display = torch.clamp(accum / float(count), 0.0, 1.0)
    else:
        accum, count = state.accum, state.accum_count
        display = torch.clamp(color, 0.0, 1.0)
    low_packed = ops.pack_rgba8(display)
    out, obj = taa_resolve(s, low_packed, obj_id, state.taa_color, state.taa_obj,
                           state.taa_valid, in_w, in_h, out_w, out_h)
    return out, State(res_prev=state.res_prev, res_cur=res_cur, taa_color=out, taa_obj=obj,
                      taa_valid=True, accum=accum, accum_count=count)
