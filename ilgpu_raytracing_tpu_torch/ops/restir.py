"""ReSTIR DI over sky/sun candidates with temporal reprojection and
prev-frame spatial reuse (port of ops/restir.py).

Per lane: 8 cosine-hemisphere sky candidates + 1 sun delta candidate
(mixture pdfs 8/9, 1/9), streaming reservoir updates, temporal import of
the reprojected prev-frame reservoir, 8 spatial imports from the previous
frame's reservoirs (hashed rotation, radius 1-2), Z-counted unbiased
contribution weights (or the reference's exact, biased weighting when
`reference_weighting`), one visibility ray issued by the integrator
(reference RTRay.cs:327-543).
"""

from __future__ import annotations

import dataclasses

import torch

from ilgpu_raytracing_tpu_torch.ops import layout
from ilgpu_raytracing_tpu_torch.ops import sky as sky_ops
from ilgpu_raytracing_tpu_torch.ops.cuda import restir as restir_kernel
from ilgpu_raytracing_tpu_torch.ops.sampling import (
    INV_PI,
    cos_hemisphere_pdf,
    sample_hemisphere_cosine,
)
from ilgpu_raytracing_tpu_torch.utils import rng as rng_mod
from ilgpu_raytracing_tpu_torch.utils import vec

LIGHT_ENV = 1
LIGHT_SUN = 2
EPS_MIN = 1e-6


@dataclasses.dataclass
class Reservoirs:
    """SoA reservoir state, one slot per pixel (RTRay.cs:171-179)."""

    L: torch.Tensor  # (N,3) candidate radiance
    wi: torch.Tensor  # (N,3) candidate direction
    pdf: torch.Tensor  # (N,) selection pdf (mixture)
    w: torch.Tensor  # (N,) winner's target value s_hat(y) (score in ref mode)
    w_sum: torch.Tensor  # (N,) sum of scores
    m: torch.Tensor  # (N,) i32 candidates seen
    light_id: torch.Tensor  # (N,) i32
    W: torch.Tensor  # (N,) unbiased contribution weight wSum/(Z*s_hat)

    @staticmethod
    def empty(n: int, device="cuda") -> "Reservoirs":
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
        zi = lambda: torch.zeros((n,), dtype=torch.int32, device=device)
        return Reservoirs(L=z(n, 3), wi=z(n, 3), pdf=z(n), w=z(n), w_sum=z(n),
                          m=zi(), light_id=zi(), W=z(n))

    def map(self, fn) -> "Reservoirs":
        return Reservoirs(**{k: fn(v) for k, v in vars(self).items()})

    def gather(self, idx: torch.Tensor) -> "Reservoirs":
        """Rows at `idx`, negative ids reading row 0 and ids past the end
        the last row (jnp.take's clip mode)."""
        n = self.m.shape[0]
        safe = torch.clamp(idx.long(), 0, n - 1)
        return self.map(lambda a: a[safe])

    def replace(self, **kw) -> "Reservoirs":
        return dataclasses.replace(self, **kw)


def where_rows(mask, a, b):
    """torch.where with a per-lane mask broadcast over trailing row dims."""
    return torch.where(mask[..., None] if a.dim() > mask.dim() else mask, a, b)


def reservoir_update(res: Reservoirs, state, wi, pdf_sel, li, score, s_hat,
                     light_id, mask):
    """Masked streaming update (RTRay.cs:393-405). Returns (state, res).
    `score` drives selection and sums into w_sum; `s_hat` is what the `w`
    slot records for the winner."""
    zero = torch.zeros_like(score)
    add = torch.where(mask, score, zero)
    new_sum = res.w_sum + add
    accept_p = torch.where(
        new_sum > 0.0, add / torch.clamp(new_sum, min=EPS_MIN), zero
    )
    state, u = rng_mod.next_float(state)
    take = mask & (u < accept_p)
    if not isinstance(light_id, torch.Tensor):
        light_id = torch.full_like(res.m, int(light_id))
    return state, Reservoirs(
        L=where_rows(take, li, res.L),
        wi=where_rows(take, wi, res.wi),
        pdf=torch.where(take, pdf_sel, res.pdf),
        w=torch.where(take, s_hat, res.w),
        w_sum=torch.where(mask, new_sum, res.w_sum),
        m=res.m + mask.to(torch.int32),
        light_id=torch.where(take, light_id, res.light_id),
        W=res.W,
    )


def reproject_to_prev_pixel(pos, prev_cam, width: int, height: int):
    """World point -> prev-frame array position or -1 (RTRay.cs:338-360),
    in the frame's block-linear layout."""
    f = lambda x: torch.as_tensor(x, dtype=torch.float32, device=pos.device)
    p = pos - f(prev_cam.origin)
    x = vec.dot(p, f(prev_cam.right))
    y = vec.dot(p, f(prev_cam.up))
    z = vec.dot(p, f(prev_cam.forward))
    ok = z > 1e-4
    z_safe = torch.where(ok, z, torch.ones_like(z))
    tan_half = torch.tan(0.5 * f(prev_cam.fov_y))
    ndc_x = x / (z_safe * tan_half * f(prev_cam.aspect))
    ndc_y = y / (z_safe * tan_half)
    fx = 0.5 * (ndc_x + 1.0) * width
    fy = 0.5 * (ndc_y + 1.0) * height
    px = torch.floor(fx).to(torch.int32)
    py = torch.floor(fy).to(torch.int32)
    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    idx = layout.position_from_xy(px, py, width, height)
    return torch.where(ok & inside, idx, -1).to(torch.int32)


def _pack_reservoirs(res: Reservoirs) -> torch.Tensor:
    """(N,12) rows: L wi pdf w w_sum m light_id W (ints as exact floats)."""
    return torch.cat(
        [res.L, res.wi, res.pdf[:, None], res.w[:, None], res.w_sum[:, None],
         res.m.to(torch.float32)[:, None], res.light_id.to(torch.float32)[:, None],
         res.W[:, None]],
        dim=1,
    )


def _pack_gbuffer(gb) -> torch.Tensor:
    """(N,7) rows: pos(3) normal(3) obj_id (exact small float)."""
    return torch.cat([gb.pos, gb.normal, gb.obj_id.to(torch.float32)[:, None]], dim=1)


def _import_from_prev(res, state, res_packed, gb_packed, own_obj, own_z,
                      prev_idx, mask, cam_origin, n, albedo, mix_local,
                      mix_delta, sun_radiance, sky_top, sky_bottom,
                      reference_weighting: bool):
    """Import + re-score the prev-frame reservoir at array position
    prev_idx (temporal reprojection), one fused row gather."""
    n_res = res_packed.shape[0]
    valid = mask & (prev_idx >= 0) & (prev_idx < n_res)
    both = torch.cat([res_packed, gb_packed], dim=1)
    rows = both[prev_idx.long().clamp(0, n_res - 1)]
    return _import_rows(
        res, state, rows[:, :12], rows[:, 12:], valid, own_obj, own_z,
        cam_origin, n, albedo, mix_local, mix_delta, sun_radiance, sky_top,
        sky_bottom, reference_weighting,
    )


def _import_rows(res, state, row, gbr, valid, own_obj, own_z, cam_origin, n,
                 albedo, mix_local, mix_delta, sun_radiance, sky_top,
                 sky_bottom, reference_weighting: bool):
    """Re-score + merge pre-fetched packed rows (compatibility test
    RTRay.cs:362-374 with the own-pixel side precomputed)."""
    obj_b = gbr[:, 6].to(torch.int32)
    n_b = vec.normalize(gbr[:, 3:6])
    z_b = vec.length(gbr[:, 0:3] - cam_origin)
    ndot = vec.dot(n, n_b)
    rel = torch.abs(own_z - z_b) / torch.clamp(own_z, min=1e-3)
    compatible = (own_obj == obj_b) | ((ndot >= 0.85) & (rel < 0.05))
    valid = valid & compatible

    pr = Reservoirs(
        L=row[:, 0:3], wi=row[:, 3:6], pdf=row[:, 6], w=row[:, 7],
        w_sum=row[:, 8], m=row[:, 9].to(torch.int32),
        light_id=row[:, 10].to(torch.int32), W=row[:, 11],
    )
    valid = valid & (pr.m > 0) & (pr.w > 0.0) & (pr.w_sum > 0.0)
    if not reference_weighting:
        valid = valid & (pr.W > 0.0)

    wi = pr.wi
    is_sun = pr.light_id == LIGHT_SUN
    sun_l = torch.as_tensor(sun_radiance, dtype=torch.float32, device=wi.device)
    li = torch.where(
        is_sun[..., None], sun_l, sky_ops.sky_radiance(wi, sky_top, sky_bottom)
    )
    nl = torch.clamp(vec.dot(n, wi), min=0.0)
    pdf_here = torch.where(
        is_sun,
        torch.full_like(nl, max(EPS_MIN, mix_delta)),
        torch.clamp(cos_hemisphere_pdf(n, wi) * mix_local, min=EPS_MIN),
    )
    if reference_weighting:
        w_src = pr.w_sum / (
            torch.clamp(pr.m, min=1).to(torch.float32)
            * torch.clamp(pr.w, min=EPS_MIN)
        )
        s_here = vec.luminance(albedo * li * ((nl / pdf_here) * INV_PI)[..., None])
        eff = s_here * w_src
        s_hat = eff
    else:
        s_hat = vec.luminance(albedo * li * (nl * INV_PI)[..., None])
        eff = s_hat * pr.W
    lid = torch.where(is_sun, LIGHT_SUN, LIGHT_ENV).to(torch.int32)
    state, res = reservoir_update(res, state, wi, pdf_here, li, eff, s_hat, lid, valid)
    return state, res, n_b, valid


# 8-neighborhood base patterns (RTRay.cs:376-391); per pixel the pattern is
# rotated by a hashed rot in {0..3} and scaled by radius in {1,2}
_NEIGHBOR_BASE = ((-1, 0), (1, 0), (0, -1), (0, 1),
                  (-1, -1), (1, -1), (-1, 1), (1, 1))


def _rotate_offset(cx: int, cy: int, ro: int):
    if ro == 0:
        return cx, cy
    if ro == 1:
        return -cy, cx
    if ro == 2:
        return -cx, -cy
    return cy, -cx


def _spatial_row_fetcher(res_packed, gb_packed, width: int, height: int, frame):
    """Gather-free spatial neighbor rows: every (slot, rot, radius) variant
    is a static 2D shift of the packed-row image, so each slot selects
    among 8 shifted views by each pixel's hashed rot/radius. Out-of-bounds
    or unselected rows are zero (m == 0 fails the import gate).

    Returns fetch(slot, pixel_idx) -> (rows12, rows7) for those positions."""
    dev = res_packed.device
    arr = torch.cat([res_packed, gb_packed], dim=1)  # (N,19)
    c = arr.shape[1]
    img = layout.to_image(arr, width, height)
    pad = torch.zeros((height + 4, width + 4, c), dtype=arr.dtype, device=dev)
    pad[2:2 + height, 2:2 + width] = img
    xs = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    ys = torch.arange(height, dtype=torch.int64, device=dev)[:, None]
    fh = rng_mod.hash32(
        rng_mod.u32(int(frame), dev) ^ rng_mod.hash32(rng_mod.u32(0xB31F5AB1, dev))
    )
    h = rng_mod.hash32(rng_mod.u32(ys * width + xs) ^ fh)
    rot = (h & 3).to(torch.int32)
    rad = 1 + ((h >> 2) & 1).to(torch.int32)

    def fetch(slot: int, pixel_idx):
        cx, cy = _NEIGHBOR_BASE[slot]
        sel = torch.zeros((height, width, c), dtype=arr.dtype, device=dev)
        for ro in range(4):
            rcx, rcy = _rotate_offset(cx, cy, ro)
            for ra in (1, 2):
                dx, dy = rcx * ra, rcy * ra
                shifted = pad[2 + dy: 2 + dy + height, 2 + dx: 2 + dx + width]
                inb = ((xs + dx >= 0) & (xs + dx < width)
                       & (ys + dy >= 0) & (ys + dy < height))
                m = (rot == ro) & (rad == ra) & inb
                sel = torch.where(m[..., None], shifted, sel)
        chunk = layout.from_image(sel)[pixel_idx.long()]
        return chunk[:, :12], chunk[:, 12:]

    return fetch


def restir_direct(
    scene_unused, gb, res_prev: Reservoirs, state, active, pos, n, albedo,
    pixel_idx, width: int, height: int, frame, prev_cam, cam_origin, sun_dir,
    sun_radiance, sky_top, sky_bottom, enable_temporal, enable_spatial,
    local_candidates: int = 8, delta_candidates: int = 1,
    static_reuse: bool = True, reference_weighting: bool = False,
    reps: int = 1, reps_pixel_major: bool = False,
):
    """Candidate generation + reuse + selection (RTRay.cs:437-516).

    Returns (state, res, sel); `sel` carries the selected sample's shading
    quantities and the caller traces its single visibility ray. `reps`
    declares the batch as `reps` stacked sample views of the same pixels
    (pixel_idx expanded to match), so spatial rows are fetched once per
    pixel and expanded: stacked sample tiles ([tile0; tile1; ...]) by
    default, a pixel's samples adjacent with `reps_pixel_major` (the
    integrator's lane layout, config.spp_pixel_major). `frame` is the host
    frame index.

    On CUDA tensors this is `restir_direct_kernel`, elsewhere
    `restir_direct_plain`; the two are equal bit for bit on the card."""
    fn = restir_direct_kernel if pos.device.type == "cuda" else restir_direct_plain
    return fn(
        scene_unused, gb, res_prev, state, active, pos, n, albedo, pixel_idx, width,
        height, frame, prev_cam, cam_origin, sun_dir, sun_radiance, sky_top,
        sky_bottom, enable_temporal, enable_spatial, local_candidates,
        delta_candidates, static_reuse, reference_weighting, reps, reps_pixel_major,
    )


def restir_direct_kernel(
    scene_unused, gb, res_prev: Reservoirs, state, active, pos, n, albedo,
    pixel_idx, width: int, height: int, frame, prev_cam, cam_origin, sun_dir,
    sun_radiance, sky_top, sky_bottom, enable_temporal, enable_spatial,
    local_candidates: int = 8, delta_candidates: int = 1,
    static_reuse: bool = True, reference_weighting: bool = False,
    reps: int = 1, reps_pixel_major: bool = False,
):
    """`restir_direct` as one launch of csrc/restir.cu (ops/cuda/restir.py)."""
    total = local_candidates + delta_candidates
    state, fields, ok, contrib, is_sun = restir_kernel.launch(
        gb, res_prev, state, active, pos, n, albedo, pixel_idx, width, height,
        frame, prev_cam, cam_origin, sun_dir, sun_radiance, sky_top, sky_bottom,
        enable_temporal, enable_spatial, local_candidates,
        float(local_candidates) / float(total),
        max(EPS_MIN, float(delta_candidates) / float(total)), static_reuse,
        reference_weighting, reps, reps_pixel_major,
    )
    res = Reservoirs(*fields)
    return state, res, dict(ok=ok, wi=res.wi, contrib=contrib, is_sun=is_sun)


def restir_direct_plain(
    scene_unused, gb, res_prev: Reservoirs, state, active, pos, n, albedo,
    pixel_idx, width: int, height: int, frame, prev_cam, cam_origin, sun_dir,
    sun_radiance, sky_top, sky_bottom, enable_temporal, enable_spatial,
    local_candidates: int = 8, delta_candidates: int = 1,
    static_reuse: bool = True, reference_weighting: bool = False,
    reps: int = 1, reps_pixel_major: bool = False,
):
    """`restir_direct` in PyTorch operations, on any device: the CPU path and
    the definition the kernel is held to."""
    total = local_candidates + delta_candidates
    mix_local = float(local_candidates) / float(total)
    mix_delta = float(delta_candidates) / float(total)
    dev = pos.device

    res = Reservoirs.empty(pos.shape[0], dev)

    # (1) local BRDF/env candidates
    for _ in range(local_candidates):
        state, wi = sample_hemisphere_cosine(n, state)
        nl = torch.clamp(vec.dot(n, wi), min=0.0)
        pdf_local = torch.clamp(cos_hemisphere_pdf(n, wi), min=EPS_MIN)
        pdf_sel = torch.clamp(pdf_local * mix_local, min=EPS_MIN)
        li = sky_ops.sky_radiance(wi, sky_top, sky_bottom)
        s_hat = vec.luminance(albedo * li * (nl * INV_PI)[..., None])
        s = s_hat / pdf_sel
        state, res = reservoir_update(
            res, state, wi, pdf_sel, li, s,
            s if reference_weighting else s_hat, LIGHT_ENV, active,
        )

    # (2) directional sun delta candidate
    wi_sun = torch.broadcast_to(
        vec.normalize(torch.as_tensor(sun_dir, dtype=torch.float32, device=dev)),
        pos.shape,
    )
    nl = torch.clamp(vec.dot(n, wi_sun), min=0.0)
    pdf_sel = torch.full_like(nl, max(EPS_MIN, mix_delta))
    li_sun = torch.broadcast_to(
        torch.as_tensor(sun_radiance, dtype=torch.float32, device=dev), pos.shape
    )
    s_hat = vec.luminance(albedo * li_sun * (nl * INV_PI)[..., None])
    s = s_hat / pdf_sel
    state, res = reservoir_update(
        res, state, wi_sun, pdf_sel, li_sun, s,
        s if reference_weighting else s_hat, LIGHT_SUN, active,
    )

    imports = []  # (src_normal, accepted-into-stream mask) per import
    if static_reuse:
        res_packed = _pack_reservoirs(res_prev)
        gb_packed = _pack_gbuffer(gb)
        m_px = pos.shape[0] // max(1, reps)
        if reps > 1 and reps_pixel_major:
            px_rows = pixel_idx[::reps]

            def expand(x):
                return x.repeat_interleave(reps, dim=0)
        else:
            px_rows = pixel_idx[:m_px]

            def expand(x):
                return x.repeat(reps, 1) if reps > 1 else x
        own_px = px_rows.long()
        own_sl = expand(torch.cat(
            [gb.pos[own_px], gb.obj_id[own_px].to(torch.float32)[:, None]], dim=1
        ))
        own_obj = own_sl[:, 3].to(torch.int32)
        own_z = vec.length(own_sl[:, 0:3] - cam_origin)

        # (3) temporal reuse via camera reprojection
        prev_idx = reproject_to_prev_pixel(pos, prev_cam, width, height)
        state, res, n_b, vld = _import_from_prev(
            res, state, res_packed, gb_packed, own_obj, own_z, prev_idx,
            active & enable_temporal, cam_origin, n, albedo, mix_local,
            mix_delta, sun_radiance, sky_top, sky_bottom, reference_weighting,
        )
        imports.append((n_b, vld))

        # (4) spatial reuse: 8 prev-frame neighbors (hash keyed on the
        # canonical pixel id, so noise is layout-invariant)
        fetch = _spatial_row_fetcher(res_packed, gb_packed, width, height, frame)
        for slot in range(len(_NEIGHBOR_BASE)):
            row12, gbr7 = fetch(slot, px_rows)
            row12, gbr7 = expand(row12), expand(gbr7)
            state, res, n_b, vld = _import_rows(
                res, state, row12, gbr7, active & enable_spatial, own_obj,
                own_z, cam_origin, n, albedo, mix_local, mix_delta,
                sun_radiance, sky_top, sky_bottom, reference_weighting,
            )
            imports.append((n_b, vld))

    # (5) selection shading (visibility applied by the caller)
    ok = active & (res.m > 0) & (res.w_sum > 0.0) & (res.w > 0.0)
    wi_sel = res.wi
    is_sun = res.light_id == LIGHT_SUN
    nl_sel = torch.clamp(vec.dot(n, wi_sel), min=0.0)
    ok = ok & (nl_sel > 0.0)
    sun_l = torch.as_tensor(sun_radiance, dtype=torch.float32, device=dev)
    li_sel = torch.where(
        is_sun[..., None], sun_l, sky_ops.sky_radiance(wi_sel, sky_top, sky_bottom)
    )
    if reference_weighting:
        z_count = torch.clamp(res.m, min=1).to(torch.float32)
    else:
        # Z-counting: discount accepted imports whose source could not have
        # produced the winner (winner below the source's horizon)
        z_sub = torch.zeros_like(res.w_sum)
        for n_src, vld in imports:
            z_sub = z_sub + (vld & (vec.dot(n_src, wi_sel) <= 0.0)).to(torch.float32)
        z_count = torch.clamp(res.m.to(torch.float32) - z_sub, min=1.0)
    w_ucw = res.w_sum / z_count / torch.clamp(res.w, min=EPS_MIN)
    res = res.replace(W=torch.where(ok, w_ucw, torch.zeros_like(w_ucw)))
    if reference_weighting:
        pdf_sel = torch.where(
            is_sun,
            torch.full_like(nl_sel, max(EPS_MIN, mix_delta)),
            torch.clamp(cos_hemisphere_pdf(n, wi_sel) * mix_local, min=EPS_MIN),
        )
        f_sel = albedo * li_sel * ((nl_sel / pdf_sel) * INV_PI)[..., None]
    else:
        f_sel = albedo * li_sel * (nl_sel * INV_PI)[..., None]
    contrib = f_sel * w_ucw[..., None]
    return state, res, dict(ok=ok, wi=wi_sel, contrib=contrib, is_sun=is_sun)
