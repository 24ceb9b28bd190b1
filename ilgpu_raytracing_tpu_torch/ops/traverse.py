"""Ray traversal over the two-level BVH and deferred hit shading (port of
ops/traverse.py).

The per-lane skip-index walk of the reference contract,
`next = hit ? (leaf ? skip : left) : skip` (SceneDeviceViews.cs:33-85),
run for every lane at once: each loop step gathers one node per lane and
tests up to `blas_leaf_max` leaf slots. Lanes that walk off the tree leave
the working set each step, so a step costs only the lanes still walking
(per-lane results do not depend on that bookkeeping). This is the plain
version of the wide closest-hit and any-hit kernels (ops/cuda/wide.py) and
the tracer the JAX package itself uses off-TPU. On a scene with alpha
cutouts the leaf test applies the masks in the loop (`_tri_alpha_pass`),
which makes this walk the oracle of the peel in ops/alpha.py.

Parametric t transfers 1:1 between world and object space (rays are
transformed with the unnormalized linear part); the reference's
uniform-scale division is deliberately not reproduced.
"""

from __future__ import annotations

import dataclasses

import torch

from ilgpu_raytracing_tpu_torch.models.scene import SceneData
from ilgpu_raytracing_tpu_torch.ops import texture as tex_ops
from ilgpu_raytracing_tpu_torch.ops.intersect import (
    T_EPS,
    T_HIT_MAX,
    T_INF,
    intersect_aabb,
    intersect_sphere,
    intersect_triangle,
)
from ilgpu_raytracing_tpu_torch.ops.texture import take
from ilgpu_raytracing_tpu_torch.utils import vec

KIND_MISS = 0
KIND_SPHERE = 1
KIND_TRI = 2


@dataclasses.dataclass
class HitRecord:
    t: torch.Tensor  # (N,) world-space t, T_INF on miss
    kind: torch.Tensor  # (N,) i32
    prim: torch.Tensor  # (N,) i32: sphere id or global tri id
    inst: torch.Tensor  # (N,) i32: combined instance index
    bu: torch.Tensor  # (N,)
    bv: torch.Tensor  # (N,)

    @property
    def hit(self) -> torch.Tensor:
        return self.t < T_HIT_MAX


def _leaf_test(scene: SceneData, kind: int, slot, o, d):
    """Intersect the prim in indirection slot `slot`; returns
    (prim, ok, t, bu, bv) -- bu/bv zero for spheres."""
    if kind == KIND_SPHERE:
        prim = take(scene.sphere_prim_idx, slot)
        ok, t, _n = intersect_sphere(
            o, d, take(scene.sph_center, prim), take(scene.sph_radius, prim)
        )
        z = torch.zeros_like(t)
        return prim, ok, t, z, z
    prim = take(scene.tri_prim_idx, slot)
    ok, t, bu, bv = intersect_triangle(
        o, d, take(scene.tri_v0, prim), take(scene.tri_e1, prim),
        take(scene.tri_e2, prim),
    )
    return prim, ok & (t > T_EPS), t, bu, bv


def _tri_alpha_pass(scene: SceneData, prim, bu, bv, closest: bool):
    """Alpha-cutout acceptance of a candidate triangle hit (True = the
    surface is opaque here).

    closest=True: bilinear mask against the cutoff
    (SceneDeviceViews.cs:209-218). closest=False (any-hit): the +-0.10
    point-sample band, the bilinear sample deciding only inside the band
    (SceneDeviceViews.cs:297-315)."""
    mat = take(scene.tri_mat, prim)
    atex = take(scene.mat_alpha_tex, mat)
    cutoff = take(scene.mat_alpha_cutoff, mat)
    has_map = atex >= 0
    w = 1.0 - bu - bv
    uv0 = take(scene.tri_uv0, prim)
    uv1 = take(scene.tri_uv1, prim)
    uv2 = take(scene.tri_uv2, prim)
    uu = uv0[..., 0] * w + uv1[..., 0] * bu + uv2[..., 0] * bv
    vv = uv0[..., 1] * w + uv1[..., 1] * bu + uv2[..., 1] * bv
    if closest:
        a = tex_ops.sample_mask_bilinear(scene, atex, uu, vv)
        return torch.where(has_map, a >= cutoff, torch.ones_like(has_map))
    band = 0.10
    a_pt = tex_ops.sample_mask_point(scene, atex, uu, vv)
    sure_reject = a_pt < cutoff - band
    sure_accept = a_pt >= cutoff + band
    a_lin = tex_ops.sample_mask_bilinear(scene, atex, uu, vv)
    in_band = (~sure_reject) & (~sure_accept)
    ok = sure_accept | (in_band & (a_lin >= cutoff))
    return torch.where(has_map, ok, torch.ones_like(has_map))


def _blas_walk(scene: SceneData, o_obj, d_obj, start_cur, t_max0, kind: int,
               any_hit: bool):
    """BLAS skip-index walk for one instance over all lanes.

    any_hit=False -> (t_obj, prim, bu, bv): closest hit in object space
      (T_INF when none), pruned against t_max0.
    any_hit=True  -> occluded mask: any accepted hit with t < t_max0.
    On an alpha scene a triangle hit counts only where `_tri_alpha_pass`
    accepts it (the closest-hit rule, or the any-hit band)."""
    n = o_obj.shape[0]
    dev = o_obj.device
    inv_obj = vec.inv_dir(d_obj)
    leaf_max = scene.blas_leaf_max
    alpha = scene.has_alpha and kind == KIND_TRI

    if any_hit:
        state = [torch.zeros((n,), dtype=torch.bool, device=dev)]
    else:
        state = [
            torch.minimum(torch.full((n,), T_INF, device=dev), t_max0),
            torch.full((n,), -1, dtype=torch.int32, device=dev),
            torch.zeros((n,), device=dev),
            torch.zeros((n,), device=dev),
        ]
    out = [s.clone() for s in state]

    lanes = torch.nonzero(start_cur >= 0).squeeze(1)
    cur = start_cur[lanes]
    o, d, inv, tlim = o_obj[lanes], d_obj[lanes], inv_obj[lanes], t_max0[lanes]
    live = [s[lanes] for s in state]
    while lanes.numel() > 0:
        bmin = scene.blas_bmin[cur]
        bmax = scene.blas_bmax[cur]
        ifl = scene.blas_ifields[cur]
        left, first, count, skip = ifl[:, 0], ifl[:, 1], ifl[:, 2], ifl[:, 3]
        bound = tlim if any_hit else live[0]
        hit_box = intersect_aabb(o, inv, bmin, bmax, T_EPS, bound)
        is_leaf = count > 0

        sub = torch.nonzero(hit_box & is_leaf).squeeze(1)
        if sub.numel() > 0:
            # every slot of the hit leaves in one batch of (lanes, leaf_max)
            # elementwise tests, folded in slot order below
            k = sub.numel()
            slots = torch.arange(leaf_max, device=dev)
            prim, ok, t, bu, bv = _leaf_test(
                scene, kind, (first[sub, None] + slots).reshape(-1),
                o[sub].repeat_interleave(leaf_max, 0),
                d[sub].repeat_interleave(leaf_max, 0))
            if alpha:
                ok = ok & _tri_alpha_pass(scene, prim, bu, bv, closest=not any_hit)
            prim, ok, t, bu, bv = (x.reshape(k, leaf_max) for x in (prim, ok, t, bu, bv))
            valid = (slots < count[sub, None]) & ok & (t > T_EPS)
            if any_hit:
                live[0][sub] = live[0][sub] | (valid & (t < tlim[sub, None])).any(dim=1)
            else:
                # slot order with a strict `<`: the first slot holding the
                # leaf's least t, kept where it beats the lane's best so far
                t = torch.where(valid, t, T_INF)
                t_min = t.amin(dim=1, keepdim=True)
                i = torch.where(t == t_min, slots, leaf_max).amin(dim=1, keepdim=True)
                t_best = live[0][sub]
                accept = t_min[:, 0] < t_best
                for s, v in zip(live, (t_min, prim.gather(1, i), bu.gather(1, i),
                                       bv.gather(1, i))):
                    s[sub] = torch.where(accept, v[:, 0], s[sub])

        nxt = torch.where(hit_box, torch.where(is_leaf, skip, left), skip)
        if any_hit:
            nxt = torch.where(live[0], torch.full_like(nxt, -1), nxt)
        done = nxt < 0
        fin = torch.nonzero(done).squeeze(1)
        if fin.numel() == 0:
            cur = nxt
            continue
        for s_out, s in zip(out, live):
            s_out[lanes[fin]] = s[fin]
        keep = torch.nonzero(~done).squeeze(1)
        lanes, cur = lanes[keep], nxt[keep]
        o, d, inv, tlim = o[keep], d[keep], inv[keep], tlim[keep]
        live = [s[keep] for s in live]

    if any_hit:
        return out[0]
    t_obj, prim, bu, bv = out
    # lanes that only hit the seeded prune limit are misses
    t_obj = torch.where(prim >= 0, t_obj, torch.full_like(t_obj, T_INF))
    return t_obj, prim, bu, bv


def _instances(scene: SceneData):
    """(instance id, kind) in the JAX scan order: spheres, then meshes."""
    return [(i, KIND_SPHERE) for i in scene.sph_instances.tolist()] + [
        (i, KIND_TRI) for i in scene.tri_instances.tolist()
    ]


def trace_closest(scene: SceneData, o: torch.Tensor, d: torch.Tensor,
                  active=None) -> HitRecord:
    """Closest-hit world trace (deferred shading). `active` masks lanes off
    (they return miss and take no traversal steps)."""
    n = o.shape[0]
    dev = o.device
    inv_d = vec.inv_dir(d)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    best = HitRecord(
        t=torch.full((n,), T_INF, device=dev),
        kind=torch.zeros((n,), dtype=torch.int32, device=dev),
        prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        inst=torch.full((n,), -1, dtype=torch.int32, device=dev),
        bu=torch.zeros((n,), device=dev),
        bv=torch.zeros((n,), device=dev),
    )
    roots = scene.inst_blas_root.tolist()
    for inst, kind in _instances(scene):
        enter = active & intersect_aabb(
            o, inv_d, scene.inst_bmin[inst], scene.inst_bmax[inst], T_EPS, best.t
        )
        w2o = scene.inst_w2o[inst]
        o_obj = vec.transform_point(w2o, o)
        d_obj = vec.transform_vector(w2o, d)
        start = torch.where(enter, roots[inst], -1).to(torch.int32)
        t_max_obj = torch.where(enter, best.t, torch.zeros_like(best.t))
        t_obj, prim, bu, bv = _blas_walk(
            scene, o_obj, d_obj, start, t_max_obj, kind, any_hit=False
        )
        better = (t_obj < T_HIT_MAX) & (t_obj < best.t)
        best = HitRecord(
            t=torch.where(better, t_obj, best.t),
            kind=torch.where(better, kind, best.kind).to(torch.int32),
            prim=torch.where(better, prim, best.prim),
            inst=torch.where(better, inst, best.inst).to(torch.int32),
            bu=torch.where(better, bu, best.bu),
            bv=torch.where(better, bv, best.bv),
        )
    return best


def shadow_occlusion(scene: SceneData, o: torch.Tensor, d: torch.Tensor,
                     t_max_world, active=None) -> torch.Tensor:
    """Any-hit occlusion (SceneDeviceViews.cs:88-121). Returns bool (N,).
    `t_max_world` is a scalar or a per-lane (N,) tensor."""
    n = o.shape[0]
    dev = o.device
    inv_d = vec.inv_dir(d)
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max_world, dtype=torch.float32, device=dev), (n,)
    ).contiguous()
    occluded = torch.zeros((n,), dtype=torch.bool, device=dev)
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    roots = scene.inst_blas_root.tolist()
    for inst, kind in _instances(scene):
        enter = active & (~occluded) & intersect_aabb(
            o, inv_d, scene.inst_bmin[inst], scene.inst_bmax[inst], T_EPS, t_max
        )
        w2o = scene.inst_w2o[inst]
        o_obj = vec.transform_point(w2o, o)
        d_obj = vec.transform_vector(w2o, d)
        start = torch.where(enter, roots[inst], -1).to(torch.int32)
        occluded = occluded | _blas_walk(
            scene, o_obj, d_obj, start, t_max, kind, any_hit=True
        )
    return occluded


# ---------------- deferred hit shading ----------------


@dataclasses.dataclass
class Surface:
    pos: torch.Tensor  # (N,3) world hit position
    normal: torch.Tensor  # (N,3) world shading normal
    albedo: torch.Tensor  # (N,3)
    shading: torch.Tensor  # (N,) i32 (lambert/mirror/glass)
    ior: torch.Tensor  # (N,)
    obj_id: torch.Tensor  # (N,) i32 disocclusion key: tri id or -1


def _shade_tables(scene: SceneData):
    """Per-prim attribute rows, one gather per prim class:
    tri row (19): e1 e2 kd dtex two_sided shading ior uv0 uv1 uv2;
    sph row (10): center radius base_albedo dtex shading ior;
    inst row (24): w2o(12) o2w(12)."""
    mkd = scene.mat_kd
    tmat = scene.tri_mat
    f = lambda a: a.to(torch.float32)[:, None]
    tri = torch.cat(
        [
            scene.tri_e1, scene.tri_e2, take(mkd, tmat),
            f(take(scene.mat_diffuse_tex, tmat)),
            f(take(scene.mat_two_sided, tmat)),
            f(take(scene.mat_shading, tmat)),
            take(scene.mat_ior, tmat)[:, None],
            scene.tri_uv0, scene.tri_uv1, scene.tri_uv2,
        ],
        dim=1,
    )
    smat = scene.sph_mat
    s_kd = take(mkd, smat)
    kd_zero = torch.all(s_kd == 0.0, dim=-1)
    s_base = torch.where(kd_zero[..., None], scene.sph_albedo, s_kd)
    sph = torch.cat(
        [
            scene.sph_center, scene.sph_radius[:, None], s_base,
            f(take(scene.mat_diffuse_tex, smat)),
            f(scene.sph_shading), scene.sph_ior[:, None],
        ],
        dim=1,
    )
    ni = scene.inst_w2o.shape[0]
    inst = torch.cat(
        [scene.inst_w2o.reshape(ni, -1), scene.inst_o2w.reshape(ni, -1)], dim=1
    )
    return tri, sph, inst


def shade_hits(scene: SceneData, hit: HitRecord, o: torch.Tensor,
               d: torch.Tensor) -> Surface:
    """Resolve hit records to surface attributes (the reference's per-hit
    attribute rules, SceneDeviceViews.cs:146-158, 208-222; obj_id keeps the
    reference quirk: global tri index for meshes, -1 for spheres)."""
    n = o.shape[0]
    is_sph = hit.kind == KIND_SPHERE
    is_tri = hit.kind == KIND_TRI
    prim = torch.clamp(hit.prim, min=0)
    inst = torch.clamp(hit.inst, min=0)

    tri_tab, sph_tab, inst_tab = _shade_tables(scene)
    trow = take(tri_tab, prim)
    srow = take(sph_tab, prim)
    irow = take(inst_tab, inst)

    pos_w = o + d * hit.t[..., None]
    w2o = irow[:, 0:12].reshape(n, 3, 4)
    o2w = irow[:, 12:24].reshape(n, 3, 4)
    d_obj = vec.transform_vector(w2o, d)

    # --- sphere attributes ---
    c = srow[:, 0:3]
    p_obj = vec.transform_point(w2o, pos_w)
    n_sph_obj = vec.normalize(p_obj - c)
    sph_base = srow[:, 4:7]
    sph_dtex = srow[:, 7].to(torch.int32)
    su = 0.5 + torch.atan2(n_sph_obj[..., 2], n_sph_obj[..., 0]) / (2.0 * torch.pi)
    sv = torch.arccos(torch.clamp(n_sph_obj[..., 1], -1.0, 1.0)) / torch.pi
    sph_texc = tex_ops.sample_texture_bilinear(scene, sph_dtex, su, sv)
    sph_albedo = torch.where((sph_dtex >= 0)[..., None], sph_texc, sph_base)
    sph_shading = srow[:, 8].to(torch.int32)
    sph_ior_raw = srow[:, 9]
    sph_ior = torch.where(sph_ior_raw > 0.0, sph_ior_raw, torch.ones_like(sph_ior_raw))

    # --- triangle attributes ---
    e1 = trow[:, 0:3]
    e2 = trow[:, 3:6]
    n_tri_obj = vec.normalize(vec.cross(e1, e2))
    two_sided = trow[:, 10] != 0.0
    flip = two_sided & (vec.dot(n_tri_obj, d_obj) > 0.0)
    n_tri_obj = torch.where(flip[..., None], -n_tri_obj, n_tri_obj)
    wgt = 1.0 - hit.bu - hit.bv
    uv0 = trow[:, 13:15]
    uv1 = trow[:, 15:17]
    uv2 = trow[:, 17:19]
    uu = uv0[..., 0] * wgt + uv1[..., 0] * hit.bu + uv2[..., 0] * hit.bv
    vv = uv0[..., 1] * wgt + uv1[..., 1] * hit.bu + uv2[..., 1] * hit.bv
    t_kd = trow[:, 6:9]
    t_dtex = trow[:, 9].to(torch.int32)
    t_texc = tex_ops.sample_texture_bilinear(scene, t_dtex, uu, vv)
    tri_albedo = torch.where((t_dtex >= 0)[..., None], t_texc, t_kd)
    tri_shading = trow[:, 11].to(torch.int32)
    tri_ior_raw = trow[:, 12]
    tri_ior = torch.where(tri_ior_raw > 0.0, tri_ior_raw, torch.ones_like(tri_ior_raw))

    n_obj = torch.where(is_sph[..., None], n_sph_obj, n_tri_obj)
    normal_w = vec.normalize(vec.transform_vector(o2w, n_obj))

    albedo = torch.where(is_sph[..., None], sph_albedo, tri_albedo)
    shading = torch.where(is_sph, sph_shading, tri_shading)
    ior = torch.where(is_sph, sph_ior, tri_ior)
    obj_id = torch.where(is_tri, hit.prim, -1).to(torch.int32)

    miss = ~hit.hit
    up = torch.tensor([0.0, 1.0, 0.0], dtype=o.dtype, device=o.device)
    return Surface(
        pos=torch.where(miss[..., None], o + d * 1e6, pos_w),
        normal=torch.where(miss[..., None], up, normal_w),
        albedo=torch.where(miss[..., None], torch.zeros_like(albedo), albedo),
        shading=torch.where(miss, -1, shading).to(torch.int32),
        ior=torch.where(miss, torch.ones_like(ior), ior),
        obj_id=torch.where(miss, -1, obj_id).to(torch.int32),
    )
