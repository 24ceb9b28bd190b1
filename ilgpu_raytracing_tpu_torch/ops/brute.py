"""Brute-force reference tracer: intersect every primitive, no BVH (port
of ops/brute.py).

The oracle the BVH walks are held to (SURVEY.md section 4: "BVH traversal
vs brute-force all-prims reference"). It applies the instance transforms
(parametric t transfers 1:1, see ops/traverse.py), the sphere near/far
choice and the closest-hit alpha-cutout rule. O(rays x prims): test-scale
scenes only.
"""

from __future__ import annotations

import torch

from ilgpu_raytracing_tpu_torch.models.scene import SceneData
from ilgpu_raytracing_tpu_torch.ops.intersect import (
    T_EPS,
    T_INF,
    intersect_sphere,
    intersect_triangle,
)
from ilgpu_raytracing_tpu_torch.ops.traverse import (
    KIND_SPHERE,
    KIND_TRI,
    HitRecord,
    _instances,
    _tri_alpha_pass,
)
from ilgpu_raytracing_tpu_torch.utils import vec


def _pick(arr, j):
    return torch.take_along_dim(arr, j[:, None], dim=1)[:, 0]


def trace_closest_brute(scene: SceneData, o: torch.Tensor, d: torch.Tensor) -> HitRecord:
    n = o.shape[0]
    dev = o.device
    best = HitRecord(
        t=torch.full((n,), T_INF, device=dev),
        kind=torch.zeros((n,), dtype=torch.int32, device=dev),
        prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        inst=torch.full((n,), -1, dtype=torch.int32, device=dev),
        bu=torch.zeros((n,), device=dev),
        bv=torch.zeros((n,), device=dev),
    )
    for inst, kind in _instances(scene):
        w2o = scene.inst_w2o[inst]
        o_obj = vec.transform_point(w2o, o)[:, None, :]
        d_obj = vec.transform_vector(w2o, d)[:, None, :]
        first = int(scene.inst_prim_first[inst])
        count = int(scene.inst_prim_count[inst])
        if kind == KIND_SPHERE:
            ok, t, _ = intersect_sphere(o_obj, d_obj, scene.sph_center[None],
                                        scene.sph_radius[None])
            z = torch.zeros_like(t)
            bu = bv = z
        else:
            ok, t, bu, bv = intersect_triangle(o_obj, d_obj, scene.tri_v0[None],
                                               scene.tri_e1[None], scene.tri_e2[None])
            ok = ok & (t > T_EPS)
        ids = torch.arange(t.shape[1], dtype=torch.int32, device=dev)
        ok = ok & ((ids >= first) & (ids < first + count))[None, :]
        if kind == KIND_TRI and scene.has_alpha:
            prim_ids = torch.broadcast_to(ids[None, :], ok.shape)
            ok = ok & _tri_alpha_pass(scene, prim_ids, bu, bv, closest=True)
        t = torch.where(ok, t, torch.full_like(t, T_INF))
        j = torch.argmin(t, dim=1)
        t_obj = _pick(t, j)  # parametric t transfers 1:1
        better = (t_obj < T_INF) & (t_obj < best.t)
        best = HitRecord(
            t=torch.where(better, t_obj, best.t),
            kind=torch.where(better, kind, best.kind).to(torch.int32),
            prim=torch.where(better, j.to(torch.int32), best.prim),
            inst=torch.where(better, inst, best.inst).to(torch.int32),
            bu=torch.where(better, _pick(bu, j), best.bu),
            bv=torch.where(better, _pick(bv, j), best.bv),
        )
    return best


def shadow_occlusion_brute(scene: SceneData, o, d, t_max_world) -> torch.Tensor:
    hit = trace_closest_brute(scene, o, d)
    return hit.hit & (hit.t < t_max_world)
