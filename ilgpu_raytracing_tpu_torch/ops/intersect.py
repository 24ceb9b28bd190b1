"""Intersection primitives, vectorized over ray lanes (port of
ops/intersect.py). Each returns masks and parameters instead of branching."""

from __future__ import annotations

import torch

from ilgpu_raytracing_tpu_torch.utils import vec

T_EPS = 0.001  # reference's pervasive t lower bound
T_INF = 1e30
T_HIT_MAX = 1e29  # "did we hit" threshold (SceneDeviceViews.cs:85)


def intersect_aabb(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test (SceneDeviceViews.cs:495-514). Returns bool mask."""
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tlo = torch.minimum(t1, t2)
    thi = torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(tlo[..., 0], tlo[..., 1]), tlo[..., 2])
    tmax = torch.minimum(torch.minimum(thi[..., 0], thi[..., 1]), thi[..., 2])
    if isinstance(t_min, torch.Tensor):
        lo = torch.maximum(tmin, t_min)
    else:
        lo = torch.clamp(tmin, min=t_min)
    return (tmax >= lo) & (tmin <= t_max)


def intersect_sphere(o, d, center, radius):
    """Quadratic sphere test (SceneDeviceViews.cs:516-537).

    Returns (ok, t, n): near-then-far t above T_EPS, outward normal."""
    oc = o - center
    a = vec.dot(d, d)
    b = 2.0 * vec.dot(oc, d)
    c = vec.dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    ok_disc = disc >= 0.0
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_2a = 1.0 / (2.0 * a)
    t0 = (-b - sqrt_d) * inv_2a
    t1 = (-b + sqrt_d) * inv_2a
    t = torch.where(t0 >= T_EPS, t0, t1)
    ok = ok_disc & (t >= T_EPS)
    t = torch.where(ok, t, torch.zeros_like(t))
    p = o + d * t[..., None]
    n = vec.normalize(p - center)
    n = torch.where(ok[..., None], n, torch.zeros_like(n))
    return ok, t, n


def intersect_triangle(o, d, v0, e1, e2):
    """Moller-Trumbore with precomputed edges (SceneDeviceViews.cs:539-558).
    Returns (ok, t, bu, bv)."""
    p = vec.cross(d, e2)
    det = vec.dot(e1, p)
    ok = torch.abs(det) >= 1e-8
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - v0
    bu = vec.dot(tv, p) * inv_det
    ok = ok & (bu >= 0.0) & (bu <= 1.0)
    q = vec.cross(tv, e1)
    bv = vec.dot(d, q) * inv_det
    ok = ok & (bv >= 0.0) & (bu + bv <= 1.0)
    t = vec.dot(e2, q) * inv_det
    ok = ok & (t > 0.0)
    z = torch.zeros_like(t)
    return ok, torch.where(ok, t, z), torch.where(ok, bu, z), torch.where(ok, bv, z)
