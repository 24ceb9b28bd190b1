"""Alpha-cutout tracing by peeling around an opaque closest-hit tracer
(port of ops/alpha.py).

The reference tests alpha masks inside its traversal loop: the closest hit
rejects a triangle whose bilinear mask is below the cutoff
(SceneDeviceViews.cs:208-218), the shadow any-hit applies a +-0.10
point/bilinear band (SceneDeviceViews.cs:297-315). The hand-written
kernels test no masks. So the peel traces with a closest-hit kernel, tests
the mask at the returned hits as batched texture samples
(traverse._tri_alpha_pass), and traces again only the lanes whose hit was
rejected, from just past that hit, until every lane has an accepted hit or
a miss.

Shadow rays peel around the CLOSEST-hit tracer too (a rejected blocker
must not occlude) with the any-hit band, and latch at the first accepted
hit below t_max, as ShadowOcclusion returns early.

The advance steps the origin `dt = max(t*1e-4, 1e-5)` past the rejected
surface; two alpha surfaces closer than dt along the ray merge (the
reference has no such limit).

A ray that crosses more than MAX_PEELS rejected surfaces leaves the loop
still pending: a closest hit reports a MISS, a shadow ray UNOCCLUDED.
`with_exhausted=True` also returns the per-lane exhaustion mask.

The JAX package runs the loop as a `lax.while_loop` on the device. Here it
is a Python loop whose condition reads `pending.any()` back to the host
once a round: on the card each round costs one device-to-host sync.
"""

from __future__ import annotations

import torch

from ilgpu_raytracing_tpu_torch.models.scene import SceneData
from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF
from ilgpu_raytracing_tpu_torch.ops.traverse import (
    KIND_TRI,
    HitRecord,
    _tri_alpha_pass,
)

MAX_PEELS = 64


def _advance(t_hit):
    return t_hit + torch.clamp(t_hit * 1e-4, min=1e-5)


def _step(reject, o_cur, d, t_hit):
    """Origin moved past the rejected hits, and the distance moved."""
    adv = _advance(torch.where(reject, t_hit, torch.zeros_like(t_hit)))
    o_cur = torch.where(reject[..., None], o_cur + d * adv[..., None], o_cur)
    return o_cur, adv


def _ret(out, pending, i, with_exhausted, with_iters):
    ret = (out,)
    if with_exhausted:
        ret = ret + (pending,)
    if with_iters:
        ret = ret + (i,)
    return ret if len(ret) > 1 else out


def trace_closest_peel(trace_fn, scene: SceneData, o, d, active=None,
                       with_exhausted: bool = False, with_iters: bool = False):
    """Closest hit honouring alpha cutouts.

    trace_fn(o, d, active) -> HitRecord of an opaque closest-hit tracer (t
    relative to the origin passed, T_INF on a miss). with_exhausted=True
    adds the (N,) bool mask of lanes that crossed more than MAX_PEELS
    rejected surfaces (they report a miss); with_iters=True adds the number
    of rounds run (>= 1 when any lane was active)."""
    n = o.shape[0]
    dev = o.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    zero = torch.zeros((n,), device=dev)
    out = HitRecord(
        t=torch.full((n,), T_INF, device=dev),
        kind=torch.zeros((n,), dtype=torch.int32, device=dev),
        prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
        inst=torch.full((n,), -1, dtype=torch.int32, device=dev),
        bu=zero,
        bv=zero,
    )
    i, pending, o_cur, t_base = 0, active, o, zero
    while i < MAX_PEELS and bool(pending.any()):
        hit = trace_fn(o_cur, d, pending)
        opaque = _tri_alpha_pass(scene, hit.prim, hit.bu, hit.bv, closest=True)
        accept = pending & hit.hit & (opaque | (hit.kind != KIND_TRI))
        reject = pending & hit.hit & (~accept)
        out = HitRecord(
            t=torch.where(accept, t_base + hit.t, out.t),
            kind=torch.where(accept, hit.kind, out.kind),
            prim=torch.where(accept, hit.prim, out.prim),
            inst=torch.where(accept, hit.inst, out.inst),
            bu=torch.where(accept, hit.bu, out.bu),
            bv=torch.where(accept, hit.bv, out.bv),
        )
        o_cur, adv = _step(reject, o_cur, d, hit.t)
        t_base = torch.where(reject, t_base + adv, t_base)
        i, pending = i + 1, reject
    return _ret(out, pending, i, with_exhausted, with_iters)


def shadow_occlusion_peel(trace_fn, scene: SceneData, o, d, t_max, active=None,
                          with_exhausted: bool = False, with_iters: bool = False):
    """Any-hit occlusion honouring the +-0.10 alpha band; bool (N,).

    trace_fn as in trace_closest_peel; `t_max` is the world-space range
    (scalar or (N,)). with_exhausted=True adds the exhaustion mask
    (exhausted lanes report unoccluded); with_iters as in
    trace_closest_peel."""
    n = o.shape[0]
    dev = o.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    t_rem = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (n,))
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    i, pending, o_cur = 0, active, o
    while i < MAX_PEELS and bool(pending.any()):
        hit = trace_fn(o_cur, d, pending)
        within = pending & hit.hit & (hit.t < t_rem)
        blocks = _tri_alpha_pass(scene, hit.prim, hit.bu, hit.bv, closest=False)
        occ_now = within & (blocks | (hit.kind != KIND_TRI))
        occ = occ | occ_now
        reject = within & (~occ_now)
        o_cur, adv = _step(reject, o_cur, d, hit.t)
        t_rem = torch.where(reject, t_rem - adv, t_rem)
        i, pending = i + 1, reject
    return _ret(occ, pending, i, with_exhausted, with_iters)
