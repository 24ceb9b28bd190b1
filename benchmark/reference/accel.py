"""The reference's own ray queries over a scene's world-space geometry.

Built from the benchmark's vertex arrays and sphere lists alone, never from
a table the program made. Triangles and spheres each get a tree of their
own: the primitives are sorted by the Morton code of their box centres,
cut into leaves of `LEAF` consecutive primitives, and bounded by a complete
binary tree in heap order (node i has children 2i and 2i + 1; the leaves
are the last level, past the last leaf the nodes are empty). The walk tests
both children of an inner node, goes down to the nearer one it hits and
pushes the farther on a per-lane stack, skips a node entered beyond the
best hit so far, and pops when a node has nothing left to enter. A query's
memory grows with its lanes times the tree's depth, not with the number of
primitives. The closest hit is the least t over every accepted primitive,
whatever the tree: the tree only skips boxes a ray misses. Among spheres
at one t the lowest sphere id wins, as in a test of every sphere at once.
A scene may have no triangles (its triangle tree is empty) or no spheres,
not neither.

The tests and their acceptance rules are the renderer's: t above `T_EPS`,
spheres before triangles with a triangle kept only where it is strictly
nearer, and rays in object space through each instance's identity affine.
On a scene with alpha cutouts (`Masks`) the walk tests each candidate
triangle's mask where it tests the triangle, as the upstream renderer's
traversal does: a closest hit skips a triangle its mask rejects and walks
on, an any-hit test counts only a triangle the any-hit band accepts
(`texture.opaque`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import ops
from benchmark.reference import texture

LEAF = 8
KIND_SPHERE = 1
KIND_TRI = 2
# boxes grow by this share of their primitives' extent, so rounding in the
# slab test never drops a primitive that a ray hits at its very edge
BOX_PAD = 1e-6


@dataclasses.dataclass
class Hits:
    t: torch.Tensor  # (N,) T_INF on a miss
    kind: torch.Tensor  # (N,) i32
    prim: torch.Tensor  # (N,) i32: sphere id or global triangle id
    bu: torch.Tensor
    bv: torch.Tensor

    @property
    def hit(self):
        return self.t < ops.T_HIT_MAX


@dataclasses.dataclass
class Masks:
    """The alpha cutouts of the triangles: corner UVs, mask texture (-1 for
    none) and cutoff of each, and the texture pool."""

    tri_uv: torch.Tensor  # (T, 3, 2)
    alpha_tex: torch.Tensor  # (T,) int64
    cutoff: torch.Tensor  # (T,)
    pool: texture.Pool

    def opaque(self, tri, bu, bv, closest: bool):
        """Whether the hits (bu, bv) on triangles `tri` pass their masks."""
        u, v = texture.uv_at(self.tri_uv[tri], bu, bv)
        return texture.opaque(self.pool, self.alpha_tex[tri], self.cutoff[tri], u, v, closest)


@dataclasses.dataclass
class Tree:
    """A heap-order tree over one kind of primitive, on one device."""

    node_min: torch.Tensor  # (2P, 3)
    node_max: torch.Tensor
    node_valid: torch.Tensor  # (2P,) bool
    leaf_prims: torch.Tensor  # (n_leaves, LEAF) int64, -1 padding
    first_leaf: int  # P: heap index of leaf 0
    n_prims: int


@dataclasses.dataclass
class Accel:
    """Triangles (v0, e1, e2), spheres and a tree over each on one device."""

    v0: torch.Tensor  # (T, 3), T may be 0
    e1: torch.Tensor
    e2: torch.Tensor
    sph_center: torch.Tensor  # (S, 3), S may be 0
    sph_radius: torch.Tensor
    tri_tree: Tree
    sph_tree: Tree
    identity: torch.Tensor  # (3, 4): every instance's affine
    masks: Masks | None = None  # the triangles' alpha cutouts, where the scene has any


def _morton(c: np.ndarray) -> np.ndarray:
    lo, hi = c.min(axis=0), c.max(axis=0)
    q = ((c - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(np.int64).clip(0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        return (x | (x << 2)) & 0x09249249

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def _pad(extent: float) -> np.float32:
    return np.float32(BOX_PAD * max(1.0, extent))


def _tree(bmin: np.ndarray, bmax: np.ndarray, pad: np.float32, t) -> Tree:
    """The tree over primitives with boxes (bmin, bmax), each padded by
    `pad`; `t` puts an array on the device."""
    n = bmin.shape[0]
    order = (np.argsort(_morton(0.5 * (bmin + bmax)), kind="stable") if n
             else np.zeros(0, np.int64))
    n_leaves = -(-n // LEAF)
    p = 2  # the root is an inner node, also over a single leaf
    while p < n_leaves:
        p *= 2
    node_min = np.full((2 * p, 3), np.inf, np.float32)
    node_max = np.full((2 * p, 3), -np.inf, np.float32)
    valid = np.zeros(2 * p, bool)
    if n:
        starts = np.arange(0, n, LEAF)
        node_min[p:p + n_leaves] = np.minimum.reduceat(bmin[order], starts) - pad
        node_max[p:p + n_leaves] = np.maximum.reduceat(bmax[order], starts) + pad
        valid[p:p + n_leaves] = True
    level = p
    while level > 1:
        i = np.arange(level // 2, level)
        node_min[i] = np.minimum(node_min[2 * i], node_min[2 * i + 1])
        node_max[i] = np.maximum(node_max[2 * i], node_max[2 * i + 1])
        valid[i] = valid[2 * i]
        level //= 2
    leaf_prims = np.full((n_leaves * LEAF,), -1, np.int64)
    leaf_prims[:n] = order
    node_min[~valid] = 0.0
    node_max[~valid] = 0.0
    return Tree(node_min=t(node_min), node_max=t(node_max), node_valid=t(valid, torch.bool),
                leaf_prims=t(leaf_prims.reshape(n_leaves, LEAF), torch.int64),
                first_leaf=p, n_prims=n)


def build(positions: np.ndarray, tris: np.ndarray, spheres: list[dict], device,
          round_to=None, masks: Masks | None = None) -> Accel:
    """The scene's ray-query structure. `positions` (V, 3) float32 and
    `tris` (T, 3) give the triangles in the scene's global triangle order
    (T may be 0); `spheres` are dicts with `center` and `radius` in
    sphere-id order. `round_to` (a torch dtype) rounds the geometry to that
    precision first: the control of the correctness check. `masks` gives
    the triangles' alpha cutouts, tested in the walk."""
    positions = np.asarray(positions, np.float32).reshape(-1, 3)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    if tris.shape[0] == 0 and not spheres:
        raise ValueError("a scene needs at least one triangle or one sphere; this one has "
                         "neither")
    centers = np.array([s["center"] for s in spheres], np.float32).reshape(-1, 3)
    radii = np.array([s["radius"] for s in spheres], np.float32)
    if round_to is not None:  # the sphere tree bounds the spheres as the control tests them
        centers, radii = (torch.as_tensor(a).to(round_to).to(torch.float32).numpy()
                          for a in (centers, radii))
    sph_pad = _pad(float((np.abs(centers) + radii[:, None]).max()) if spheres else 0.0)
    v0, v1, v2 = positions[tris[:, 0]], positions[tris[:, 1]], positions[tris[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    tri_pad = _pad(float(np.abs(positions).max())) if tris.shape[0] else sph_pad
    t = lambda a, dt=torch.float32: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                                    device=device)
    tri_tree = _tree(np.minimum(np.minimum(v0, v1), v2), np.maximum(np.maximum(v0, v1), v2),
                     tri_pad, t)
    sph_tree = _tree(centers - radii[:, None], centers + radii[:, None], sph_pad, t)
    geo = [t(v0), t(e1), t(e2)]
    if round_to is not None:
        geo = [g.to(round_to).to(torch.float32) for g in geo]
    return Accel(*geo, t(centers), t(radii), tri_tree=tri_tree, sph_tree=sph_tree,
                 identity=t(np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], np.float32)),
                 masks=masks)


def _miss(n: int, dev) -> Hits:
    return Hits(t=torch.full((n,), ops.T_INF, device=dev),
                kind=torch.zeros((n,), dtype=torch.int32, device=dev),
                prim=torch.full((n,), -1, dtype=torch.int32, device=dev),
                bu=torch.zeros((n,), device=dev), bv=torch.zeros((n,), device=dev))


def _tri_test(acc: Accel):
    """Leaf test of the triangle tree: (accepted, t, (bu, bv)) per slot."""
    def test(ids, o, d, closest: bool):
        safe = ids.clamp(min=0)
        ok, t, bu, bv = ops.intersect_triangle(o[:, None, :], d[:, None, :], acc.v0[safe],
                                               acc.e1[safe], acc.e2[safe])
        valid = (ids >= 0) & ok & (t > ops.T_EPS)
        if acc.masks is not None:
            valid = valid & acc.masks.opaque(safe, bu, bv, closest=closest)
        return valid, t, (bu, bv)

    return test


def _sphere_test(acc: Accel):
    """Leaf test of the sphere tree: (accepted, t, ()) per slot."""
    def test(ids, o, d, closest: bool):
        safe = ids.clamp(min=0)
        ok, t = ops.intersect_sphere(o[:, None, :], d[:, None, :], acc.sph_center[safe],
                                     acc.sph_radius[safe])
        return (ids >= 0) & ok & (t > ops.T_EPS), t, ()

    return test


def _entry(tree: Tree, node, o, inv, bound):
    """(entry t, hit) of the boxes `node` for each lane, hit within bound."""
    bmin, bmax = tree.node_min[node], tree.node_max[node]
    t1 = (bmin - o) * inv
    t2 = (bmax - o) * inv
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    hit = tree.node_valid[node] & (tmax >= torch.clamp(tmin, min=ops.T_EPS)) & (tmin <= bound)
    return tmin, hit


def _walk(tree: Tree, test, n_extra: int, o, d, t_lim, any_hit: bool,
          ties_by_id: bool = False):
    """Walk of every lane with `t_lim` > 0 from the root, nearer child
    first, the farther pushed on a per-lane stack with its entry t; `test`
    tests a leaf's primitives and gives `n_extra` more floats a slot.
    Closest: [t, prim, *the extras] with t below `t_lim` (T_INF and -1
    where none); within a leaf ties go to the lowest id, across leaves to
    the leaf found first, or with `ties_by_id` to the lowest id too.
    Any-hit: [a bool mask of a primitive hit with T_EPS < t < t_lim]."""
    n = o.shape[0]
    dev = o.device
    if any_hit:
        out = [torch.zeros((n,), dtype=torch.bool, device=dev)]
    else:
        out = [t_lim.clone(), torch.full((n,), -1, dtype=torch.int64, device=dev)]
        out += [torch.zeros((n,), device=dev) for _ in range(n_extra)]
    if tree.n_prims == 0:
        return out
    lanes = torch.nonzero(t_lim > 0).squeeze(1)
    o, d, lim = o[lanes], d[lanes], t_lim[lanes]
    inv = ops.inv_dir(d)
    live = [s[lanes] for s in out]
    root = torch.ones_like(lanes)
    cur_t, hit = _entry(tree, root, o, inv, lim)
    cur = torch.where(hit, root, -1)
    depth = 2 * tree.first_leaf.bit_length() + 2
    stack = torch.zeros((lanes.numel(), depth), dtype=torch.int64, device=dev)
    stack_t = torch.zeros((lanes.numel(), depth), device=dev)
    sp = torch.zeros_like(lanes)
    step = 0
    while lanes.numel() > 0:
        bound = lim if any_hit else live[0]
        on = (cur >= 0) & (cur_t <= bound)  # nodes entered beyond the best hit are skipped
        is_leaf = on & (cur >= tree.first_leaf)
        sub = torch.nonzero(is_leaf).squeeze(1)
        if sub.numel() > 0:
            ids = tree.leaf_prims[cur[sub] - tree.first_leaf]  # (k, LEAF)
            valid, t, extra = test(ids, o[sub], d[sub], not any_hit)
            if any_hit:
                live[0][sub] = live[0][sub] | (valid & (t < lim[sub, None])).any(dim=1)
            else:
                t = torch.where(valid, t, ops.T_INF)
                t_min = t.amin(dim=1, keepdim=True)
                # ties go to the lowest id
                j = torch.where(t == t_min, ids, torch.iinfo(torch.int64).max).argmin(
                    dim=1, keepdim=True)
                best_id = ids.gather(1, j)
                accept = t_min[:, 0] < live[0][sub]
                if ties_by_id:
                    accept = accept | ((t_min[:, 0] == live[0][sub])
                                       & (best_id[:, 0] < live[1][sub]))
                for s, v in zip(live, (t_min, best_id, *(e.gather(1, j) for e in extra))):
                    s[sub] = torch.where(accept, v[:, 0].to(s.dtype), s[sub])
            bound = lim if any_hit else live[0]
        inner = on & ~is_leaf
        c0 = torch.where(inner, 2 * cur, 1)
        t0, h0 = _entry(tree, c0, o, inv, bound)
        t1, h1 = _entry(tree, c0 + 1, o, inv, bound)
        h0, h1 = h0 & inner, h1 & inner
        one_first = h1 & (~h0 | (t1 < t0))
        both = torch.nonzero(h0 & h1).squeeze(1)
        if both.numel() > 0:
            far = torch.where(one_first, c0, c0 + 1)[both]
            far_t = torch.where(one_first, t0, t1)[both]
            stack[both, sp[both]] = far
            stack_t[both, sp[both]] = far_t
            sp[both] += 1
        down = h0 | h1
        pop = (cur >= 0) & ~down & (sp > 0)
        top = (sp - 1).clamp(min=0)[:, None]
        nxt = torch.where(down, torch.where(one_first, c0 + 1, c0),
                          torch.where(pop, stack.gather(1, top)[:, 0], -1))
        cur_t = torch.where(down, torch.where(one_first, t1, t0), stack_t.gather(1, top)[:, 0])
        sp = sp - pop.to(sp.dtype)
        if any_hit:
            nxt = torch.where(live[0], -1, nxt)
        cur = nxt
        step += 1
        if step % 4:
            continue
        keep = torch.nonzero(cur >= 0).squeeze(1)
        if keep.numel() == lanes.numel():
            continue
        for s_out, s in zip(out, live):
            s_out[lanes] = s
        lanes, cur, cur_t, sp = lanes[keep], cur[keep], cur_t[keep], sp[keep]
        o, d, inv, lim = o[keep], d[keep], inv[keep], lim[keep]
        stack, stack_t = stack[keep], stack_t[keep]
        live = [s[keep] for s in live]
    return out


def _object_space(acc: Accel, o, d):
    return ops.transform_point(acc.identity, o), ops.transform_vector(acc.identity, d)


def _spheres(acc: Accel, o, d, t_lim, any_hit: bool):
    """The sphere tree's walk: closest [t, sphere id], ties to the lowest
    id; any-hit [mask]."""
    return _walk(acc.sph_tree, _sphere_test(acc), 0, o, d, t_lim, any_hit, ties_by_id=True)


def _triangles(acc: Accel, o, d, t_lim, any_hit: bool):
    """The triangle tree's walk: closest [t, triangle id, bu, bv]; any-hit
    [mask]. A triangle whose alpha mask rejects the hit counts as missed."""
    return _walk(acc.tri_tree, _tri_test(acc), 2, o, d, t_lim, any_hit)


def trace_closest(acc: Accel, o, d, active=None) -> Hits:
    """Closest hit per ray; inactive lanes miss."""
    n = o.shape[0]
    dev = o.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    o, d = _object_space(acc, o, d)
    best = _miss(n, dev)
    t_s, sid = _spheres(acc, o, d, torch.where(active, best.t, torch.zeros_like(best.t)),
                        any_hit=False)
    on_s = active & (t_s < ops.T_HIT_MAX)
    best.t = torch.where(on_s, t_s, best.t)
    best.kind = torch.where(on_s, KIND_SPHERE, best.kind).to(torch.int32)
    best.prim = torch.where(on_s, sid.to(torch.int32), best.prim)
    lim = torch.where(active, best.t, torch.zeros_like(best.t))
    t_t, tri, bu, bv = _triangles(acc, o, d, lim, any_hit=False)
    on_t = active & (tri >= 0) & (t_t < best.t)
    return Hits(t=torch.where(on_t, t_t, best.t),
                kind=torch.where(on_t, KIND_TRI, best.kind).to(torch.int32),
                prim=torch.where(on_t, tri.to(torch.int32), best.prim),
                bu=torch.where(on_t, bu, best.bu), bv=torch.where(on_t, bv, best.bv))


def occluded(acc: Accel, o, d, t_max: float, active=None):
    """Any accepted hit with t below `t_max` per ray; inactive lanes False."""
    n = o.shape[0]
    dev = o.device
    if active is None:
        active = torch.ones((n,), dtype=torch.bool, device=dev)
    o, d = _object_space(acc, o, d)
    lim = torch.where(active, torch.full((n,), t_max, device=dev),
                      torch.zeros((n,), device=dev))
    occ = _spheres(acc, o, d, lim, any_hit=True)[0]
    lim = torch.where(occ, torch.zeros_like(lim), lim)
    return occ | _triangles(acc, o, d, lim, any_hit=True)[0]
