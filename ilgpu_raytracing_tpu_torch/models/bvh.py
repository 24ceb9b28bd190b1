"""Skip-index BVH builder (host, numpy; port of models/bvh.py: build,
refit and the treelet cut of the streaming sort key).

Median split on the largest-extent axis with the reference's tie-break
rules, RIGHT subtree emitted before LEFT so a left subtree's miss pointer is
the right root (reference Scene.cs:405-510). Node int fields are packed
`(left, first, count, skip)`; leaf `first` indexes the leaf-order list.
SAH and LBVH builds come from the native scene core.
"""

from __future__ import annotations

import logging
import sys

import numpy as np

log = logging.getLogger(__name__)

# packed int-field column indices
LEFT, FIRST, COUNT, SKIP = 0, 1, 2, 3


def _largest_axis(ext: np.ndarray) -> int:
    """Reference axis pick (Scene.cs:447-450): x unless y/z strictly larger."""
    axis = 0
    if ext[1] > ext[0] and ext[1] >= ext[2]:
        axis = 1
    elif ext[2] > ext[0] and ext[2] >= ext[1]:
        axis = 2
    return axis


def build_skip_index_bvh(
    bmin: np.ndarray,
    bmax: np.ndarray,
    centroid: np.ndarray,
    leaf_size: int,
    method: str = "median",
    use_native: bool | None = None,
):
    """Build over P primitive AABBs. Returns (node_bmin (N,3) f32,
    node_bmax (N,3) f32, node_ifields (N,4) i32, leaf_order (L,) i32).

    method: "median" (reference parity), "sah" or "lbvh" (native only; they
    degrade to median, with a warning, when no C++ compiler is present).
    use_native: None = native for P >= 4096 or for sah/lbvh."""
    P = np.asarray(bmin).shape[0]
    if use_native is None:
        use_native = method in ("sah", "lbvh") or P >= 4096
    if use_native:
        from ilgpu_raytracing_tpu_torch import native as native_mod

        method_id = {"median": native_mod.BUILD_MEDIAN,
                     "sah": native_mod.BUILD_SAH,
                     "lbvh": native_mod.BUILD_LBVH}[method]
        out = native_mod.build_bvh(bmin, bmax, centroid, leaf_size, method_id)
        if out is not None:
            return out
        if method != "median":
            log.warning(
                "native scene core unavailable: %s BVH build degrades to "
                "the Python median split (%d prims)", method, P,
            )
    return _build_skip_index_bvh_py(bmin, bmax, centroid, leaf_size)


def _build_skip_index_bvh_py(
    bmin: np.ndarray, bmax: np.ndarray, centroid: np.ndarray, leaf_size: int
):
    P = bmin.shape[0]
    assert P > 0
    bmin = np.asarray(bmin, dtype=np.float32)
    bmax = np.asarray(bmax, dtype=np.float32)
    centroid = np.asarray(centroid, dtype=np.float32)

    node_bmin: list[np.ndarray] = []
    node_bmax: list[np.ndarray] = []
    node_int: list[list[int]] = []
    leaf_order: list[np.ndarray] = []
    leaf_len = 0

    need = 2 * (P // max(1, leaf_size) + 2) * 64
    if sys.getrecursionlimit() < need:
        sys.setrecursionlimit(min(1_000_000, max(10_000, need)))

    def rec(ids: np.ndarray, parent_skip: int) -> int:
        nonlocal leaf_len
        node_i = len(node_int)
        node_bmin.append(bmin[ids].min(axis=0))
        node_bmax.append(bmax[ids].max(axis=0))
        node_int.append([-1, -1, 0, parent_skip])

        if len(ids) <= leaf_size:
            node_int[node_i][FIRST] = leaf_len
            node_int[node_i][COUNT] = len(ids)
            leaf_order.append(ids)
            leaf_len += len(ids)
            return node_i

        axis = _largest_axis(node_bmax[node_i] - node_bmin[node_i])
        srt = ids[np.argsort(centroid[ids, axis], kind="stable")]
        mid = len(ids) >> 1
        right_root = rec(srt[mid:], parent_skip)
        left_root = rec(srt[:mid], right_root)
        node_int[node_i][LEFT] = left_root
        return node_i

    rec(np.arange(P, dtype=np.int32), -1)
    return (
        np.stack(node_bmin).astype(np.float32),
        np.stack(node_bmax).astype(np.float32),
        np.array(node_int, dtype=np.int32),
        np.concatenate(leaf_order).astype(np.int32),
    )


def refit_bvh(
    node_ifields: np.ndarray,
    leaf_order: np.ndarray,
    prim_bmin: np.ndarray,
    prim_bmax: np.ndarray,
):
    """Refit node bounds to moved primitives, keeping topology. Returns
    (node_bmin, node_bmax).

    Nodes are emitted parent-before-children, so a reverse sweep sees
    children before parents; right subtrees are emitted first, so the right
    child of inner node i is `i + 1`. Min and max round nothing: the native
    refit (native.refit_bvh) gives the same bits."""
    n = node_ifields.shape[0]
    node_bmin = np.empty((n, 3), dtype=np.float32)
    node_bmax = np.empty((n, 3), dtype=np.float32)
    for i in range(n - 1, -1, -1):
        left, first, count, _skip = node_ifields[i]
        if count > 0:
            prim_ids = leaf_order[first: first + count]
            node_bmin[i] = prim_bmin[prim_ids].min(axis=0)
            node_bmax[i] = prim_bmax[prim_ids].max(axis=0)
        else:
            right = i + 1
            node_bmin[i] = np.minimum(node_bmin[left], node_bmin[right])
            node_bmax[i] = np.maximum(node_bmax[left], node_bmax[right])
    return node_bmin, node_bmax


def sphere_bounds(center: np.ndarray, radius: np.ndarray):
    r = radius[:, None]
    return center - r, center + r


def triangle_bounds(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    bmin = np.minimum(v0, np.minimum(v1, v2))
    bmax = np.maximum(v0, np.maximum(v1, v2))
    return bmin, bmax


def cut_scene_treelets(scene, n_target: int = 32) -> np.ndarray:
    """(T, 6) world-space treelet AABBs covering the whole scene, T <=
    n_target: per instance, its committed BLAS is greedily cut into
    prim-proportional subtrees (largest-by-prim-count splits first), then
    each subtree's object-space box is transformed to world space.

    The sort-key table of streaming scenes (ops/sort.py): bounce and shadow
    rays bin by the treelet their slab entry reaches first. Ordering only:
    coverage affects locality, never hit results.

    Emission order is [node, RIGHT subtree, LEFT subtree], so the right
    child spans [i+1, left) and the left child inherits the parent's end (a
    node's SKIP field is its on-miss jump target, not its span end)."""
    import heapq

    ifields = scene.blas_ifields.cpu().numpy()
    bmin_n = scene.blas_bmin.cpu().numpy()
    bmax_n = scene.blas_bmax.cpu().numpy()
    roots = scene.inst_blas_root.cpu().numpy().tolist()
    o2w = scene.inst_o2w.cpu().numpy().astype(np.float32)
    nn = ifields.shape[0]
    leaf_counts = np.where(ifields[:, 2] > 0, ifields[:, 2], 0)
    csum = np.concatenate([[0], np.cumsum(leaf_counts)])
    roots_all = sorted(int(r) for r in roots)

    def prims(i: int, end: int) -> int:
        return int(csum[end] - csum[i])

    total = int(csum[-1])
    out = []
    for inst, root in enumerate(roots):
        root = int(root)
        later = [r for r in roots_all if r > root]
        end0 = later[0] if later else nn
        share = max(1, round(n_target * prims(root, end0) / max(1, total)))
        heap = [(-prims(root, end0), root, end0)]
        while len(heap) < share:
            negp, i, end = heapq.heappop(heap)
            if ifields[i, 2] > 0:
                heapq.heappush(heap, (negp, i, end))
                break
            left = int(ifields[i, 0])
            heapq.heappush(heap, (-prims(i + 1, left), i + 1, left))
            heapq.heappush(heap, (-prims(left, end), left, end))
        m = o2w[inst]  # (3, 4)
        for _negp, i, _end in heap:
            lo, hi = bmin_n[i], bmax_n[i]
            # world box of a transformed AABB: |R| trick
            c = m[:, 0:3] @ ((lo + hi) * 0.5) + m[:, 3]
            e = np.abs(m[:, 0:3]) @ ((hi - lo) * 0.5)
            out.append(np.concatenate([c - e, c + e]))
    out = np.stack(out).astype(np.float32)
    return out[:n_target] if out.shape[0] > n_target else out
