"""Binary-BVH scene tables and the skip-index trace kernel K6
(csrc/binary_trace.cu), the port of the JAX package's
`ops/pallas/traverse_kernel.py`.

Host side: `BinaryScene` carries the tables of `wide.prepare` (the port of
`traverse_kernel.prepare`) on the scene's device: node boxes (Nn, 6), node
records (Nn, 4) = (left, first_row, count, skip), and the packed leaf rows
compacted from 128 lanes to (Lt, 8, 12) triangles and (Ls, 8, 16) spheres,
plus the instance tables of `wide._instance_tables` (here with the binary
root). `binary_from_numpy` loads the JAX `PallasScene`'s arrays, so both
packages can trace the same tables. From them it derives what the kernel
reads (`pair_records`): one 64-byte child-pair record per inner node, one
32-byte record of each instance root's box and child word, and the depth
that bounds the kernel's stack.

ops/route.py chooses K6 for a BinaryScene; under a device mesh the
renderer replicates the BinaryScene, as ops/cuda/wide.py says.

Device side: `trace_closest_binary` (closest hit: t, prim, inst, bu, bv) and
`shadow_occlusion_binary` (any-hit) launch K6 on CUDA tensors and run its
plain version on CPU tensors: the per-lane skip-index walk over the flat
tables, in the kernel's arithmetic. The slab, leaf-slot and transform
helpers below are shared with the plain versions of K7/K8
(ops/cuda/treelet.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.models.scene import BLAS_TRI_MESH, SceneData
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops.cuda import wide
from ilgpu_raytracing_tpu_torch.ops.intersect import T_EPS, T_INF
from ilgpu_raytracing_tpu_torch.ops.traverse import KIND_SPHERE, KIND_TRI, HitRecord
from ilgpu_raytracing_tpu_torch.utils import telemetry

LEAF_WIDTH = wide.LEAF_WIDTH
TRI_SLOT = wide.TRI_STRIDE  # v0(3) e1(3) e2(3) prim_id pad(2)
SPH_SLOT = wide.SPH_STRIDE  # center(3) radius prim_id pad(11)
TRI_ID, SPH_ID = 9, 4  # the prim id's float in a triangle / sphere slot

LAUNCHES = telemetry.counter("launches.binary", binary_closest=0, binary_shadow=0)


@dataclasses.dataclass
class BinaryScene:
    """Device tables of K6 (`traverse_kernel.PallasScene`, compacted)."""

    nodes: torch.Tensor  # (Nn, 6) f32 bmin3 bmax3
    node_i: torch.Tensor  # (Nn, 4) i32 left, first_row, count, skip
    tri: torch.Tensor  # (Lt, 8, 12) f32 leaf triangles v0 e1 e2 id
    sph: torch.Tensor  # (Ls, 8, 16) f32 leaf spheres center radius id
    inst_i: torch.Tensor  # (n_inst, 4) i32: kind, binary root, inst_id, identity
    inst_f: torch.Tensor  # (n_inst, 18) f32: w2o 12, world bounds 6
    kind_of_inst: torch.Tensor  # (max inst_id + 1,) i32 KIND_* per instance
    pairs: torch.Tensor  # (Ni, 16) i32 child-pair records (`pair_records`)
    roots: torch.Tensor  # (n_inst, 8) i32 each instance root's box and child word
    depth: int  # most inner nodes on a root-to-leaf path: the stack bound
    meta: tuple = ()
    leaf_width: int = LEAF_WIDTH
    needs_bary: bool = True


def tree_depth(node_i: np.ndarray, roots) -> tuple[np.ndarray, int]:
    """(the nodes reachable from `roots`, as a mask; the most inner nodes on
    a root-to-leaf path) of the binary tables node_i (Nn, 4) (left, first,
    count, skip), whose inner node n has children `left` and n + 1."""
    left, inner = node_i[:, 0].astype(np.int64), node_i[:, 2] == 0
    reach = np.zeros((node_i.shape[0],), bool)
    level, depth = np.unique(np.asarray(roots, np.int64)), 0
    while level.size:
        reach[level] = True
        level = level[inner[level]]
        depth += int(level.size > 0)
        level = np.unique(np.concatenate([left[level], level + 1]))
    return reach, depth


def pair_records(boxes: np.ndarray, node_i: np.ndarray, roots) -> tuple:
    """K6's child-pair records over the flat tables: boxes (Nn, 6) f32,
    node_i (Nn, 4) (left, first_row, count, skip), the instances' roots.

    The children of inner node n are `left` first and n + 1 second (the
    BVH builders make the right subtree first, so n + 1 is also `left`'s
    skip). Each inner node reachable from a root gets one record, in node
    order: per child c, ints [8c, 8c + 8) hold its box (lo xyz, hi xyz, as
    float32 bits), its child word and a zero. A child word is the child's
    record index when it is inner, else ~(first_row << 3 | count - 1).
    Returns (records (Ni, 16) i32, one such 8-int record per root (n_roots,
    8) i32, depth: the most inner nodes on a root-to-leaf path)."""
    nn = node_i.shape[0]
    first, count = node_i[:, 1].astype(np.int64), node_i[:, 2].astype(np.int64)
    inner = count == 0
    reach, depth = tree_depth(node_i, roots)
    ids = np.flatnonzero(reach & inner)
    rank = np.full((nn,), -1, np.int64)
    rank[ids] = np.arange(ids.size)
    leaves = reach & ~inner
    if (first[leaves] >= 1 << 28).any() or (count[leaves] > LEAF_WIDTH).any():
        raise ValueError("binary trace: a leaf overflows its 28-bit row / 3-bit count word")
    bits = np.ascontiguousarray(boxes, np.float32).view(np.int32)

    def child(c):
        out = np.zeros((c.size, 8), np.int32)
        out[:, :6] = bits[c]
        out[:, 6] = np.where(inner[c], rank[c], ~((first[c] << 3) | (count[c] - 1)))
        return out

    rec = np.zeros((max(ids.size, 1), 16), np.int32)
    rec[: ids.size, :8] = child(node_i[ids, 0].astype(np.int64))
    rec[: ids.size, 8:] = child(ids + 1)
    return rec, child(np.asarray(roots, np.int64)), depth


def binary_from_numpy(tables: dict, scene: SceneData) -> BinaryScene:
    """BinaryScene from the tables of a binary prep (`wide.prepare`, or the
    JAX `traverse_kernel.prepare` read out as numpy: nodes_rows,
    node_ifields, tri_rows, sph_rows, meta, leaf_width, needs_bary), on
    `scene`'s device."""
    dev = scene.device
    meta = tuple(
        (int(k), int(r), tuple(float(v) for v in w2o), tuple(float(v) for v in wb),
         int(i))
        for k, r, w2o, wb, i in tables["meta"]
    )
    tri_rows = np.asarray(tables["tri_rows"], np.float32)
    if (tri_rows[:, LEAF_WIDTH * TRI_SLOT:] != 0.0).any():
        raise ValueError("triangle leaf rows carry data past 8 slots of 12 floats")
    inst_i, inst_f = wide._instance_tables(meta, dev)
    kinds = np.zeros((max((m[4] for m in meta), default=0) + 1,), np.int32)
    for kind, _root, _w2o, _wb, inst_id in meta:
        kinds[inst_id] = KIND_TRI if kind == BLAS_TRI_MESH else KIND_SPHERE

    def t(x, dtype, shape):
        return torch.as_tensor(np.array(x).reshape(shape), dtype=dtype,
                               device=dev).contiguous()

    boxes = np.asarray(tables["nodes_rows"], np.float32)[:, 0:6]
    node_i = np.asarray(tables["node_ifields"]).reshape(-1, 4)
    pairs, roots, depth = pair_records(boxes, node_i, [m[1] for m in meta])
    return BinaryScene(
        nodes=t(boxes, torch.float32, (-1, 6)),
        node_i=t(node_i, torch.int32, (-1, 4)),
        tri=t(tri_rows[:, : LEAF_WIDTH * TRI_SLOT], torch.float32,
              (-1, LEAF_WIDTH, TRI_SLOT)),
        sph=t(tables["sph_rows"], torch.float32, (-1, LEAF_WIDTH, SPH_SLOT)),
        inst_i=inst_i,
        inst_f=inst_f,
        kind_of_inst=torch.as_tensor(kinds, device=dev),
        pairs=t(pairs, torch.int32, (-1, 16)),
        roots=t(roots, torch.int32, (-1, 8)),
        meta=meta,
        leaf_width=int(tables["leaf_width"]),
        needs_bary=bool(tables["needs_bary"]),
        depth=depth,
    )


def prepare_binary(scene: SceneData) -> BinaryScene:
    """K6 tables of a committed scene (leaf size <= 8), on its device."""
    return binary_from_numpy(dataclasses.asdict(wide.prepare(scene)), scene)


# ------------------------------------------ plain arithmetic of the kernels


def inv_dir(d):
    """1 / d with 1e-8 in place of 0 (trace_common.cuh inv_dir)."""
    return 1.0 / torch.where(d != 0.0, d, torch.full_like(d, 1e-8))


def slab(b, o, inv, t_b):
    """trace_common.cuh slab6: boxes b (..., 6) against rays (L, 3); lo
    clamped to T_EPS, hit when hi >= lo and lo <= t_b. fmin/fmax ignore a
    NaN operand as fminf/fmaxf do."""
    lo = hi = None
    for ax in range(3):
        t1 = (b[..., ax] - o[:, ax]) * inv[:, ax]
        t2 = (b[..., 3 + ax] - o[:, ax]) * inv[:, ax]
        if lo is None:
            lo, hi = torch.fmin(t1, t2), torch.fmax(t1, t2)
        else:
            lo = torch.fmax(lo, torch.fmin(t1, t2))
            hi = torch.fmin(hi, torch.fmax(t1, t2))
    lo = torch.fmax(lo, torch.full_like(lo, T_EPS))
    return (hi >= lo) & (lo <= t_b)


def transform(m, o, d):
    """trace_common.cuh transform_ray: m (12,) or (L, 12) f32 world->object
    affines, the sums in the kernel's order."""
    m = m.reshape(-1, 12)
    c = [m[:, k] for k in range(12)]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ro = torch.stack([c[0] * ox + c[1] * oy + c[2] * oz + c[3],
                      c[4] * ox + c[5] * oy + c[6] * oz + c[7],
                      c[8] * ox + c[9] * oy + c[10] * oz + c[11]], dim=1)
    rd = torch.stack([c[0] * dx + c[1] * dy + c[2] * dz,
                      c[4] * dx + c[5] * dy + c[6] * dz,
                      c[8] * dx + c[9] * dy + c[10] * dz], dim=1)
    return ro, rd


def tri_slots(rows, o, d):
    """trace_common.cuh tri_tuv on (S, K, >=12) triangle slots against rays
    (S, 3). Returns (t, bu, bv, accepted-above-T_EPS), each (S, K)."""
    ox, oy, oz = (o[:, k: k + 1] for k in range(3))
    dx, dy, dz = (d[:, k: k + 1] for k in range(3))
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (rows[..., k] for k in range(9))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = det.abs() >= 1e-8
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    bu = (tvx * px + tvy * py + tvz * pz) * inv_det
    ok = ok & (bu >= 0.0) & (bu <= 1.0)
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    bv = (dx * qx + dy * qy + dz * qz) * inv_det
    ok = ok & (bv >= 0.0) & (bu + bv <= 1.0)
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return t, bu, bv, ok & (t > T_EPS)


def sph_slots(rows, o, d):
    """trace_common.cuh sph_t on (S, K, >=5) sphere slots against rays
    (S, 3). Returns (t, accepted-at-or-above-T_EPS), each (S, K)."""
    ocx, ocy, ocz = (o[:, k: k + 1] - rows[..., k] for k in range(3))
    dx, dy, dz = (d[:, k: k + 1] for k in range(3))
    rad = rows[..., 3]
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = b * b - 4.0 * a * c
    # sqrt in float64, rounded once to float32: the correctly rounded sqrtf
    # of the kernels (the CPU's float32 torch.sqrt is not always)
    sq = torch.sqrt(torch.clamp(disc, min=0.0).double()).float()
    inv2a = 1.0 / (2.0 * a)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t = torch.where(t0 >= T_EPS, t0, t1)
    return t, (disc >= 0.0) & (rad > 0.0) & (t >= T_EPS)


def first_min(t, ok):
    """(min, index) over the accepted slots of each row, +inf where none:
    the first index reaching the minimum, which is the slot a sequential
    `t < t_best` scan in slot order keeps."""
    return torch.min(torch.where(ok, t, torch.full_like(t, float("inf"))), dim=1)


# ---------------------------------------------------------------- K6 plain


def _walk_plain(bs: BinaryScene, o, d, t_max, any_hit: bool, work=None):
    """Plain K6: the skip-index walk of every lane over the BinaryScene
    tables, instance by instance in meta order, with the kernel's
    predicates; lanes that leave the tree drop out of the working set.
    `work` ([boxes, primitives]) gains what the walk tests: each box it
    reaches, each slot of a hit leaf up to the first accepted one
    (any-hit) or all of them (closest), as K6's counting variant counts."""
    n = o.shape[0]
    dev = o.device
    t_best = torch.clamp(t_max, max=T_INF)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    inst = prim.clone()
    bu = torch.zeros((n,), device=dev)
    bv = torch.zeros((n,), device=dev)
    occ = torch.zeros((n,), dtype=torch.bool, device=dev)
    inv_w = inv_dir(d)
    ident = bs.inst_i[:, 3].tolist()
    for k, (kind, root, _w2o, _wb, inst_id) in enumerate(bs.meta):
        bound = t_max if any_hit else t_best
        live = (t_max > 0.0) & ~occ
        enter = live & slab(bs.inst_f[k, 12:18], o, inv_w, bound)
        if work is not None:
            work[0] += int(live.sum())
        lanes = torch.nonzero(enter).squeeze(1)
        if lanes.numel() == 0:
            continue
        ro, rd = o[lanes], d[lanes]
        if not ident[k]:
            ro, rd = transform(bs.inst_f[k, 0:12], ro, rd)
        inv = inv_dir(rd)
        is_tri = kind == BLAS_TRI_MESH
        rows_tbl = bs.tri if is_tri else bs.sph
        tl = t_max[lanes]
        tb, pb = t_best[lanes].clone(), prim[lanes].clone()
        ub, vb = bu[lanes].clone(), bv[lanes].clone()
        oc = torch.zeros_like(tb, dtype=torch.bool)
        idx = torch.arange(lanes.numel(), device=dev)
        cur = torch.full_like(idx, root)
        slot = torch.arange(LEAF_WIDTH, device=dev)
        while idx.numel() > 0:
            if work is not None:
                work[0] += idx.numel()
            f = bs.node_i[cur]
            hit = slab(bs.nodes[cur], ro[idx], inv[idx], tl[idx] if any_hit else tb[idx])
            count = f[:, 2]
            leaf = hit & (count > 0)
            if bool(leaf.any()):
                s = idx[leaf]
                rows = rows_tbl[f[leaf, 1].long()]
                n_slot = torch.clamp(count[leaf], max=bs.leaf_width)
                if is_tri:
                    t, u, v, ok = tri_slots(rows, ro[s], rd[s])
                else:
                    t, ok = sph_slots(rows, ro[s], rd[s])
                ok = ok & (slot[None, :] < n_slot[:, None])
                if any_hit:
                    acc = ok & (t < tl[s, None])
                    oc[s] |= acc.any(dim=1)
                    if work is not None:  # up to the first accepted slot
                        first = torch.argmax(acc.to(torch.int32), dim=1) + 1
                        work[1] += int(torch.where(acc.any(dim=1), first, n_slot).sum())
                else:
                    if work is not None:
                        work[1] += int(n_slot.sum())
                    mn, j = first_min(t, ok)
                    upd = mn < tb[s]
                    w = s[upd]
                    tb[w] = mn[upd]
                    ids = rows[..., TRI_ID if is_tri else SPH_ID].to(torch.int32)
                    pb[w] = ids.gather(1, j[:, None])[upd, 0]
                    if is_tri:
                        ub[w] = u.gather(1, j[:, None])[upd, 0]
                        vb[w] = v.gather(1, j[:, None])[upd, 0]
            nxt = torch.where(hit & (count == 0), f[:, 0], f[:, 3])
            if any_hit:
                nxt = torch.where(oc[idx], torch.full_like(nxt, -1), nxt)
            keep = nxt >= 0
            idx, cur = idx[keep], nxt[keep].long()
        if any_hit:
            occ[lanes] |= oc
            continue
        improved = tb < t_best[lanes]
        inst[lanes[improved]] = inst_id
        t_best[lanes], prim[lanes], bu[lanes], bv[lanes] = tb, pb, ub, vb
    if any_hit:
        return (occ,)
    return t_best, prim, inst, bu, bv


def trace_plain(bs: BinaryScene, o, d, t_max):
    """Plain K6 closest hit: (t, prim, inst, bu, bv)."""
    return _walk_plain(bs, o, d, t_max, any_hit=False)


def shadow_plain(bs: BinaryScene, o, d, t_max):
    """Plain K6 any-hit: occlusion within (T_EPS, t_max); bool (N,)."""
    return _walk_plain(bs, o, d, t_max, any_hit=True)[0]


# ---------------------------------------------------------------- kernels

_state: dict[str, object] = {}


def library():
    """(CDLL, build seconds) of csrc/binary_trace.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("binary_trace")
        common = [cu.VP, cu.VP, cu.VP, cu.CI, cu.VP, cu.VP, cu.VP, cu.VP, cu.VP,
                  cu.VP, cu.CI, cu.CI, cu.CI]
        lib.binary_trace_closest.restype = cu.CI
        lib.binary_trace_closest.argtypes = common + [cu.VP] * 7
        lib.binary_trace_shadow.restype = cu.CI
        lib.binary_trace_shadow.argtypes = common + [cu.VP] * 3
        lib.binary_max_depth.restype = cu.CI
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def _launch(bs: BinaryScene, o, d, t_max, any_hit: bool, work=None):
    """Launch K6 on the rays (the counting variant with `work`, 2 zeroed
    int64 on the rays' device). Tables deeper than the kernel's stack are
    refused here; a walk past `bs.depth` fails a device-side assert, which
    the next synchronizing call raises, so nothing is read back."""
    lib, _ = library()
    cap = lib.binary_max_depth()
    if bs.depth > cap:
        raise ValueError(f"binary trace: BVH of depth {bs.depth}; the node stack "
                         f"holds {cap} levels")
    if any(x.data_ptr() % 16 for x in (bs.pairs, bs.roots, bs.tri, bs.sph)):
        raise ValueError("binary trace: records and leaf rows must be 16-byte aligned")
    n = o.shape[0]
    dev = o.device
    args = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, bs.pairs.data_ptr(),
            bs.roots.data_ptr(), bs.tri.data_ptr(), bs.sph.data_ptr(),
            bs.inst_i.data_ptr(), bs.inst_f.data_ptr(), bs.inst_i.shape[0],
            bs.leaf_width, bs.depth]
    tail = [None if work is None else work.data_ptr(), cu.stream_ptr(o)]
    if work is None:
        LAUNCHES["binary_shadow" if any_hit else "binary_closest"] += 1
    if any_hit:
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
        cu.check(lib, "binary", lib.binary_trace_shadow(*args, occ.data_ptr(), *tail))
        return (occ,)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    prim = torch.empty((n,), dtype=torch.int32, device=dev)
    inst = torch.empty_like(prim)
    bu = torch.empty_like(t)
    bv = torch.empty_like(t)
    cu.check(lib, "binary", lib.binary_trace_closest(
        *args, t.data_ptr(), prim.data_ptr(), inst.data_ptr(), bu.data_ptr(),
        bv.data_ptr(), *tail))
    return t, prim, inst, bu, bv


def count_work(bs: BinaryScene, o, d, t_max, any_hit: bool) -> tuple[int, int]:
    """(boxes, primitives) that K6 tests on these rays: on CUDA rays from
    the kernel's counting variant (not a launch of the frame), on CPU rays
    from the plain walk. Both count the skip-index walk's work."""
    if o.device.type == "cpu":
        work = [0, 0]
        _walk_plain(bs, o, d, t_max, any_hit, work)
        return work[0], work[1]
    work = torch.zeros((2,), dtype=torch.int64, device=o.device)
    _launch(bs, o, d, t_max, any_hit, work)
    return int(work[0]), int(work[1])


def trace_binary_raw(bs: BinaryScene, o, d, t_max):
    """K6 closest hit on CUDA rays, its plain version on CPU rays: (t,
    prim, inst, bu, bv) with t = min(t_max, 1e30) and prim = inst = -1
    where nothing below t_max was hit."""
    wide._check_rays(bs.nodes.device, o, d, t_max, "binary trace")
    with telemetry.kernel("binary_closest", o.shape[0]):
        if o.device.type == "cpu":
            return trace_plain(bs, o, d, t_max)
        return _launch(bs, o, d, t_max, any_hit=False)


def trace_closest_binary(bs: BinaryScene, o, d, active=None, t_max=None) -> HitRecord:
    """K6 closest hit as a HitRecord (`traverse_kernel.trace_closest_pallas`);
    t_max 0 marks an inactive lane."""
    t_max = wide._lane_t_max(o, t_max, active)
    t, prim, inst, bu, bv = trace_binary_raw(bs, o, d, t_max)
    miss = prim < 0
    kind = bs.kind_of_inst[torch.clamp(inst, min=0).long()]
    return HitRecord(
        t=torch.where(miss, torch.full_like(t, T_INF), t),
        kind=torch.where(miss, torch.zeros_like(kind), kind),
        prim=prim,
        inst=inst,
        bu=bu,
        bv=bv,
    )


def shadow_occlusion_binary(bs: BinaryScene, o, d, t_max_world, active=None):
    """K6 any-hit: occlusion within (T_EPS, t_max_world), the mask
    `prim >= 0` of the closest walk under that t_max; bool (N,)."""
    t_max = wide._lane_t_max(o, t_max_world, active)
    wide._check_rays(bs.nodes.device, o, d, t_max, "binary trace")
    with telemetry.kernel("binary_shadow", o.shape[0]):
        if o.device.type == "cpu":
            return shadow_plain(bs, o, d, t_max)
        return _launch(bs, o, d, t_max, any_hit=True)[0]
