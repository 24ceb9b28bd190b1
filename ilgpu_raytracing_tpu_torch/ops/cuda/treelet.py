"""Treelet cut of the wide BVH and the treelet-round kernel K7
(csrc/treelet_trace.cu), the port of the JAX package's
`ops/pallas/treelet_kernel.py`.

Host side (numpy, tables identical to the JAX package's):
* `_cut_wide_tree`: the cut shared with the streaming variant
  (ops/cuda/streamtreelet.py) -- a fine split of the largest subtrees,
  Morton order within each instance, contiguous row-balanced bins, and one
  walkable root per bin (synthetic 8-wide wrapper nodes appended to the
  tables);
* `prepare_treelets`: the `TreeletScene` of a `WideScene` -- the extended
  node tables (and their packed node records), per treelet its root,
  instance encoding, world->object affine and object-space box, the TPU
  frontier stack bound, and the wide depth re-derived over the treelet
  roots;
* `treelet_from_numpy`: the same scene from the JAX `TreeletScene`'s arrays.

Device side: `run_treelet_trace` is one visit round (ops/treelet.py drives
the rounds): lane i of the sorted rays walks the treelets set in its
packet's want mask, packet = i // (tile_rows * 128). On CUDA tensors it
launches K7, on CPU tensors it runs the plain version, a per-lane loop over
the mask's treelets around `plain_walk`, the plain form of the kernels'
8-wide closest walk (node_walk.cuh) from a given root.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.models.scene import BLAS_TRI_MESH
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops.cuda import binary, wide
from ilgpu_raytracing_tpu_torch.ops.cuda.wide import (
    _EMPTY,
    _IDENTITY,
    LEAF_WIDTH,
    PP_PRIM_BITS,
    WIDTH,
    WideScene,
    _is_identity,
    _octant_perms,
    _stack_bound,
    _wide_depth,
    check_walk_tables,
)
from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF
from ilgpu_raytracing_tpu_torch.ops.traverse import KIND_SPHERE, KIND_TRI
from ilgpu_raytracing_tpu_torch.utils import telemetry

TILE_ROWS = 32  # packet = TILE_ROWS * 128 sorted lanes (the JAX default)
LANES = 128
MAX_TREELETS = 32  # the want mask is one i32

LAUNCHES = telemetry.counter("launches.treelet", treelet=0)


@dataclasses.dataclass
class TreeletScene:
    """WideScene with extended node tables + a treelet cut of its instances.

    Index T (the last entry of the root/inst/w2o tables) is the dead
    sentinel: its root is -1 and no mask bit reaches it."""

    wscene: WideScene
    t_root: torch.Tensor  # (T+1,) i32 wide node id; [T] = -1
    t_inst: torch.Tensor  # (T+1,) i32 inst_id * 4 + kind
    t_w2o: torch.Tensor  # ((T+1)*12,) f32 world->object affines
    t_bounds: torch.Tensor  # (T, 6) f32 object-space treelet boxes
    t_inst_idx: torch.Tensor  # (T,) i32 index into meta
    inst_spans: tuple = ()  # (meta index, first treelet, end treelet)
    n_treelets: int = 0
    all_identity: bool = True


def _cut_wide_tree(wc_all, wb_all, wp_all, meta, n_target, enc_rows):
    """The treelet cut of `treelet_kernel._cut_wide_tree`: returns (frontier
    entries, extended wc/wb/wp) with synthetic grouping nodes appended.
    `enc_rows` maps a leaf child encoding to its packed row count (1 for the
    wide tables, the leaf's row count for the streaming ones)."""
    n_wide = wc_all.shape[0]
    sub_rows = np.zeros(n_wide, np.int64)

    def count_rows(w):
        # iterative post-order leaf-row count per wide subtree
        stack = [(int(w), False)]
        while stack:
            x, done = stack.pop()
            if done:
                r = 0
                for c in wc_all[x]:
                    if c >= 0:
                        r += sub_rows[c]
                    elif c <= -2:
                        r += enc_rows(int(c))
                sub_rows[x] = max(r, 1)
                continue
            if sub_rows[x]:
                continue
            stack.append((x, True))
            for c in wc_all[x]:
                if c >= 0 and not sub_rows[c]:
                    stack.append((int(c), False))

    def node_bounds(w):
        live = wc_all[w] != _EMPTY
        bs = wb_all[w][live]
        if not live.any():
            return np.zeros(6, np.float32)
        return np.concatenate([bs[:, 0:3].min(0), bs[:, 3:6].max(0)])

    extra_wc: list[np.ndarray] = []
    extra_wb: list[np.ndarray] = []

    def synth_node(children) -> int:
        """New wide node over up to WIDTH (child_enc, bounds6) pairs."""
        assert 1 <= len(children) <= WIDTH
        wid = n_wide + len(extra_wc)
        wc = np.full((WIDTH,), _EMPTY, np.int32)
        wb = np.zeros((WIDTH, 6), np.float32)
        for i, (e, b) in enumerate(children):
            wc[i] = e
            wb[i] = b
        extra_wc.append(wc)
        extra_wb.append(wb)
        return wid

    # phase 1: fine cut -- split the largest subtree until everything is
    # near total / (4 * n_target) rows
    fine: list[dict] = []
    total_rows = 0
    for mi, (_kind, root, _w2o, _wb, _inst) in enumerate(meta):
        count_rows(root)
        fine.append(dict(root=int(root), rows=int(sub_rows[root]), mi=mi,
                         bounds=node_bounds(root), splittable=True))
        total_rows += int(sub_rows[root])
    fine_goal = max(1, total_rows // max(4 * n_target, 1))
    while len(fine) < 64 * n_target:
        cand = None
        for e in sorted(fine, key=lambda x: -x["rows"]):
            if not e["splittable"] or e["rows"] <= fine_goal:
                break
            if e["root"] < n_wide:
                cand = e
                break
            e["splittable"] = False
        if cand is None:
            break
        w = cand["root"]
        fine.remove(cand)
        inner = [int(c) for c in wc_all[w] if c >= 0]
        leaf_ci = [ci for ci in range(WIDTH) if wc_all[w][ci] <= -2]
        for c in inner:
            fine.append(dict(root=c, rows=int(sub_rows[c]), mi=cand["mi"],
                             bounds=node_bounds(c), splittable=True))
        if leaf_ci:
            kids = [(int(wc_all[w][ci]), wb_all[w][ci].copy()) for ci in leaf_ci]
            bb = np.stack([b for _e, b in kids])
            fine.append(dict(
                root=synth_node(kids), rows=sum(enc_rows(e) for e, _b in kids),
                mi=cand["mi"],
                bounds=np.concatenate([bb[:, 0:3].min(0), bb[:, 3:6].max(0)]),
                splittable=False,
            ))
        if not inner and not leaf_ci:
            break

    # phase 2: Morton order of the fine subtrees within each instance
    def morton10(c):
        q = np.clip(c * 1023.0, 0, 1023).astype(np.uint32)
        out = np.uint32(0)
        for b in range(10):
            out |= ((q[0] >> b) & 1) << (3 * b + 2)
            out |= ((q[1] >> b) & 1) << (3 * b + 1)
            out |= ((q[2] >> b) & 1) << (3 * b)
        return int(out)

    by_mi: dict[int, list[dict]] = {}
    for e in fine:
        by_mi.setdefault(e["mi"], []).append(e)
    for mi, es in by_mi.items():
        cents = np.stack([(e["bounds"][0:3] + e["bounds"][3:6]) * 0.5 for e in es])
        lo = cents.min(0)
        ext = np.maximum(cents.max(0) - lo, 1e-12)
        keys = [morton10((c - lo) / ext) for c in cents]
        by_mi[mi] = [e for _k, e in sorted(zip(keys, es), key=lambda p: p[0])]

    # phase 3: contiguous row-balanced bins (<= n_target), never spanning
    # instances; widen the goal until the bins fit
    goal = max(1, -(-total_rows // max(n_target, 1)))
    while True:
        bins: list[list[dict]] = []
        for mi in sorted(by_mi):
            cur: list[dict] = []
            cur_rows = 0
            for e in by_mi[mi]:
                if cur and cur_rows + e["rows"] > goal:
                    bins.append(cur)
                    cur, cur_rows = [], 0
                cur.append(e)
                cur_rows += e["rows"]
            if cur:
                bins.append(cur)
        if len(bins) <= n_target:
            break
        goal = max(goal + 1, int(goal * 1.15))

    # phase 4: one walkable root per bin (synthetic nodes nested 8-wide)
    def bin_root(entries):
        items = [(e["root"], e["bounds"]) for e in entries]
        while len(items) > 1:
            nxt = []
            for i in range(0, len(items), WIDTH):
                grp = items[i:i + WIDTH]
                if len(grp) == 1:
                    nxt.append(grp[0])
                    continue
                bb = np.stack([b for _e, b in grp])
                nxt.append((synth_node(grp),
                            np.concatenate([bb[:, 0:3].min(0), bb[:, 3:6].max(0)])))
            items = nxt
        return items[0]

    frontier = []
    for b in bins:
        root, bounds = bin_root(b)
        frontier.append(dict(root=root, rows=sum(e["rows"] for e in b),
                             mi=b[0]["mi"], bounds=bounds))
    frontier.sort(key=lambda e: e["mi"])

    if extra_wc:
        wc_all = np.concatenate([wc_all, np.stack(extra_wc)], axis=0)
        wb_all = np.concatenate([wb_all, np.stack(extra_wb)], axis=0)
        perms_extra = np.stack([
            _octant_perms(wb_all[n_wide + i], wc_all[n_wide + i])
            for i in range(len(extra_wc))
        ])
        wp_all = np.concatenate([wp_all, perms_extra], axis=0)
    return frontier, wc_all, wb_all, wp_all


def _spans(frontier) -> tuple:
    spans: list[list[int]] = []
    for k, e in enumerate(frontier):
        if not spans or spans[-1][0] != e["mi"]:
            spans.append([e["mi"], k, k + 1])
        else:
            spans[-1][2] = k + 1
    return tuple(tuple(s) for s in spans)


def _inst_enc(meta_entry) -> int:
    kind, _root, _w2o, _wb, inst_id = meta_entry
    return inst_id * 4 + (KIND_TRI if kind == BLAS_TRI_MESH else KIND_SPHERE)


def prepare_treelets(wscene: WideScene, n_target: int = 32) -> TreeletScene:
    """Cut every instance's wide subtree into <= n_target treelets
    (`treelet_kernel.prepare_treelets`); tables land on wscene's device."""
    if not 1 <= n_target <= MAX_TREELETS:
        raise ValueError(f"n_target {n_target} outside [1, {MAX_TREELETS}]")
    frontier, wc_all, wb_all, wp_all = _cut_wide_tree(
        wscene.wide_child.cpu().numpy().reshape(-1, WIDTH).copy(),
        wscene.wide_bounds.cpu().numpy().reshape(-1, WIDTH, 6).copy(),
        wscene.wide_perm.cpu().numpy().reshape(-1, WIDTH).copy(),
        wscene.meta, n_target, lambda c: 1,
    )
    n_t = len(frontier)
    t_root = np.full((n_t + 1,), -1, np.int32)
    t_inst = np.zeros((n_t + 1,), np.int32)
    t_w2o = np.tile(np.array(_IDENTITY, np.float32), n_t + 1).reshape(n_t + 1, 12)
    t_bounds = np.zeros((n_t, 6), np.float32)
    t_inst_idx = np.zeros((n_t,), np.int32)
    for k, e in enumerate(frontier):
        m = wscene.meta[e["mi"]]
        t_root[k] = e["root"]
        t_inst[k] = _inst_enc(m)
        t_w2o[k] = np.asarray(m[2], np.float32)
        t_bounds[k] = e["bounds"]
        t_inst_idx[k] = e["mi"]
    all_identity = all(_is_identity(wscene.meta[e["mi"]][2]) for e in frontier)
    cap = _stack_bound(wc_all, [e["root"] for e in frontier]) + WIDTH
    return treelet_from_numpy(dict(
        wide_child=wc_all.reshape(-1),
        wide_bounds=wb_all.reshape(-1),
        wide_perm=wp_all.reshape(-1).astype(np.int32),
        stack_cap=max(wscene.stack_cap, int(cap), 64),
        t_root=t_root, t_inst=t_inst, t_w2o=t_w2o.reshape(-1), t_bounds=t_bounds,
        t_inst_idx=t_inst_idx, inst_spans=_spans(frontier), n_treelets=n_t,
        all_identity=all_identity,
    ), wscene)


def treelet_from_numpy(tables: dict, wscene: WideScene) -> TreeletScene:
    """TreeletScene from the tables of a treelet prep (this module's or the
    JAX `prepare_treelets`, read out as numpy: the extended wide_child /
    wide_bounds / wide_perm and stack_cap, t_root, t_inst, t_w2o, t_bounds,
    t_inst_idx, inst_spans, n_treelets, all_identity) over the WideScene
    they extend, on its device."""
    dev = wscene.wide_child.device

    def t(name, dtype):
        return torch.as_tensor(np.array(tables[name]), dtype=dtype, device=dev).contiguous()

    wc_all = np.asarray(tables["wide_child"], np.int32).reshape(-1, WIDTH)
    n_t = int(tables["n_treelets"])
    roots = np.asarray(tables["t_root"])[:n_t].tolist()
    ws = dataclasses.replace(
        wscene,
        wide_child=t("wide_child", torch.int32),
        wide_bounds=t("wide_bounds", torch.float32),
        wide_perm=t("wide_perm", torch.int32),
        stack_cap=int(tables["stack_cap"]),
        # the instance walks (K1 cleanup) and the treelet walks
        wide_depth=_wide_depth(wc_all, [m[1] for m in wscene.meta] + roots),
    )
    return TreeletScene(
        wscene=ws,
        t_root=t("t_root", torch.int32),
        t_inst=t("t_inst", torch.int32),
        t_w2o=t("t_w2o", torch.float32),
        t_bounds=t("t_bounds", torch.float32),
        t_inst_idx=t("t_inst_idx", torch.int32),
        inst_spans=tuple(tuple(int(v) for v in s) for s in tables["inst_spans"]),
        n_treelets=n_t,
        all_identity=bool(tables["all_identity"]),
    )


def treelet_arrays(ts: TreeletScene) -> tuple:
    """The device tables one K7 round reads: treelet root / instance /
    affine tables, then the packed node records and the leaf rows."""
    w = ts.wscene
    return (ts.t_root, ts.t_inst, ts.t_w2o, w.nodes, w.tri_rows, w.sph_rows)


# ------------------------------------------------------------- plain walks


def wide_boxes(wb_flat):
    """Child-box reader of the wide tables: (wid, c8) -> (L, 6)."""
    wb = wb_flat.reshape(-1, WIDTH, 6)
    return lambda wid, c8: wb[wid, c8]


def wide_leaf(leaf_width: int):
    """Leaf decoder of the wide tables: enc -> (first row, rows, slots a
    row): one row of min(count, leaf_width) slots."""
    def decode(enc):
        return enc >> 4, torch.ones_like(enc), torch.clamp(enc & 15, max=leaf_width)
    return decode


def plain_walk(wc, wp, boxes, leaf, rows_tbl, is_tri: bool, root: int, o, d,
               inst_bits: int, t_best, pp, stack_cap: int):
    """The plain form of the kernels' 8-wide closest walk (node_walk.cuh) for
    every lane at once, from one `root`: each lane pops its own stack,
    tests the children in the order of its own direction octant, tests a
    hit leaf at once (the first accepted minimum, which is what the kernel's
    sequential `t < t_best` keeps) and pushes hit inner children far-first.
    Its test order (a node's hit leaves by rank, then its inner children's
    subtrees by rank, a leaf's rows and slots in order) decides ties in t;
    the kernels keep it, so they equal this walk in t and pp bit for bit.
    `boxes(wid, c8)` reads child boxes, `leaf(enc)` decodes a leaf into
    (first row, rows, slots a row). Updates t_best and pp (the lanes'
    running record, prim | inst_bits) in place. Raises when a lane's stack
    would exceed stack_cap, as the kernels' stack assert does."""
    n = o.shape[0]
    dev = o.device
    inv = binary.inv_dir(d)
    octant = (((d[:, 0] > 0).long() << 2) | ((d[:, 1] > 0).long() << 1)
              | (d[:, 2] > 0).long())
    wc = wc.reshape(-1, WIDTH).long()
    wp = wp.reshape(-1, WIDTH).long()
    stack = torch.zeros((n, stack_cap), dtype=torch.long, device=dev)
    stack[:, 0] = root
    sp = torch.ones((n,), dtype=torch.long, device=dev)
    idx = torch.arange(n, device=dev)
    slot_w = binary.TRI_SLOT if is_tri else binary.SPH_SLOT
    id_col = binary.TRI_ID if is_tri else binary.SPH_ID
    while idx.numel() > 0:
        sp[idx] -= 1
        wid = stack[idx, sp[idx]]
        perm = wp[wid, octant[idx]]
        ro, rd, ri = o[idx], d[idx], inv[idx]
        inner = torch.zeros((idx.numel(), WIDTH), dtype=torch.bool, device=dev)
        c8s = []
        for rank in range(WIDTH):
            c8 = (perm >> (4 * rank)) & 7
            c8s.append(c8)
            child = wc[wid, c8]
            hit = (child != _EMPTY) & binary.slab(boxes(wid, c8), ro, ri, t_best[idx])
            inner[:, rank] = hit & (child >= 0)
            is_leaf = hit & (child <= -2)
            if not bool(is_leaf.any()):
                continue
            s = idx[is_leaf]
            first, n_rows, n_slots = leaf(-child[is_leaf] - 2)
            r_max = int(n_rows.max())
            ridx = first[:, None] + torch.arange(r_max, device=dev)[None, :]
            rows = rows_tbl[torch.clamp(ridx, max=rows_tbl.shape[0] - 1)]
            rows = rows[..., : LEAF_WIDTH * slot_w].reshape(
                s.numel(), r_max * LEAF_WIDTH, slot_w)
            k = torch.arange(r_max * LEAF_WIDTH, device=dev)[None, :]
            valid = ((k // LEAF_WIDTH) < n_rows[:, None]) & ((k % LEAF_WIDTH)
                                                              < n_slots[:, None])
            if is_tri:
                t, _u, _v, ok = binary.tri_slots(rows, o[s], d[s])
            else:
                t, ok = binary.sph_slots(rows, o[s], d[s])
            mn, j = binary.first_min(t, ok & valid)
            upd = mn < t_best[s]
            w = s[upd]
            t_best[w] = mn[upd]
            ids = rows[..., id_col].to(torch.int32).gather(1, j[:, None])[:, 0]
            pp[w] = ids[upd] + inst_bits
        for rank in range(WIDTH - 1, -1, -1):
            push = inner[:, rank]
            if not bool(push.any()):
                continue
            p = idx[push]
            if bool((sp[p] >= stack_cap).any()):
                raise RuntimeError(f"plain walk: per-thread stack overflow (bound {stack_cap})")
            stack[p, sp[p]] = wc[wid[push], c8s[rank][push]]
            sp[p] += 1
        idx = idx[sp[idx] > 0]
    return t_best, pp


def _check_round(mask, n, tile_rows, device):
    g = -(-n // (tile_rows * LANES))
    if mask.dtype != torch.int32 or tuple(mask.shape) != (g,) or mask.device != device:
        raise ValueError(
            f"treelet round: mask must be int32 ({g},) on {device} for {n} lanes "
            f"in packets of {tile_rows * LANES}, got {mask.dtype} {tuple(mask.shape)} "
            f"on {mask.device}")


def lane_masks(mask, n: int, tile_rows: int):
    """The want mask of each lane's packet, (n,) i32."""
    return torch.repeat_interleave(mask, tile_rows * LANES)[:n]


def treelet_round_plain(n_treelets, t_root, t_inst, t_w2o, all_identity, walk_one,
                        mask, o, d, t_max, tile_rows, prim_bits):
    """Plain K7/K8 round: each lane walks, in increasing k, every treelet k
    set in its packet's mask, from t_root[k], with the running t_best of
    its t_max; `walk_one(root, is_tri, o, d, inst_bits, t_best, pp)` is the
    plain walk of the scene's tables."""
    n = o.shape[0]
    t_best = torch.clamp(t_max, max=T_INF)
    pp = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    want = torch.where(t_max > 0.0, lane_masks(mask, n, tile_rows), 0)
    roots = t_root.tolist()
    encs = t_inst.tolist()
    for k in range(n_treelets):
        lanes = torch.nonzero((want >> k) & 1).squeeze(1)
        if lanes.numel() == 0 or roots[k] < 0:
            continue
        ro, rd = o[lanes], d[lanes]
        if not all_identity:
            ro, rd = binary.transform(t_w2o[12 * k: 12 * k + 12], ro, rd)
        tb, pb = t_best[lanes], pp[lanes]
        walk_one(roots[k], (encs[k] & 3) == KIND_TRI, ro, rd, encs[k] << prim_bits, tb, pb)
        t_best[lanes], pp[lanes] = tb, pb
    return t_best, pp


def round_plain(ts: TreeletScene, mask, o, d, t_max, tile_rows: int = TILE_ROWS):
    """Plain K7: one treelet round over the wide tables."""
    w = ts.wscene
    boxes, leaf = wide_boxes(w.wide_bounds), wide_leaf(w.leaf_width)

    def walk_one(root, is_tri, ro, rd, inst_bits, tb, pb):
        plain_walk(w.wide_child, w.wide_perm, boxes, leaf,
                   w.tri_rows if is_tri else w.sph_rows, is_tri, root, ro, rd,
                   inst_bits, tb, pb, w.thread_stack)

    return treelet_round_plain(ts.n_treelets, ts.t_root, ts.t_inst, ts.t_w2o,
                               ts.all_identity, walk_one, mask, o, d, t_max,
                               tile_rows, PP_PRIM_BITS)


# ---------------------------------------------------------------- kernel

_state: dict[str, object] = {}


def library():
    """(CDLL, build seconds) of csrc/treelet_trace.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("treelet_trace")
        lib.treelet_trace.restype = cu.CI
        lib.treelet_trace.argtypes = (
            [cu.VP, cu.VP, cu.VP, cu.CI, cu.VP, cu.VP, cu.VP, cu.CI, cu.CI, cu.VP,
             cu.CI, cu.VP, cu.VP, cu.VP, cu.CI, cu.CI] + [cu.VP] * 4)
        lib.treelet_max_depth.restype = cu.CI
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def launch_round(lib, prefix: str, tables: list, o, d, t_max, mask, tile_rows: int,
                 treelet_args: list, work=None):
    """Launch `<prefix>_trace` (one K7/K8 round) on the rays: `tables` are
    the walker's arguments, `treelet_args` the treelet tables after the
    mask. Raises on a launch error; a walk past the host's stack bound fails
    a device-side assert (nothing is read back). Returns (t, pp)."""
    n = o.shape[0]
    dev = o.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    pp = torch.empty((n,), dtype=torch.int32, device=dev)
    err = getattr(lib, prefix + "_trace")(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, *tables, mask.data_ptr(),
        tile_rows * LANES, *treelet_args, t.data_ptr(), pp.data_ptr(),
        None if work is None else work.data_ptr(), cu.stream_ptr(o))
    cu.check(lib, prefix, err)
    return t, pp


def _launch(ts: TreeletScene, mask, o, d, t_max, tile_rows, work=None):
    lib, _ = library()
    w = ts.wscene
    check_walk_tables(w, w.nodes, lib.treelet_max_depth(), "treelet round")
    tables = [w.nodes.data_ptr(), w.tri_rows.data_ptr(), w.sph_rows.data_ptr(),
              w.leaf_width, w.wide_depth]
    if work is None:
        LAUNCHES["treelet"] += 1
    return launch_round(lib, "treelet", tables, o, d, t_max, mask, tile_rows,
                        [ts.t_root.data_ptr(), ts.t_inst.data_ptr(),
                         ts.t_w2o.data_ptr(), ts.n_treelets, int(ts.all_identity)],
                        work)


def count_work(ts: TreeletScene, mask, o, d, t_max, tile_rows: int = TILE_ROWS):
    """(boxes, primitives) that one K7 round tests on these CUDA rays, from
    the kernel's counting variant; not a launch of a round."""
    work = torch.zeros((2,), dtype=torch.int64, device=o.device)
    _launch(ts, mask, o, d, t_max, tile_rows, work)
    return int(work[0]), int(work[1])


def run_treelet_trace(ts: TreeletScene, mask, o, d, t_max, tile_rows: int = TILE_ROWS):
    """K7, one treelet round (`treelet_kernel.run_treelet_trace`): packet p
    of tile_rows * 128 consecutive lanes walks exactly the treelets set in
    mask[p]. Returns (t, pp): t <= t_max everywhere, pp = -1 where this
    round found no hit below t_max."""
    wide._check_rays(ts.t_root.device, o, d, t_max, "treelet round")
    _check_round(mask, o.shape[0], tile_rows, o.device)
    with telemetry.kernel("treelet", o.shape[0]):
        if o.device.type == "cpu":
            return round_plain(ts, mask, o, d, t_max, tile_rows)
        return _launch(ts, mask, o, d, t_max, tile_rows)
