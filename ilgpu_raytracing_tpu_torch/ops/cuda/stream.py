"""Large-scene prep and the streaming trace kernels K4/K5
(csrc/stream_trace.cu), for scenes of 150k to 4M triangles.

Host side (numpy), ported from the JAX package's
`ops/pallas/stream_kernel.py`:
* `prepare_stream`: coarse multi-row leaves (up to ROWS_PER_LEAF rows of 8
  triangles, encoded `-(first_row * 32 + n_rows) - 2`), packed in one
  vectorized scatter; each instance's binary subtree collapsed to 8-wide
  nodes; per-octant child orders; the TPU frontier stack bound; the
  barycentric epilogue tables; the treelet sort-key boxes;
* `_quantize_bounds`: u8 child boxes against a per-node frame, rounded
  outward in the kernel's own float32 dequantization.
Tables are identical to the JAX package's. As in ops/cuda/wide.py, the
static `meta` tuple also becomes a device instance table, and the wide
depth is derived for the kernels: the node-group stacks of K4 and K5 hold
`depth` entries (the plain walk's per-lane DFS bound is 7 * depth + 1).
The kernels read the node tables packed into one 128-byte record per node,
`anyhit_nodes` (`pack_anyhit_nodes`), and K4 also `wide_perm`.

Device side: `trace_closest_stream_packed` (K4) and
`shadow_occlusion_stream` (K5) launch the CUDA kernels on CUDA tensors and
run their plain versions on CPU tensors: the per-lane skip-index walk of
ops/traverse.py over the SceneData the StreamScene was prepared from,
packed into the 23-bit record. `decode_stream_hits` is the epilogue.
`with_mesh` splits both wrappers' rays over a device mesh as
ops/cuda/wide.py does (stream_kernel.with_mesh).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.models.bvh import cut_scene_treelets
from ilgpu_raytracing_tpu_torch.models.scene import (
    BLAS_SPHERE_SET,
    BLAS_TRI_MESH,
    SceneData,
)
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops import traverse
from ilgpu_raytracing_tpu_torch.ops.cuda.wide import (
    _EMPTY,
    _IDENTITY,
    _LANES,
    LEAF_WIDTH,
    SPH_STRIDE,
    TRI_STRIDE,
    WIDTH,
    _check_rays,
    _decode_pp,
    _instance_tables,
    _lane_t_max,
    _octant_perms,
    _pp_to_record,
    _scene_needs_bary,
    _shard_ray_op,
    _stack_bound,
    _wide_depth,
    check_walk_tables,
    launch_walk,
    plain_closest_packed,
)
from ilgpu_raytracing_tpu_torch.ops.cuda.wide import with_mesh as _wide_with_mesh
from ilgpu_raytracing_tpu_torch.ops.traverse import HitRecord

ROWS_PER_LEAF = 16  # up to 128 triangles per leaf
_ENC_BASE = 32  # leaf encoding: 5 bits of row count (1..16), row index above
SPP_PRIM_BITS = 23  # packed record: prim id below, inst*4+kind above
MAX_TRIS = 4_000_000
TREELETS = 32  # boxes of the destination-treelet sort key

LAUNCHES = {"stream_closest": 0, "stream_shadow": 0}


def with_mesh(ss: StreamScene, mesh) -> StreamScene:
    """Attach a device mesh: traces split rays over mesh axis "px", block
    k traced by K4/K5 against a replica of the tables on mesh.devices[k]
    (ops/cuda/wide.with_mesh)."""
    return _wide_with_mesh(ss, mesh)


def supports_scene(scene: SceneData, max_tris: int | None = None) -> bool:
    """True when the streaming kernels take the scene (<= max_tris, default
    MAX_TRIS, triangles)."""
    return scene.tri_v0.shape[0] <= (MAX_TRIS if max_tris is None else max_tris)


def _leaf_enc(first_row: int, n_rows: int) -> int:
    if not 1 <= n_rows <= ROWS_PER_LEAF:
        raise ValueError(f"leaf of {n_rows} rows outside [1, {ROWS_PER_LEAF}]")
    return -(first_row * _ENC_BASE + n_rows) - 2


@dataclasses.dataclass
class StreamScene:
    """Device tables of the streaming kernels plus the scene they came from."""

    wide_frame: torch.Tensor  # (W*6,) f32: per node lo.xyz, (ext/255).xyz
    wide_qbounds: torch.Tensor  # (W*16,) i32: per child 2 words of 6 u8s
    wide_child: torch.Tensor  # (W*8,) i32
    wide_perm: torch.Tensor  # (W*8,) i32 per-octant child order
    tri_rows: torch.Tensor  # (Lt+16, 128) f32 multi-row triangle leaves
    sph_rows: torch.Tensor  # (Ls, 128) f32
    tri_v0e: torch.Tensor  # (T, 9) f32 barycentric-epilogue rows
    inst_w2o: torch.Tensor  # (I, 12) f32
    sortkey_bounds: torch.Tensor  # (T<=32, 6) f32 world treelet boxes
    inst_i: torch.Tensor  # (n_inst,4) i32: kind, wide root, inst_id, identity
    inst_f: torch.Tensor  # (n_inst,18) f32: w2o 12, world bounds 6
    scene: SceneData  # the plain versions trace this, alpha off as in the kernels
    meta: tuple = ()
    rows_per_leaf: int = ROWS_PER_LEAF  # most rows of any leaf
    stack_cap: int = 256  # TPU frontier bound (table parity with the JAX prep)
    wide_depth: int = 0  # most inner wide nodes on a root-to-leaf chain
    needs_bary: bool = True
    # set by `with_mesh` (as on WideScene)
    mesh: object = None
    replicas: object = None
    # (W, 32) i32 node records of K4, K5 and K8, derived from the wide tables
    anyhit_nodes: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.anyhit_nodes = pack_anyhit_nodes(self.wide_frame, self.wide_qbounds,
                                              self.wide_child)

    @property
    def thread_stack(self) -> int:
        """The plain walk's per-lane DFS bound (as WideScene.thread_stack)."""
        return 7 * self.wide_depth + 1


def pack_anyhit_nodes(wide_frame, wide_qbounds, wide_child) -> torch.Tensor:
    """The node table of the streaming kernels (csrc/stream_nodes.cuh): per
    wide node one 128-byte record of 32 int32 words, the frame (lo.xyz,
    scale.xyz as float32 bits), two zero words, the 16 quantized-box words
    and the 8 child words, on the tables' device."""
    w = wide_child.numel() // WIDTH
    return torch.cat([
        wide_frame.view(torch.int32).view(w, 6),
        torch.zeros((w, 2), dtype=torch.int32, device=wide_child.device),
        wide_qbounds.view(w, 16), wide_child.view(w, WIDTH),
    ], dim=1).contiguous()


def prepare_stream(scene: SceneData) -> StreamScene:
    """Repack a committed scene with coarse multi-row leaves
    (stream_kernel.prepare_stream); tables land on `scene`'s device. Build
    the scene with blas_leaf_size <= ROWS_PER_LEAF * 8 (128)."""
    ifields = scene.blas_ifields.cpu().numpy().copy()
    bounds = np.concatenate(
        [scene.blas_bmin.cpu().numpy(), scene.blas_bmax.cpu().numpy()], axis=1
    )
    nn = ifields.shape[0]
    tri_prim = scene.tri_prim_idx.cpu().numpy()
    sph_prim = scene.sphere_prim_idx.cpu().numpy()
    tri_v0 = scene.tri_v0.cpu().numpy()
    tri_e1 = scene.tri_e1.cpu().numpy()
    tri_e2 = scene.tri_e2.cpu().numpy()
    sph_c = scene.sph_center.cpu().numpy()
    sph_r = scene.sph_radius.cpu().numpy()
    roots = scene.inst_blas_root.cpu().numpy()
    w2o_all = scene.inst_w2o.cpu().numpy()
    bmin_all = scene.inst_bmin.cpu().numpy()
    bmax_all = scene.inst_bmax.cpu().numpy()

    inst_types = {}
    for i in scene.sph_instances.tolist():
        inst_types[i] = BLAS_SPHERE_SET
    for i in scene.tri_instances.tolist():
        inst_types[i] = BLAS_TRI_MESH

    # tri leaves are only registered during the walk (first, count, first
    # row); the packing happens once, vectorized, after it
    tri_leaves: list[tuple[int, int, int]] = []
    tri_row_count = 0
    sph_rows: list[np.ndarray] = []

    def pack_tri_leaf(first: int, count: int) -> tuple[int, int]:
        nonlocal tri_row_count
        first_row = tri_row_count
        n_rows = -(-count // LEAF_WIDTH)
        if n_rows > ROWS_PER_LEAF:
            raise ValueError(
                f"leaf of {count} tris needs {n_rows} rows > {ROWS_PER_LEAF}; "
                f"build with blas_leaf_size <= {ROWS_PER_LEAF * LEAF_WIDTH}"
            )
        tri_leaves.append((first, count, first_row))
        tri_row_count += n_rows
        return first_row, n_rows

    def pack_sph_leaf(first: int, count: int) -> int:
        if count > LEAF_WIDTH:
            raise ValueError(f"sphere leaf of {count} > {LEAF_WIDTH} spheres")
        row = np.zeros((_LANES,), np.float32)
        for j in range(count):
            p = int(sph_prim[first + j])
            base = j * SPH_STRIDE
            row[base: base + 3] = sph_c[p]
            row[base + 3] = sph_r[p]
            row[base + 4] = np.float32(p)
        sph_rows.append(row)
        return len(sph_rows) - 1

    def is_leaf(b: int) -> bool:
        return ifields[b, 2] > 0

    # binary leaf -> (first row, rows), then the 8-wide collapse
    leaf_rows: dict[int, tuple[int, int]] = {}
    max_rows = 1
    for inst_id, kind in sorted(inst_types.items()):
        stack = [int(roots[inst_id])]
        while stack:
            cur = stack.pop()
            if cur < 0 or cur >= nn or cur in leaf_rows:
                continue
            left, first, count, _skip = ifields[cur]
            if count > 0:
                if kind == BLAS_TRI_MESH:
                    leaf_rows[cur] = pack_tri_leaf(int(first), int(count))
                    max_rows = max(max_rows, leaf_rows[cur][1])
                else:
                    leaf_rows[cur] = (pack_sph_leaf(int(first), int(count)), 1)
            else:
                stack.append(int(left))
                stack.append(cur + 1)

    wide_bounds: list[np.ndarray] = []
    wide_child: list[np.ndarray] = []

    def new_node() -> tuple[int, np.ndarray, np.ndarray]:
        wb = np.zeros((WIDTH, 6), np.float32)
        wc = np.full((WIDTH,), _EMPTY, np.int32)
        wide_bounds.append(wb)
        wide_child.append(wc)
        return len(wide_child) - 1, wb, wc

    def collapse(b_root: int) -> int:
        # gather up to WIDTH binary descendants (leaves stay, inners expand)
        entries = [b_root]
        while len(entries) < WIDTH:
            idx = next((i for i, e in enumerate(entries) if not is_leaf(e)), None)
            if idx is None:
                break
            b = entries.pop(idx)
            entries.insert(idx, b + 1)  # right subtree emitted after the node
            entries.insert(idx, int(ifields[b, 0]))
        wid, wb, wc = new_node()
        for c, b in enumerate(entries):
            wb[c] = bounds[b]
            wc[c] = _leaf_enc(*leaf_rows[b]) if is_leaf(b) else collapse(b)
        return wid

    meta = []
    for inst_id, kind in sorted(inst_types.items()):
        root = int(roots[inst_id])
        if is_leaf(root):
            # single-leaf instance -> wide node with one child
            wid, wb, wc = new_node()
            wb[0] = bounds[root]
            wc[0] = _leaf_enc(*leaf_rows[root])
        else:
            wid = collapse(root)
        w2o = tuple(w2o_all[inst_id].reshape(-1).tolist())
        wbnd = tuple(bmin_all[inst_id].tolist() + bmax_all[inst_id].tolist())
        meta.append((int(kind), wid, w2o, wbnd, int(inst_id)))

    wb_all = np.stack(wide_bounds)
    wc_all = np.stack(wide_child)
    perms = np.stack([_octant_perms(wb_all[i], wc_all[i]) for i in range(len(wc_all))])
    wf_all, wq_all = _quantize_bounds(wb_all, wc_all)
    cap = _stack_bound(wc_all, [m[1] for m in meta]) + WIDTH
    if cap > 16384:
        raise ValueError(
            f"wide BVH needs a {cap}-entry traversal stack (pathologically "
            f"deep/unbalanced tree); rebuild with a different BVH method"
        )

    # one vectorized pack of every tri leaf: leaf tris occupy contiguous flat
    # slots [row_start*8, row_start*8+count) of a (rows*8, stride) view;
    # ROWS_PER_LEAF zero rows of padding at the end, as the JAX tables have
    total_rows = max(1, tri_row_count)
    tri = np.zeros((total_rows + ROWS_PER_LEAF, _LANES), np.float32)
    if tri_leaves:
        firsts, counts, starts = (np.asarray(c, np.int64) for c in zip(*tri_leaves))
        tot = int(counts.sum())
        ends = np.cumsum(counts)
        within = np.arange(tot, dtype=np.int64) - np.repeat(ends - counts, counts)
        src = np.repeat(firsts, counts) + within
        dst = np.repeat(starts * LEAF_WIDTH, counts) + within
        pidx = tri_prim[src]
        flat = np.zeros((total_rows * LEAF_WIDTH, TRI_STRIDE), np.float32)
        flat[dst, 0:3] = tri_v0[pidx]
        flat[dst, 3:6] = tri_e1[pidx]
        flat[dst, 6:9] = tri_e2[pidx]
        flat[dst, 9] = pidx.astype(np.float32)
        tri[:total_rows, : LEAF_WIDTH * TRI_STRIDE] = flat.reshape(
            total_rows, LEAF_WIDTH * TRI_STRIDE
        )

    # packed-record bounds: prim ids fit SPP_PRIM_BITS, instance encodings
    # fit above them, leaf encodings fit an int32
    n_prims = max(int(scene.tri_v0.shape[0]), int(scene.sph_center.shape[0]))
    if n_prims > (1 << SPP_PRIM_BITS):
        raise ValueError(
            f"{n_prims} primitives overflow the {SPP_PRIM_BITS}-bit packed hit record"
        )
    max_inst = max((m[4] for m in meta), default=0)
    if max_inst * 4 + 3 >= (1 << (31 - SPP_PRIM_BITS)):
        raise ValueError(f"instance id {max_inst} overflows the packed hit record")
    if (total_rows + ROWS_PER_LEAF) * _ENC_BASE >= (1 << 31) - 2:
        raise ValueError(f"{total_rows} leaf rows overflow the leaf encoding")
    inst_w2o = np.tile(np.array(_IDENTITY, np.float32), (max_inst + 1, 1))
    for _kind, _wid, w2o, _wb, inst_id in meta:
        inst_w2o[inst_id] = np.asarray(w2o, np.float32)

    sph_table = np.stack(sph_rows) if sph_rows else np.zeros((1, _LANES), np.float32)
    return stream_from_numpy(
        dict(
            wide_frame=wf_all.reshape(-1),
            wide_qbounds=wq_all.reshape(-1),
            wide_child=wc_all.reshape(-1),
            wide_perm=perms.reshape(-1).astype(np.int32),
            sortkey_bounds=cut_scene_treelets(scene, TREELETS),
            tri_rows=tri,
            sph_rows=sph_table,
            tri_v0e=np.concatenate([tri_v0, tri_e1, tri_e2], axis=1),
            inst_w2o=inst_w2o,
            meta=tuple(meta),
            rows_per_leaf=max_rows,
            stack_cap=max(int(cap), 64),
            needs_bary=_scene_needs_bary(scene),
        ),
        scene,
    )


def _quantize_bounds(wb_all: np.ndarray, wc_all: np.ndarray):
    """u8-quantize per-child AABBs against each node's own frame.

    Returns (wf, wq): wf (n,6) f32 rows of [lo.xyz, scale.xyz] with scale =
    ext/255, and wq (n,16) i32, two words per child packing qlo.xyz | qhi.x
    and qhi.y | qhi.z as bytes. The boxes are checked OUTWARD-conservative
    against the dequantization the kernels perform (lo + f32(q) * scale,
    unfused), with a 2-ulp margin, so a walk can only visit a superset of
    the exact-bounds visits and hit results are unchanged."""
    lo = wb_all[:, :, 0:3].astype(np.float32)
    hi = wb_all[:, :, 3:6].astype(np.float32)
    occ = (wc_all != _EMPTY)[:, :, None]
    flo64 = np.where(occ, lo, np.inf).min(axis=1).astype(np.float64)
    fhi64 = np.where(occ, hi, -np.inf).max(axis=1).astype(np.float64)
    flo = flo64.astype(np.float32)
    over = flo.astype(np.float64) > flo64
    flo = np.where(over, np.nextafter(flo, np.float32(-np.inf)), flo)
    fs = ((fhi64 - flo.astype(np.float64)) / 255.0).astype(np.float32)
    # the frame's top (q=255) must cover fhi in f32
    for _ in range(4):
        top = flo + np.float32(255.0) * fs
        short = top.astype(np.float64) < fhi64
        if not short.any():
            break
        fs = np.where(short, np.nextafter(fs, np.float32(np.inf)), fs)

    flo_b = flo[:, None, :]
    fs_b = fs[:, None, :]
    with np.errstate(divide="ignore", invalid="ignore"):
        qlo = np.floor((lo - flo_b) / fs_b)
        qhi = np.ceil((hi - flo_b) / fs_b)
    qlo = np.clip(np.nan_to_num(qlo, nan=0.0, posinf=255.0, neginf=0.0), 0, 255)
    qhi = np.clip(np.nan_to_num(qhi, nan=0.0, posinf=255.0, neginf=0.0), 0, 255)
    # conservative fix-up in the kernels' own f32 arithmetic, 2-ulp margin
    lo_t = np.nextafter(np.nextafter(lo, np.float32(-np.inf)), np.float32(-np.inf))
    hi_t = np.nextafter(np.nextafter(hi, np.float32(np.inf)), np.float32(np.inf))
    for _ in range(8):
        dlo = flo_b + qlo.astype(np.float32) * fs_b
        dhi = flo_b + qhi.astype(np.float32) * fs_b
        bad_lo = occ & (dlo > lo_t) & (qlo > 0)
        bad_hi = occ & (dhi < hi_t) & (qhi < 255)
        if not (bad_lo.any() or bad_hi.any()):
            break
        qlo = np.where(bad_lo, qlo - 1, qlo)
        qhi = np.where(bad_hi, qhi + 1, qhi)
    dlo = flo_b + qlo.astype(np.float32) * fs_b
    dhi = flo_b + qhi.astype(np.float32) * fs_b
    occm = np.broadcast_to(occ, dlo.shape)
    if not ((dlo[occm] <= lo[occm]).all() and (dhi[occm] >= hi[occm]).all()):
        raise ValueError("quantized child bounds failed to cover exact bounds")

    q = np.concatenate([qlo, qhi], axis=2).astype(np.uint32)  # (n,8,6)
    w0 = q[:, :, 0] | (q[:, :, 1] << 8) | (q[:, :, 2] << 16) | (q[:, :, 3] << 24)
    w1 = q[:, :, 4] | (q[:, :, 5] << 8)
    wq = np.stack([w0, w1], axis=2).reshape(len(q), 16).view(np.int32)
    wf = np.concatenate([flo, fs], axis=1).astype(np.float32)  # (n,6)
    return wf, wq


def stream_from_numpy(tables: dict, scene: SceneData) -> StreamScene:
    """StreamScene from the tables of a stream prep (this module's or the
    JAX package's `prepare_stream`, read out as numpy), on `scene`'s
    device."""
    dev = scene.device
    meta = tuple(
        (int(k), int(r), tuple(float(v) for v in w2o), tuple(float(v) for v in wb),
         int(i))
        for k, r, w2o, wb, i in tables["meta"]
    )
    wc_all = np.asarray(tables["wide_child"], np.int32).reshape(-1, WIDTH)
    inst_i, inst_f = _instance_tables(meta, dev)

    def t(name, dtype):
        return torch.as_tensor(np.array(tables[name]), dtype=dtype,
                               device=dev).contiguous()

    return StreamScene(
        wide_frame=t("wide_frame", torch.float32),
        wide_qbounds=t("wide_qbounds", torch.int32),
        wide_child=t("wide_child", torch.int32),
        wide_perm=t("wide_perm", torch.int32),
        tri_rows=t("tri_rows", torch.float32),
        sph_rows=t("sph_rows", torch.float32),
        tri_v0e=t("tri_v0e", torch.float32),
        inst_w2o=t("inst_w2o", torch.float32),
        sortkey_bounds=t("sortkey_bounds", torch.float32),
        inst_i=inst_i,
        inst_f=inst_f,
        scene=dataclasses.replace(scene, has_alpha=False),
        meta=meta,
        rows_per_leaf=int(tables["rows_per_leaf"]),
        stack_cap=int(tables["stack_cap"]),
        wide_depth=_wide_depth(wc_all, [m[1] for m in meta]),
        needs_bary=bool(tables["needs_bary"]),
    )


# ---------------------------------------------------------------- kernels

_state: dict[str, object] = {}


def library():
    """(CDLL, build seconds) of csrc/stream_trace.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("stream_trace")
        lib.stream_trace_closest.restype = cu.CI
        lib.stream_trace_closest.argtypes = (
            [cu.VP, cu.VP, cu.VP, cu.CI] + [cu.VP] * 6 + [cu.CI] * 2 + [cu.VP] * 4)
        lib.stream_trace_anyhit.restype = cu.CI
        lib.stream_trace_anyhit.argtypes = (
            [cu.VP, cu.VP, cu.VP, cu.CI] + [cu.VP] * 5 + [cu.CI] * 2 + [cu.VP] * 4)
        lib.stream_max_depth.restype = cu.CI
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def _launch_anyhit(ss: StreamScene, o, d, t_max, work=None, warp_max=None):
    """K5 on the rays: (occ,). With `work` (2 zeroed int64) and `warp_max`
    (`_warp_slots`: a zeroed int32 per 32 rays, enough for any warp) the counting
    variant runs and adds the boxes and primitives tested to `work` and
    each lane's boxes + primitives to its warp's max slot."""
    lib, _ = library()
    check_walk_tables(ss, ss.anyhit_nodes, lib.stream_max_depth(), "stream any-hit")
    n = o.shape[0]
    occ = torch.empty((n,), dtype=torch.bool, device=o.device)
    err = lib.stream_trace_anyhit(
        o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, ss.anyhit_nodes.data_ptr(),
        ss.tri_rows.data_ptr(), ss.sph_rows.data_ptr(), ss.inst_i.data_ptr(),
        ss.inst_f.data_ptr(), ss.inst_i.shape[0], ss.wide_depth, occ.data_ptr(),
        None if work is None else work.data_ptr(),
        None if warp_max is None else warp_max.data_ptr(), cu.stream_ptr(o))
    cu.check(lib, "stream", err)
    if work is None:
        LAUNCHES["stream_shadow"] += 1
    return (occ,)


def _launch(ss: StreamScene, o, d, t_max, any_hit: bool, work=None):
    if any_hit:
        return _launch_anyhit(ss, o, d, t_max, work,
                              None if work is None else _warp_slots(o))
    lib, _ = library()
    check_walk_tables(ss, ss.anyhit_nodes, lib.stream_max_depth(), "stream trace")
    tables = [
        ss.anyhit_nodes.data_ptr(), ss.wide_perm.data_ptr(),
        ss.tri_rows.data_ptr(), ss.sph_rows.data_ptr(),
        ss.inst_i.data_ptr(), ss.inst_f.data_ptr(), ss.inst_i.shape[0],
    ]
    if work is None:
        LAUNCHES["stream_closest"] += 1
    return launch_walk(lib, "stream", tables, ss.wide_depth, o, d, t_max,
                       False, work)


def _warp_slots(o) -> torch.Tensor:
    return torch.zeros((max(1, -(-o.shape[0] // 32)),), dtype=torch.int32,
                       device=o.device)


def count_work(ss: StreamScene, o, d, t_max, any_hit: bool) -> tuple[int, int]:
    """(boxes, primitives) that K4 (K5 with `any_hit`) tests on these CUDA
    rays, from the kernel's counting variant; not a launch of the frame."""
    work = torch.zeros((2,), dtype=torch.int64, device=o.device)
    _launch(ss, o, d, t_max, any_hit, work)
    return int(work[0]), int(work[1])


def anyhit_warp_steps(ss: StreamScene, o, d, t_max) -> tuple[int, int]:
    """K5's SIMD-efficiency count on these CUDA rays, from its counting
    variant: (the lanes' boxes + primitives tested, summed; each warp's
    slowest lane's boxes + primitives, summed). The first over 32 x the
    second is the share of lane slots the walk keeps busy."""
    work = torch.zeros((2,), dtype=torch.int64, device=o.device)
    warp_max = _warp_slots(o)
    _launch_anyhit(ss, o, d, t_max, work, warp_max)
    return int(work.sum()), int(warp_max.long().sum())


def trace_closest_plain(ss: StreamScene, o, d, t_max):
    """Plain K4: the skip-index walk on ss.scene, 23-bit prim record."""
    return plain_closest_packed(ss.scene, o, d, t_max, SPP_PRIM_BITS)


def shadow_plain(ss: StreamScene, o, d, t_max):
    """Plain K5: any-hit walk of ops/traverse.py on ss.scene."""
    return traverse.shadow_occlusion(ss.scene, o, d, t_max, active=t_max > 0.0)


def trace_closest_stream_packed(ss: StreamScene, o, d, active=None, t_max=None):
    """K4: closest hit as the packed record (t, pp), pp = prim |
    (inst*4+kind) << 23, miss = -1; t_max 0 marks an inactive lane."""
    t_max = _lane_t_max(o, t_max, active)
    _check_rays(ss.wide_child.device, o, d, t_max, "stream trace")
    if ss.mesh is not None:
        return _shard_ray_op(ss, lambda rep, oo, dd, tm: trace_closest_stream_packed(
            rep, oo, dd, t_max=tm), o, d, t_max)
    if o.device.type == "cpu":
        return trace_closest_plain(ss, o, d, t_max)
    return _launch(ss, o, d, t_max, any_hit=False)


def shadow_occlusion_stream(ss: StreamScene, o, d, t_max_world, active=None):
    """K5: any-hit occlusion within (T_EPS, t_max_world); bool (N,)."""
    t_max = _lane_t_max(o, t_max_world, active)
    _check_rays(ss.wide_child.device, o, d, t_max, "stream trace")
    if ss.mesh is not None:
        return _shard_ray_op(ss, shadow_occlusion_stream, o, d, t_max)
    if o.device.type == "cpu":
        return shadow_plain(ss, o, d, t_max)
    return _launch(ss, o, d, t_max, any_hit=True)[0]


def decode_stream_hits(ss: StreamScene, o, d, t, pp) -> HitRecord:
    """Epilogue of K4: packed record -> HitRecord, in whatever lane order
    (o, d, t, pp) share; barycentrics only when the scene needs them."""
    return _pp_to_record(*_decode_pp(
        ss.tri_v0e, ss.inst_w2o, o, d, t, pp, ss.needs_bary, SPP_PRIM_BITS
    ))


def trace_closest_stream(ss: StreamScene, o, d, active=None, t_max=None) -> HitRecord:
    t, pp = trace_closest_stream_packed(ss, o, d, active=active, t_max=t_max)
    return decode_stream_hits(ss, o, d, t, pp)
