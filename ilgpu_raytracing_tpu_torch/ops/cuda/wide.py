"""Kernel-scene prep and the wide-BVH trace kernels K1/K2 (csrc/wide_trace.cu).

Host side (numpy), ported from the JAX package:
* `prepare` = `traverse_kernel.prepare`: leaf primitives packed 8 per
  128-float row (triangles v0 e1 e2 id, spheres center radius id), leaf
  `first` rewritten to row index, per-instance meta;
* `prepare_wide` = `wide_kernel.prepare_wide`: each instance's binary
  subtree collapsed to 8-wide nodes, per-octant child orders, the TPU
  frontier stack bound, the barycentric epilogue tables.
Tables are identical to the JAX package's. The static `meta` tuple also
becomes a device instance table (`inst_i`: kind, wide root, inst_id,
is-identity; `inst_f`: w2o 12 floats, world bounds 6 floats), and the wide
depth is derived for the kernels: their node-group stacks hold `depth`
entries (the plain walk's per-lane DFS bound is 7 * depth + 1). The kernels
read the node tables packed into one 256-byte record per node, `nodes`
(`pack_wide_nodes`).

Device side: `trace_closest_wide_packed` (K1) and `shadow_occlusion_wide`
(K2) launch the CUDA kernels on CUDA tensors and run their plain versions
on CPU tensors: the per-lane skip-index walk of ops/traverse.py over the
SceneData the WideScene was prepared from, wrapped to the kernel's packed
`(t, pp)` / `occ` format. `decode_wide_hits` is the epilogue.

Multi-device (wide_kernel.with_mesh): `with_mesh(ws, mesh)` replicates the
tables onto each distinct device of a `parallel.sharding` mesh, and both
wrappers then split their rays (`_shard_ray_op`): padded to a multiple of
the mesh size with inactive lanes, block k traced on `mesh.devices[k]` by
the same kernel against that device's replica, every block issued before
the first copy back, the outputs concatenated on the rays' device. The
result equals the unsharded call bit for bit.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.models.scene import (
    BLAS_SPHERE_SET,
    BLAS_TRI_MESH,
    SceneData,
)
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops import traverse
from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF, intersect_triangle
from ilgpu_raytracing_tpu_torch.ops.traverse import KIND_TRI, HitRecord
from ilgpu_raytracing_tpu_torch.parallel import sharding as shrd
from ilgpu_raytracing_tpu_torch.utils import vec

_LANES = 128
TRI_STRIDE = 12  # v0(3) e1(3) e2(3) prim_id_f32 pad(2)
SPH_STRIDE = 16  # center(3) radius prim_id_f32 pad(11)
LEAF_WIDTH = 8  # prims per leaf row
WIDTH = 8
MAX_FRONT = 8  # frontier width the TPU stack bound is simulated at
_EMPTY = -1  # child encodings: >=0 inner wide id; -1 empty; <=-2 leaf
_Q_MASK_SHIFT = 24
PP_PRIM_BITS = 20
MAX_TRIS = 150_000

LAUNCHES = {"wide_closest": 0, "wide_shadow": 0}

_IDENTITY = (1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)


# ---------------------------------------------------------------- host prep


@dataclasses.dataclass
class PackedScene:
    """Host port of traverse_kernel.PallasScene (numpy tables)."""

    nodes_rows: np.ndarray  # (Nn, 128) f32: bmin3 bmax3 in lanes 0..5
    node_ifields: np.ndarray  # (Nn*4,) i32 (left, first_row, count, skip)
    tri_rows: np.ndarray  # (Lt, 128) f32 leaf-packed triangles
    sph_rows: np.ndarray  # (Ls, 128) f32 leaf-packed spheres
    meta: tuple  # per instance (kind, root, w2o 12, bounds 6, inst_id)
    leaf_width: int = LEAF_WIDTH
    needs_bary: bool = True


def supports_scene(scene: SceneData, max_tris: int | None = None) -> bool:
    """True when the wide kernels take the scene (<= max_tris, default
    MAX_TRIS, triangles)."""
    return scene.tri_v0.shape[0] <= (MAX_TRIS if max_tris is None else max_tris)


def _scene_needs_bary(scene: SceneData) -> bool:
    """True when a triangle material samples a diffuse texture or the scene
    has alpha cutouts -- the only consumers of hit barycentrics."""
    if bool(scene.has_alpha):
        return True
    tri_mat = scene.tri_mat.cpu().numpy()
    if tri_mat.size == 0:
        return False
    dtex = scene.mat_diffuse_tex.cpu().numpy()
    if dtex.size == 0:
        return False
    used = dtex[np.clip(tri_mat, 0, dtex.shape[0] - 1)]
    return bool((used >= 0).any())


def prepare(scene: SceneData) -> PackedScene:
    """Repack a committed scene into leaf rows (traverse_kernel.prepare)."""
    ifields = scene.blas_ifields.cpu().numpy().copy()
    nn = ifields.shape[0]
    nodes_rows = np.zeros((nn, _LANES), np.float32)
    nodes_rows[:, 0:3] = scene.blas_bmin.cpu().numpy()
    nodes_rows[:, 3:6] = scene.blas_bmax.cpu().numpy()

    tri_prim = scene.tri_prim_idx.cpu().numpy()
    sph_prim = scene.sphere_prim_idx.cpu().numpy()
    tri_v0 = scene.tri_v0.cpu().numpy()
    tri_e1 = scene.tri_e1.cpu().numpy()
    tri_e2 = scene.tri_e2.cpu().numpy()
    sph_c = scene.sph_center.cpu().numpy()
    sph_r = scene.sph_radius.cpu().numpy()
    w2o_all = scene.inst_w2o.cpu().numpy()
    bmin_all = scene.inst_bmin.cpu().numpy()
    bmax_all = scene.inst_bmax.cpu().numpy()
    roots = scene.inst_blas_root.cpu().numpy()

    inst_types = {}
    for i in scene.sph_instances.tolist():
        inst_types[i] = BLAS_SPHERE_SET
    for i in scene.tri_instances.tolist():
        inst_types[i] = BLAS_TRI_MESH

    tri_rows: list[np.ndarray] = []
    sph_rows: list[np.ndarray] = []
    max_count = 1

    def pack_leaf(kind: int, first: int, count: int) -> int:
        row = np.zeros((_LANES,), np.float32)
        if kind == BLAS_TRI_MESH:
            for j in range(min(count, LEAF_WIDTH)):
                p = int(tri_prim[first + j])
                base = j * TRI_STRIDE
                row[base: base + 3] = tri_v0[p]
                row[base + 3: base + 6] = tri_e1[p]
                row[base + 6: base + 9] = tri_e2[p]
                row[base + 9] = np.float32(p)  # ids < 2^24: exact in f32
            tri_rows.append(row)
            return len(tri_rows) - 1
        for j in range(min(count, LEAF_WIDTH)):
            p = int(sph_prim[first + j])
            base = j * SPH_STRIDE
            row[base: base + 3] = sph_c[p]
            row[base + 3] = sph_r[p]
            row[base + 4] = np.float32(p)
        sph_rows.append(row)
        return len(sph_rows) - 1

    meta = []
    visited = np.zeros((nn,), bool)
    for inst_id, kind in sorted(inst_types.items()):
        root = int(roots[inst_id])
        stack = [root]
        while stack:
            cur = stack.pop()
            if cur < 0 or cur >= nn or visited[cur]:
                continue
            visited[cur] = True
            left, first, count, _skip = ifields[cur]
            if count > 0:
                if count > LEAF_WIDTH:
                    raise ValueError(
                        f"leaf count {count} > {LEAF_WIDTH}; build the scene "
                        f"with blas_leaf_size <= {LEAF_WIDTH} for the kernels"
                    )
                max_count = max(max_count, int(count))
                ifields[cur, 1] = pack_leaf(kind, int(first), int(count))
            else:
                stack.append(int(left))
                stack.append(cur + 1)  # right root
        w2o = tuple(w2o_all[inst_id].reshape(-1).tolist())
        wb = tuple(bmin_all[inst_id].tolist() + bmax_all[inst_id].tolist())
        meta.append((int(kind), root, w2o, wb, int(inst_id)))

    def rows_or_dummy(rows):
        return np.stack(rows) if rows else np.zeros((1, _LANES), np.float32)

    return PackedScene(
        nodes_rows=nodes_rows,
        node_ifields=ifields.astype(np.int32).reshape(-1),
        tri_rows=rows_or_dummy(tri_rows),
        sph_rows=rows_or_dummy(sph_rows),
        meta=tuple(meta),
        leaf_width=max_count,
        needs_bary=_scene_needs_bary(scene),
    )


def _stack_bound(wc_all: np.ndarray, roots, front: int = MAX_FRONT) -> int:
    """The TPU frontier walk's worst-case stack occupancy (all child tests
    hit, `front` pops per round), as wide_kernel._stack_bound computes it.
    Kept for table parity; it does not bound a per-thread DFS."""
    best = 1
    for root in roots:
        stack = [int(root)]
        max_sp = 1
        while stack:
            popped = [stack.pop() for _ in range(min(front, len(stack)))]
            for wid in reversed(popped):
                for c in wc_all[wid]:
                    if c >= 0:
                        stack.append(int(c))
            max_sp = max(max_sp, len(stack))
        best = max(best, max_sp)
    return best


def _wide_depth(wc_all: np.ndarray, roots) -> int:
    """Most inner wide nodes on any root-to-leaf chain under `roots`.
    Depths come from a post-order walk of each root, so nodes appended
    after their children (the treelet cut's wrapper nodes) count too."""
    depth = np.zeros((wc_all.shape[0],), np.int64)  # 0 = not yet known
    for root in roots:
        stack = [(int(root), False)]
        while stack:
            wid, done = stack.pop()
            kids = wc_all[wid][wc_all[wid] >= 0]
            if done:
                depth[wid] = 1 + (depth[kids].max() if kids.size else 0)
            elif not depth[wid]:
                stack.append((wid, True))
                stack.extend((int(c), False) for c in kids if not depth[c])
    return int(max(depth[list(roots)]))


def _leaf_enc(first: int, count: int) -> int:
    return -(first * 16 + count) - 2


def _octant_perms(wb: np.ndarray, wc: np.ndarray) -> np.ndarray:
    """Per-octant near-to-far child order for one wide node: (8,) int32,
    each packing 8 child slots, 4 bits per visit rank."""
    cent = (wb[:, 0:3] + wb[:, 3:6]) * 0.5
    perms = np.zeros((8,), np.int32)
    for o in range(8):
        sign = np.array(
            [1.0 if o & 4 else -1.0, 1.0 if o & 2 else -1.0, 1.0 if o & 1 else -1.0],
            np.float32,
        )
        key = np.where(wc == _EMPTY, np.inf, cent @ sign)  # empties last
        order = np.argsort(key, kind="stable")
        packed = 0
        for rank, child_slot in enumerate(order):
            packed |= int(child_slot) << (rank * 4)
        perms[o] = np.int32(np.uint32(packed).view(np.int32))
    return perms


@dataclasses.dataclass
class WideScene:
    """Device tables of the wide kernels plus the scene they came from."""

    wide_bounds: torch.Tensor  # (W*48,) f32
    wide_child: torch.Tensor  # (W*8,) i32
    wide_perm: torch.Tensor  # (W*8,) i32
    tri_rows: torch.Tensor  # (Lt,128) f32
    sph_rows: torch.Tensor  # (Ls,128) f32
    tri_v0e: torch.Tensor  # (T,9) f32 barycentric-epilogue rows
    inst_w2o: torch.Tensor  # (I,12) f32
    inst_i: torch.Tensor  # (n_inst,4) i32: kind, wide root, inst_id, identity
    inst_f: torch.Tensor  # (n_inst,18) f32: w2o 12, world bounds 6
    scene: SceneData  # the plain versions trace this, alpha off as in the kernels
    meta: tuple = ()
    stack_cap: int = 256  # TPU frontier bound (table parity with the JAX prep)
    wide_depth: int = 0  # most inner wide nodes on a root-to-leaf chain
    leaf_width: int = WIDTH
    needs_bary: bool = True
    # set by `with_mesh`: traces split their rays over `mesh`, block k
    # traced against `replicas.copies[k]`, these tables on mesh.devices[k]
    mesh: object = None
    replicas: object = None
    # (W, 64) i32 node records of K1, K2 and K7, derived from the wide tables
    nodes: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.nodes = pack_wide_nodes(self.wide_bounds, self.wide_child, self.wide_perm)

    @property
    def thread_stack(self) -> int:
        """The plain walk's per-lane DFS bound: a pop pushes at most 8
        children, so along the deepest root-to-leaf chain of `wide_depth`
        inner nodes the stack holds at most 7 pending siblings per level
        above plus 8: 7 * wide_depth + 1."""
        return 7 * self.wide_depth + 1


def pack_wide_nodes(wide_bounds, wide_child, wide_perm) -> torch.Tensor:
    """The node table of K1, K2 and K7 (csrc/wide_nodes.cuh): per wide node
    one 256-byte record of 64 int32 words, the 48 child-box floats (as
    float32 bits) slot-major by axis (xlo of slots 0..7, then ylo, zlo, xhi,
    yhi, zhi), the 8 child words and the 8 per-octant order words, on the
    tables' device."""
    w = wide_child.numel() // WIDTH
    boxes = wide_bounds.view(w, WIDTH, 6).transpose(1, 2).contiguous()
    return torch.cat([boxes.view(torch.int32).view(w, 48), wide_child.view(w, WIDTH),
                      wide_perm.view(w, WIDTH)], dim=1).contiguous()


def _is_identity(w2o) -> bool:
    """The world->object affine of a meta entry is the identity (within the
    JAX package's 1e-12)."""
    return all(abs(a - b) < 1e-12 for a, b in zip(w2o, _IDENTITY))


def _instance_tables(meta, device):
    inst_i = np.array(
        [
            [kind, root, inst_id, int(_is_identity(w2o))]
            for kind, root, w2o, _wb, inst_id in meta
        ],
        np.int32,
    ).reshape(-1, 4)
    inst_f = np.array(
        [list(w2o) + list(wb) for _k, _r, w2o, wb, _i in meta], np.float32
    ).reshape(-1, 18)
    return (torch.as_tensor(inst_i, device=device),
            torch.as_tensor(inst_f, device=device))


def _check_encodings(wc_all, tri_v0e_rows, sph_rows, max_inst):
    if int(-(wc_all.min())) - 2 >= (1 << _Q_MASK_SHIFT):
        raise ValueError("leaf row index overflows the 24-bit leaf encoding")
    max_prim = max(tri_v0e_rows - 1, int(sph_rows[:, [
        j * SPH_STRIDE + 4 for j in range(WIDTH)]].max()))
    if max_prim >= (1 << PP_PRIM_BITS):
        raise ValueError(
            f"prim id {max_prim} overflows the {PP_PRIM_BITS}-bit packed hit record"
        )
    if max_inst * 4 + 3 >= (1 << (31 - PP_PRIM_BITS)):
        raise ValueError("instance encoding overflows the packed hit record")


def prepare_wide(pscene: PackedScene, scene: SceneData) -> WideScene:
    """Collapse each instance's binary subtree to 8-wide nodes
    (wide_kernel.prepare_wide); tables land on `scene`'s device."""
    ifl = np.asarray(pscene.node_ifields).reshape(-1, 4)
    bounds = np.asarray(pscene.nodes_rows)[:, 0:6]
    wide_bounds: list[np.ndarray] = []
    wide_child: list[np.ndarray] = []

    def is_leaf(b: int) -> bool:
        return ifl[b, 2] > 0

    def collapse(b_root: int) -> int:
        # gather up to WIDTH binary descendants (leaves stay, inners expand)
        entries = [b_root]
        while len(entries) < WIDTH:
            idx = next((i for i, e in enumerate(entries) if not is_leaf(e)), None)
            if idx is None:
                break
            b = entries.pop(idx)
            entries.insert(idx, b + 1)  # right subtree emitted after the node
            entries.insert(idx, int(ifl[b, 0]))
        wid = len(wide_child)
        wb = np.zeros((WIDTH, 6), np.float32)
        wc = np.full((WIDTH,), _EMPTY, np.int32)
        wide_bounds.append(wb)
        wide_child.append(wc)
        for c, b in enumerate(entries):
            wb[c] = bounds[b]
            if is_leaf(b):
                wc[c] = _leaf_enc(int(ifl[b, 1]), int(ifl[b, 2]))
            else:
                wc[c] = collapse(b)
        return wid

    meta = []
    for kind, root, w2o, wbounds, inst_id in pscene.meta:
        if is_leaf(root):
            # single-leaf instance -> wide node with one child
            wid = len(wide_child)
            wb = np.zeros((WIDTH, 6), np.float32)
            wc = np.full((WIDTH,), _EMPTY, np.int32)
            wb[0] = bounds[root]
            wc[0] = _leaf_enc(int(ifl[root, 1]), int(ifl[root, 2]))
            wide_bounds.append(wb)
            wide_child.append(wc)
        else:
            wid = collapse(root)
        meta.append((kind, wid, w2o, wbounds, inst_id))

    wb_all = np.stack(wide_bounds)
    wc_all = np.stack(wide_child)
    perms = np.stack([_octant_perms(wb_all[i], wc_all[i]) for i in range(len(wc_all))])
    cap = _stack_bound(wc_all, [m[1] for m in meta]) + WIDTH
    if cap > 16384:
        raise ValueError(
            f"wide BVH needs a {cap}-entry traversal stack (pathologically "
            f"deep/unbalanced tree); rebuild with a different BVH method"
        )

    # per-prim (v0, e1, e2) rows for the barycentric epilogue, rebuilt from
    # the packed leaf rows (empty slots are all-zero and excluded)
    tri_rows_np = np.asarray(pscene.tri_rows)
    slot_base = np.arange(WIDTH) * TRI_STRIDE
    ids = tri_rows_np[:, slot_base + 9].astype(np.int64)
    vals = tri_rows_np[:, slot_base[:, None] + np.arange(9)[None, :]]
    real = (ids != 0) | (np.abs(vals).sum(axis=-1) > 0.0)
    n_tbl = int(ids[real].max()) + 1 if real.any() else 1
    tri_v0e = np.zeros((n_tbl, 9), np.float32)
    tri_v0e[ids[real]] = vals[real]

    max_inst = max((m[4] for m in meta), default=0)
    inst_w2o = np.tile(np.array(_IDENTITY, np.float32), (max_inst + 1, 1))
    for _kind, _wid, w2o, _wb, inst_id in meta:
        inst_w2o[inst_id] = np.asarray(w2o, np.float32)
    _check_encodings(wc_all, n_tbl, np.asarray(pscene.sph_rows), max_inst)

    return wide_from_numpy(
        dict(
            wide_bounds=wb_all.reshape(-1),
            wide_child=wc_all.reshape(-1),
            wide_perm=perms.reshape(-1).astype(np.int32),
            tri_rows=pscene.tri_rows,
            sph_rows=pscene.sph_rows,
            tri_v0e=tri_v0e,
            inst_w2o=inst_w2o,
            meta=tuple(meta),
            stack_cap=max(int(cap), 64),
            leaf_width=pscene.leaf_width,
            needs_bary=pscene.needs_bary,
        ),
        scene,
    )


def wide_from_numpy(tables: dict, scene: SceneData) -> WideScene:
    """WideScene from the tables of a wide prep (this module's or the JAX
    package's `prepare_wide`, read out as numpy), on `scene`'s device."""
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

    return WideScene(
        wide_bounds=t("wide_bounds", torch.float32),
        wide_child=t("wide_child", torch.int32),
        wide_perm=t("wide_perm", torch.int32),
        tri_rows=t("tri_rows", torch.float32),
        sph_rows=t("sph_rows", torch.float32),
        tri_v0e=t("tri_v0e", torch.float32),
        inst_w2o=t("inst_w2o", torch.float32),
        inst_i=inst_i,
        inst_f=inst_f,
        scene=dataclasses.replace(scene, has_alpha=False),
        meta=meta,
        stack_cap=int(tables["stack_cap"]),
        wide_depth=_wide_depth(wc_all, [m[1] for m in meta]),
        leaf_width=int(tables["leaf_width"]),
        needs_bary=bool(tables["needs_bary"]),
    )


# ---------------------------------------------------------------- kernels

_state: dict[str, object] = {}


def library():
    """(CDLL, build seconds) of csrc/wide_trace.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("wide_trace")
        common = [cu.VP, cu.VP, cu.VP, cu.CI] + [cu.VP] * 5 + [cu.CI] * 3
        lib.wide_trace_closest.restype = cu.CI
        lib.wide_trace_closest.argtypes = common + [cu.VP] * 4
        lib.wide_trace_shadow.restype = cu.CI
        lib.wide_trace_shadow.argtypes = common + [cu.VP] * 3
        lib.wide_max_depth.restype = cu.CI
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def _check_rays(device, o, d, t_max, label: str = "wide trace"):
    """Rays must be contiguous float32 (N,3)/(N,3)/(N,) on the scene's
    device (`device`), which is the CPU or a CUDA card."""
    n = o.shape[0]
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("t_max", t_max, (n,))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{label}: {name} must be contiguous float32 {shape}, got "
                f"{x.dtype} {tuple(x.shape)}"
            )
        if x.device != device:
            raise ValueError(f"{label}: {name} on {x.device}, scene on {device}")
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{label}: unsupported device {o.device}")


def launch_walk(lib, prefix: str, tables: list, stack_bound: int, o, d, t_max,
                any_hit: bool, work=None):
    """Launch `<prefix>_trace_closest` or `<prefix>_trace_shadow` of a trace
    library (csrc/trace_common.cuh) on the rays; `tables` are the scene
    arguments between the rays and the stack bound the host proved. With
    `work` (2 zeroed int64 on the rays' device) the counting variant runs and
    adds the boxes and primitives it tested there. Raises on a launch error;
    a walk past the stack bound fails a device-side assert, which the next
    synchronizing call raises, so nothing is read back here. Returns (t, pp)
    or (occ,)."""
    n = o.shape[0]
    dev = o.device
    args = [o.data_ptr(), d.data_ptr(), t_max.data_ptr(), n, *tables, stack_bound]
    tail = [None if work is None else work.data_ptr(), cu.stream_ptr(o)]
    if any_hit:
        occ = torch.empty((n,), dtype=torch.bool, device=dev)
        err = getattr(lib, prefix + "_trace_shadow")(*args, occ.data_ptr(), *tail)
        out = (occ,)
    else:
        t = torch.empty((n,), dtype=torch.float32, device=dev)
        pp = torch.empty((n,), dtype=torch.int32, device=dev)
        err = getattr(lib, prefix + "_trace_closest")(
            *args, t.data_ptr(), pp.data_ptr(), *tail)
        out = (t, pp)
    cu.check(lib, prefix, err)
    return out


def check_walk_tables(ks, nodes: torch.Tensor, max_depth: int, label: str) -> None:
    """Refuse, before any launch, tables a node-group walk cannot take: a
    wide depth (`ks.wide_depth`) above the `max_depth` entries its stack
    holds, node ids that overflow the 23 bits of a stack entry, node
    records or leaf rows (`ks.tri_rows`, `ks.sph_rows`) not 16-byte
    aligned."""
    if ks.wide_depth > max_depth:
        raise ValueError(
            f"{label}: wide BVH of depth {ks.wide_depth}; the node-group stack "
            f"holds {max_depth} levels")
    if nodes.shape[0] >= 1 << 23:
        raise ValueError(
            f"{label}: {nodes.shape[0]} wide nodes overflow the 23-bit stack entry")
    if nodes.data_ptr() % 16 or ks.tri_rows.data_ptr() % 16 or ks.sph_rows.data_ptr() % 16:
        raise ValueError(f"{label}: node records and leaf rows must be 16-byte aligned")


def _launch(ws: WideScene, o, d, t_max, any_hit: bool, work=None):
    lib, _ = library()
    check_walk_tables(ws, ws.nodes, lib.wide_max_depth(), "wide trace")
    tables = [
        ws.nodes.data_ptr(), ws.tri_rows.data_ptr(), ws.sph_rows.data_ptr(),
        ws.inst_i.data_ptr(), ws.inst_f.data_ptr(), ws.inst_i.shape[0],
        ws.leaf_width,
    ]
    if work is None:
        LAUNCHES["wide_shadow" if any_hit else "wide_closest"] += 1
    return launch_walk(lib, "wide", tables, ws.wide_depth, o, d, t_max,
                       any_hit, work)


def count_work(ws: WideScene, o, d, t_max, any_hit: bool) -> tuple[int, int]:
    """(boxes, primitives) that K1 (K2 with `any_hit`) tests on these CUDA
    rays, from the kernel's counting variant; not a launch of the frame."""
    work = torch.zeros((2,), dtype=torch.int64, device=o.device)
    _launch(ws, o, d, t_max, any_hit, work)
    return int(work[0]), int(work[1])


def plain_closest_packed(scene: SceneData, o, d, t_max, prim_bits: int):
    """The skip-index walk of ops/traverse.py on `scene`, packed as the
    kernels pack it: pp = prim | (inst*4+kind) << prim_bits, miss = -1. A hit
    at or beyond t_max is a miss (the closest hit overall lies below t_max
    exactly when some hit does)."""
    hit = traverse.trace_closest(scene, o, d, active=t_max > 0.0)
    ok = (hit.prim >= 0) & (hit.t < t_max)
    pp = (hit.prim | ((hit.inst * 4 + hit.kind) << prim_bits)).to(torch.int32)
    t = torch.where(ok, hit.t, torch.clamp(t_max, max=T_INF))
    return t, torch.where(ok, pp, torch.full_like(pp, -1))


def trace_closest_plain(ws: WideScene, o, d, t_max):
    """Plain K1: the skip-index walk on ws.scene, 20-bit prim record."""
    return plain_closest_packed(ws.scene, o, d, t_max, PP_PRIM_BITS)


def shadow_plain(ws: WideScene, o, d, t_max):
    """Plain K2: any-hit walk of ops/traverse.py on ws.scene."""
    return traverse.shadow_occlusion(ws.scene, o, d, t_max, active=t_max > 0.0)


def _lane_t_max(o, t_max, active):
    n = o.shape[0]
    if t_max is None:
        t_max = torch.full((n,), T_INF, device=o.device)
    else:
        t_max = torch.broadcast_to(
            torch.as_tensor(t_max, dtype=torch.float32, device=o.device), (n,)
        ).contiguous()
    if active is not None:
        t_max = torch.where(active, t_max, torch.zeros_like(t_max))
    return t_max


def with_mesh(ks, mesh):
    """Attach a device mesh to a WideScene (or StreamScene): its traces
    split their rays over mesh axis "px", block k traced on
    `mesh.devices[k]` against a replica of the tables there (one copy on
    each distinct device). The mesh's devices must be of the tables' type:
    no block moves between the card and the CPU."""
    kinds = {d.type for d in mesh.devices}
    if kinds != {ks.wide_child.device.type}:
        raise ValueError(f"with_mesh: a mesh of {sorted(kinds)} devices for tables "
                         f"on {ks.wide_child.device}")
    plain = copy.copy(ks)
    plain.mesh = plain.replicas = None
    out = copy.copy(plain)
    out.mesh, out.replicas = mesh, shrd.replicate(mesh, plain)
    return out


def _shard_ray_op(ks, run, o, d, t_max):
    """`run(replica, o, d, t_max)` on each block of the rays: the rays
    padded to a multiple of the mesh size (t_max 0 on pad lanes, which
    makes them inactive), block k moved to `mesh.devices[k]` and traced
    against that device's replica by the same kernel (its plain version on
    CPU tensors), the outputs moved back to the rays' device, concatenated
    and cut to n. Every block's launch is issued before the first copy
    back, so distinct devices overlap. A block whose kernel fails raises."""
    mesh = ks.mesh
    n = o.shape[0]
    pad = -(-n // mesh.size) * mesh.size - n
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_zeros((pad, 3))])
        t_max = torch.cat([t_max, t_max.new_zeros((pad,))])
    outs = []
    for rows, dev, rep in zip(shrd.block_slices(n + pad, mesh), mesh.devices,
                              ks.replicas.copies):
        with shrd.device_scope(dev):
            outs.append(run(rep, o[rows].to(dev), d[rows].to(dev), t_max[rows].to(dev)))
    if isinstance(outs[0], torch.Tensor):
        return torch.cat([x.to(o.device) for x in outs])[:n]
    return tuple(torch.cat([x[i].to(o.device) for x in outs])[:n]
                 for i in range(len(outs[0])))


def trace_closest_wide_packed(ws: WideScene, o, d, active=None, t_max=None):
    """K1: closest hit as the packed record (t, pp), pp = prim |
    (inst*4+kind) << 20, miss = -1; t_max 0 marks an inactive lane."""
    t_max = _lane_t_max(o, t_max, active)
    _check_rays(ws.wide_child.device, o, d, t_max)
    if ws.mesh is not None:
        return _shard_ray_op(ws, lambda rep, oo, dd, tm: trace_closest_wide_packed(
            rep, oo, dd, t_max=tm), o, d, t_max)
    if o.device.type == "cpu":
        return trace_closest_plain(ws, o, d, t_max)
    return _launch(ws, o, d, t_max, any_hit=False)


def shadow_occlusion_wide(ws: WideScene, o, d, t_max_world, active=None):
    """K2: any-hit occlusion within (T_EPS, t_max_world); bool (N,)."""
    t_max = _lane_t_max(o, t_max_world, active)
    _check_rays(ws.wide_child.device, o, d, t_max)
    if ws.mesh is not None:
        return _shard_ray_op(ws, shadow_occlusion_wide, o, d, t_max)
    if o.device.type == "cpu":
        return shadow_plain(ws, o, d, t_max)
    return _launch(ws, o, d, t_max, any_hit=True)[0]


def _decode_pp(tri_v0e, inst_w2o, o, d, t, pp, need_bary: bool = True,
               prim_bits: int = PP_PRIM_BITS):
    """Packed record -> (t, prim, inst_enc, bu, bv); barycentrics recomputed
    against the winning triangle in object space (zeros when the scene has
    no consumer for them)."""
    miss = pp < 0
    prim = torch.where(miss, -1, pp & ((1 << prim_bits) - 1)).to(torch.int32)
    inst = torch.where(miss, -1, pp >> prim_bits).to(torch.int32)
    if not need_bary:
        zero = torch.zeros_like(t)
        return t, prim, inst, zero, zero
    tri_hit = (~miss) & ((inst & 3) == KIND_TRI)
    rows9 = tri_v0e[torch.where(tri_hit, prim, 0).long()]
    m = inst_w2o[torch.where(tri_hit, inst >> 2, 0).long()].reshape(-1, 3, 4)
    o_obj = vec.transform_point(m, o)
    d_obj = vec.transform_vector(m, d)
    _ok, _t2, bu, bv = intersect_triangle(
        o_obj, d_obj, rows9[:, 0:3], rows9[:, 3:6], rows9[:, 6:9]
    )
    zero = torch.zeros_like(bu)
    return t, prim, inst, torch.where(tri_hit, bu, zero), torch.where(tri_hit, bv, zero)


def _pp_to_record(t, prim, inst, bu, bv) -> HitRecord:
    miss = prim < 0
    return HitRecord(
        t=torch.where(miss, torch.full_like(t, T_INF), t),
        kind=torch.where(miss, 0, inst & 3).to(torch.int32),
        prim=prim,
        inst=torch.where(miss, -1, inst >> 2).to(torch.int32),
        bu=bu,
        bv=bv,
    )


def decode_wide_hits(ws: WideScene, o, d, t, pp) -> HitRecord:
    """Epilogue of K1: packed record -> HitRecord, in whatever lane order
    (o, d, t, pp) share."""
    return _pp_to_record(
        *_decode_pp(ws.tri_v0e, ws.inst_w2o, o, d, t, pp, ws.needs_bary)
    )


def trace_closest_wide(ws: WideScene, o, d, active=None, t_max=None) -> HitRecord:
    t, pp = trace_closest_wide_packed(ws, o, d, active=active, t_max=t_max)
    return decode_wide_hits(ws, o, d, t, pp)


def prepare_scene(scene: SceneData) -> WideScene:
    """prepare + prepare_wide in one call (the Renderer's entry)."""
    return prepare_wide(prepare(scene), scene)
