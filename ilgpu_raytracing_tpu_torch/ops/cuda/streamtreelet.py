"""Treelet cut of the streaming tables and the treelet-round kernel K8
(csrc/streamtreelet_trace.cu), the port of the JAX package's
`ops/pallas/streamtreelet_kernel.py`.

Host side (numpy, tables identical to the JAX package's):
`prepare_treelets_stream` cuts a `StreamScene`'s 8-wide tree with the shared
cut (`treelet._cut_wide_tree`, rows counted as packed leaf rows) over the
child boxes exactly as the kernels dequantize them (`_dequantize_children`),
and u8-quantizes only the appended wrapper nodes with
`stream._quantize_bounds`, so the original rows keep their tables and every
box stays outward-conservative. As in the JAX package, only identity
instance transforms are taken. `stream_treelet_from_numpy` loads the JAX
`StreamTreeletScene`'s arrays.

Device side: `run_treelet_stream_trace` is one visit round over the
streaming tables (K8 on CUDA tensors; on CPU tensors the plain per-lane loop
over the mask's treelets around `treelet.plain_walk` with the stream box and
leaf readers).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.models.scene import BLAS_TRI_MESH
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops.cuda import treelet, wide
from ilgpu_raytracing_tpu_torch.ops.cuda.stream import (
    _ENC_BASE,
    SPP_PRIM_BITS,
    StreamScene,
    _quantize_bounds,
)
from ilgpu_raytracing_tpu_torch.ops.cuda.wide import (
    _EMPTY,
    LEAF_WIDTH,
    WIDTH,
    _is_identity,
    _stack_bound,
    _wide_depth,
    check_walk_tables,
)
from ilgpu_raytracing_tpu_torch.utils import telemetry

TILE_ROWS = 16  # packet = TILE_ROWS * 128 sorted lanes (the JAX default)

LAUNCHES = telemetry.counter("launches.streamtreelet", streamtreelet=0)


@dataclasses.dataclass
class StreamTreeletScene:
    """StreamScene with extended node tables + its treelet cut."""

    sscene: StreamScene
    t_root: torch.Tensor  # (T+1,) i32 wide node id; [T] = -1
    t_inst: torch.Tensor  # (T+1,) i32 inst_id * 4 + kind
    t_bounds: torch.Tensor  # (T, 6) f32 world-space treelet boxes
    inst_spans: tuple = ()
    n_treelets: int = 0
    any_spheres: bool = False


def _dequantize_children(sscene: StreamScene) -> np.ndarray:
    """(n, 8, 6) f32 child boxes exactly as the kernels dequantize them
    (lo + f32(q) * scale); empty children keep zero boxes."""
    wf = sscene.wide_frame.cpu().numpy().reshape(-1, 6)
    wq = sscene.wide_qbounds.cpu().numpy().reshape(-1, 16).view(np.uint32)
    wc = sscene.wide_child.cpu().numpy().reshape(-1, WIDTH)
    wb = np.zeros((wf.shape[0], WIDTH, 6), np.float32)
    w0, w1 = wq[:, 0::2], wq[:, 1::2]
    q = np.stack([w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255, (w0 >> 24) & 255,
                  w1 & 255, (w1 >> 8) & 255], axis=2).astype(np.float32)
    lo = wf[:, None, 0:3]
    fs = wf[:, None, 3:6]
    wb[:, :, 0:3] = lo + q[:, :, 0:3] * fs
    wb[:, :, 3:6] = lo + q[:, :, 3:6] * fs
    wb[wc == _EMPTY] = 0.0
    return wb


def prepare_treelets_stream(sscene: StreamScene,
                            n_target: int = 32) -> StreamTreeletScene:
    """Cut the stream scene into <= n_target treelets
    (`streamtreelet_kernel.prepare_treelets_stream`); tables land on the
    scene's device."""
    if not 1 <= n_target <= treelet.MAX_TREELETS:
        raise ValueError(f"n_target {n_target} outside [1, {treelet.MAX_TREELETS}]")
    for _kind, _wid, w2o, _wb, _inst in sscene.meta:
        if not _is_identity(w2o):
            raise ValueError(
                "stream treelet rounds take identity instance transforms only; "
                "use the flat stream kernel")
    wc_all = sscene.wide_child.cpu().numpy().reshape(-1, WIDTH).copy()
    n_orig = wc_all.shape[0]
    frontier, wc_all, wb_all, wp_all = treelet._cut_wide_tree(
        wc_all, _dequantize_children(sscene),
        sscene.wide_perm.cpu().numpy().reshape(-1, WIDTH).copy(),
        sscene.meta, n_target, lambda c: max(1, (-c - 2) % _ENC_BASE),
    )
    n_t = len(frontier)
    # quantize only the appended wrapper nodes; the original rows keep
    # their tables bit for bit
    wf_all = sscene.wide_frame.cpu().numpy().reshape(-1, 6)
    wq_all = sscene.wide_qbounds.cpu().numpy().reshape(-1, 16)
    if wc_all.shape[0] > n_orig:
        wf_x, wq_x = _quantize_bounds(wb_all[n_orig:], wc_all[n_orig:])
        wf_all = np.concatenate([wf_all, wf_x], axis=0)
        wq_all = np.concatenate([wq_all, wq_x], axis=0)
    t_root = np.full((n_t + 1,), -1, np.int32)
    t_inst = np.zeros((n_t + 1,), np.int32)
    t_bounds = np.zeros((n_t, 6), np.float32)
    for k, e in enumerate(frontier):
        t_root[k] = e["root"]
        t_inst[k] = treelet._inst_enc(sscene.meta[e["mi"]])
        t_bounds[k] = e["bounds"]
    cap = _stack_bound(wc_all, [e["root"] for e in frontier]) + WIDTH
    return stream_treelet_from_numpy(dict(
        wide_frame=wf_all.reshape(-1), wide_qbounds=wq_all.reshape(-1),
        wide_child=wc_all.reshape(-1), wide_perm=wp_all.reshape(-1).astype(np.int32),
        stack_cap=max(sscene.stack_cap, int(cap), 64),
        t_root=t_root, t_inst=t_inst, t_bounds=t_bounds,
        inst_spans=treelet._spans(frontier), n_treelets=n_t,
        any_spheres=any(sscene.meta[e["mi"]][0] != BLAS_TRI_MESH for e in frontier),
    ), sscene)


def stream_treelet_from_numpy(tables: dict, sscene: StreamScene) -> StreamTreeletScene:
    """StreamTreeletScene from the tables of a stream treelet prep (this
    module's or the JAX `prepare_treelets_stream`, read out as numpy: the
    extended wide_frame / wide_qbounds / wide_child / wide_perm and
    stack_cap, t_root, t_inst, t_bounds, inst_spans, n_treelets,
    any_spheres) over the StreamScene they extend, on its device."""
    dev = sscene.wide_child.device

    def t(name, dtype):
        return torch.as_tensor(np.array(tables[name]), dtype=dtype, device=dev).contiguous()

    wc_all = np.asarray(tables["wide_child"], np.int32).reshape(-1, WIDTH)
    n_t = int(tables["n_treelets"])
    roots = np.asarray(tables["t_root"])[:n_t].tolist()
    ss = dataclasses.replace(
        sscene,
        wide_frame=t("wide_frame", torch.float32),
        wide_qbounds=t("wide_qbounds", torch.int32),
        wide_child=t("wide_child", torch.int32),
        wide_perm=t("wide_perm", torch.int32),
        stack_cap=int(tables["stack_cap"]),
        wide_depth=_wide_depth(wc_all, [m[1] for m in sscene.meta] + roots),
    )
    return StreamTreeletScene(
        sscene=ss,
        t_root=t("t_root", torch.int32),
        t_inst=t("t_inst", torch.int32),
        t_bounds=t("t_bounds", torch.float32),
        inst_spans=tuple(tuple(int(v) for v in s) for s in tables["inst_spans"]),
        n_treelets=n_t,
        any_spheres=bool(tables["any_spheres"]),
    )


def treelet_stream_arrays(sts: StreamTreeletScene) -> tuple:
    """The device tables one K8 round reads."""
    s = sts.sscene
    return (sts.t_root, sts.t_inst, s.anyhit_nodes, s.wide_perm, s.tri_rows,
            s.sph_rows)


# ------------------------------------------------------------- plain walk


def stream_boxes(wide_frame, wide_qbounds):
    """Child-box reader of the streaming tables: (wid, c8) -> (L, 6),
    dequantized as lo + float(q) * scale, unfused, as the kernels do."""
    wf = wide_frame.reshape(-1, 6)
    wq = wide_qbounds.reshape(-1, WIDTH, 2).long() & 0xFFFFFFFF

    def boxes(wid, c8):
        w0, w1 = wq[wid, c8, 0], wq[wid, c8, 1]
        q = torch.stack([w0 & 255, (w0 >> 8) & 255, (w0 >> 16) & 255,
                         (w0 >> 24) & 255, w1 & 255, (w1 >> 8) & 255], dim=1)
        f = wf[wid]
        lo = torch.cat([f[:, 0:3], f[:, 0:3]], dim=1)
        scale = torch.cat([f[:, 3:6], f[:, 3:6]], dim=1)
        return lo + q.to(torch.float32) * scale
    return boxes


def stream_leaf(enc):
    """Leaf decoder of the streaming tables: enc -> (first row, rows, 8)."""
    return enc // _ENC_BASE, enc % _ENC_BASE, torch.full_like(enc, LEAF_WIDTH)


def round_plain(sts: StreamTreeletScene, mask, o, d, t_max, tile_rows: int = TILE_ROWS):
    """Plain K8: one treelet round over the streaming tables."""
    s = sts.sscene
    boxes = stream_boxes(s.wide_frame, s.wide_qbounds)

    def walk_one(root, is_tri, ro, rd, inst_bits, tb, pb):
        treelet.plain_walk(s.wide_child, s.wide_perm, boxes, stream_leaf,
                           s.tri_rows if is_tri else s.sph_rows, is_tri, root, ro,
                           rd, inst_bits, tb, pb, s.thread_stack)

    return treelet.treelet_round_plain(sts.n_treelets, sts.t_root, sts.t_inst, None,
                                       True, walk_one, mask, o, d, t_max, tile_rows,
                                       SPP_PRIM_BITS)


# ---------------------------------------------------------------- kernel

_state: dict[str, object] = {}


def library():
    """(CDLL, build seconds) of csrc/streamtreelet_trace.cu, built at first
    use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("streamtreelet_trace")
        lib.streamtreelet_trace.restype = cu.CI
        lib.streamtreelet_trace.argtypes = (
            [cu.VP, cu.VP, cu.VP, cu.CI, cu.VP, cu.VP, cu.VP, cu.VP, cu.CI, cu.VP,
             cu.CI, cu.VP, cu.VP, cu.CI] + [cu.VP] * 4)
        lib.streamtreelet_max_depth.restype = cu.CI
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def _launch(sts: StreamTreeletScene, mask, o, d, t_max, tile_rows, work=None):
    lib, _ = library()
    s = sts.sscene
    check_walk_tables(s, s.anyhit_nodes, lib.streamtreelet_max_depth(),
                      "stream treelet round")
    tables = [s.anyhit_nodes.data_ptr(), s.wide_perm.data_ptr(), s.tri_rows.data_ptr(),
              s.sph_rows.data_ptr(), s.wide_depth]
    if work is None:
        LAUNCHES["streamtreelet"] += 1
    return treelet.launch_round(lib, "streamtreelet", tables, o, d, t_max, mask,
                                tile_rows, [sts.t_root.data_ptr(),
                                            sts.t_inst.data_ptr(), sts.n_treelets],
                                work)


def count_work(sts: StreamTreeletScene, mask, o, d, t_max, tile_rows: int = TILE_ROWS):
    """(boxes, primitives) that one K8 round tests on these CUDA rays, from
    the kernel's counting variant; not a launch of a round."""
    work = torch.zeros((2,), dtype=torch.int64, device=o.device)
    _launch(sts, mask, o, d, t_max, tile_rows, work)
    return int(work[0]), int(work[1])


def run_treelet_stream_trace(sts: StreamTreeletScene, mask, o, d, t_max,
                             tile_rows: int = TILE_ROWS):
    """K8, one treelet round over the streaming tables
    (`streamtreelet_kernel.run_treelet_stream_trace`). Returns (t, pp); pp =
    -1 where this round found no hit below t_max."""
    wide._check_rays(sts.t_root.device, o, d, t_max, "stream treelet round")
    treelet._check_round(mask, o.shape[0], tile_rows, o.device)
    with telemetry.kernel("streamtreelet", o.shape[0]):
        if o.device.type == "cpu":
            return round_plain(sts, mask, o, d, t_max, tile_rows)
        return _launch(sts, mask, o, d, t_max, tile_rows)
