"""The CUDA trace kernels' own source, run on the CPU.

ops/cuda/host_check.py compiles csrc/wide_trace.cu, stream_trace.cu,
binary_trace.cu, treelet_trace.cu and streamtreelet_trace.cu (with the
csrc/*.cuh headers) for the host with g++; here they are bound in place of
the nvcc builds and run through the wrappers' launch path (ctypes argument
order, the counting variant) on CPU tensors. K1/K2 and
K4/K5 are held to the plain walks on primary and bounce rays: hit masks and
occlusion equal, |dt| <= 1e-3, prim agreement > 99.5% (the bar chip_smoke.py
holds them to on the card). K5, with a tenth of the lanes inactive, also
equals the plain walk and K4's hit mask at t_max 5 and 1e29 on the small
terrain and the leaf-64 Cornell box. K6, K7 and K8 are held to their own plain
versions bit for bit: every output of K6, and t / pp of one treelet round on
random want masks. K4 and K1 also equal, bit for bit in t and pp, the plain
walk in its own test order (`treelet.plain_walk` from each instance's
root): the order on which K8 = K4 and K7 = K1 on the card depend. The
wrappers of K1, K2, K4, K5, K7 and K8 refuse, before any launch, tables
deeper than the node-group stacks hold, and a K4 or K1 walk past its stack
bound fails the kernel's assert (in a child process). K1's packed node
record equals the flat wide tables field by field. K6's child-pair records
equal the flat binary tables; K6 equals its plain version bit for bit on
rays that tie between triangles (over the SAH build and over trees of
random shape), which pins its preorder, and its counting variant counts
the skip walk's boxes and primitives; its wrapper refuses tables deeper
than its stack, and a walk past the bound fails its assert (in a child
process). This checks the kernels' logic; what nvcc accepts, and speed,
show only on the card."""

import copy
import os
import resource
import subprocess
import sys

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.models import cornell, terrain
from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.models.scene import BLAS_TRI_MESH, build_default_scene
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops.cuda import (
    binary,
    host_check,
    stream,
    streamtreelet,
    treelet,
    wide,
)
from ilgpu_raytracing_tpu_torch.ops.intersect import T_INF
from ilgpu_raytracing_tpu_torch.utils.build import BUILD_DIR

KERNEL_MODULES = (wide, stream, binary, treelet, streamtreelet)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host():
    """The host builds bound as the kernel libraries for this module only;
    the wrappers' library caches and launch counts are restored after."""
    if not tnative.available():
        pytest.skip("no C++ compiler")
    libs = host_check.host_libraries()
    saved = (cu.load_kernel_library, cu.stream_ptr,
             [dict(m.LAUNCHES) for m in KERNEL_MODULES])
    for m in KERNEL_MODULES:
        m._state.clear()
    cu.load_kernel_library = lambda name: (libs[name], 0.0)
    cu.stream_ptr = lambda t: None
    try:
        yield host_check
    finally:
        cu.load_kernel_library, cu.stream_ptr = saved[0], saved[1]
        for m, counts in zip(KERNEL_MODULES, saved[2]):
            m._state.clear()
            m.LAUNCHES.update(counts)


CASES = {
    "terrain_stream": (
        stream, lambda: terrain.build_terrain_scene(grid_x=64, grid_z=32, device="cpu")[1],
        terrain.terrain_camera),
    "cornell_wide": (
        wide, lambda: cornell.build_cornell_scene(tess=4, sphere_tess=(8, 12),
                                                  blas_leaf_size=8, bvh_method="sah",
                                                  device="cpu")[1],
        cornell.cornell_camera),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_built_kernels_meet_the_plain_walk(host, case):
    mod, build, camera = CASES[case]
    scene = build()
    ks = stream.prepare_stream(scene) if mod is stream else wide.prepare_scene(scene)
    o, d = host.jittered_rays(camera(48, 32), 48, 32, 1)
    assert host.check_walks(f"{case} primary", mod, ks, o, d)
    bo, bd = host.bounce_rays(scene, host.primary_hits(mod, ks, o, d), o, d, 2)
    assert bo.shape[0] > 100
    assert host.check_walks(f"{case} bounce", mod, ks, bo, bd)
    # the kernel launches counted (3 per check_walks) and the counting
    # variant did not count
    assert sum(mod.LAUNCHES.values()) >= 6
    work = torch.zeros((2,), dtype=torch.int64)
    mod._launch(ks, bo, bd, torch.full((bo.shape[0],), 1e30), any_hit=True, work=work)
    assert int(work[0]) > 0 and int(work[1]) > 0


ROUND_CASES = {
    "cornell_binary_treelet": (
        wide, CASES["cornell_wide"][1], cornell.cornell_camera),
    "default_binary_treelet": (
        wide, lambda: build_default_scene(single_instance=False, device="cpu")[1],
        Camera.create),
    "terrain_streamtreelet": (stream, CASES["terrain_stream"][1], terrain.terrain_camera),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_host_built_k6_k7_k8_equal_their_plain_versions(host, case):
    """K6 on primary and bounce rays (wide-table scenes) and one K7 / K8
    round on bounce rays with random and full want masks, each equal to
    its plain version in every output."""
    mod, build, camera = ROUND_CASES[case]
    scene = build()
    ks = stream.prepare_stream(scene) if mod is stream else wide.prepare_scene(scene)
    o, d = host.jittered_rays(camera(48, 32), 48, 32, 1)
    bo, bd = host.bounce_rays(scene, host.primary_hits(mod, ks, o, d), o, d, 2)
    if mod is wide:
        bs = binary.prepare_binary(scene)
        assert host.check_binary(f"{case} primary", bs, o, d)
        assert host.check_binary(f"{case} bounce", bs, bo, bd)
        ts = treelet.prepare_treelets(ks, 8)
        assert host.check_round(f"{case} K7", treelet, ts, bo, bd, 1, 3)
        assert binary.LAUNCHES["binary_closest"] >= 2 and treelet.LAUNCHES["treelet"] >= 2
    else:
        sts = streamtreelet.prepare_treelets_stream(ks, 8)
        assert host.check_round(f"{case} K8", streamtreelet, sts, bo, bd, 1, 3)
        assert streamtreelet.LAUNCHES["streamtreelet"] >= 2


ANYHIT_CASES = {
    "terrain": (CASES["terrain_stream"][1], terrain.terrain_camera),
    "cornell_leaf64": (
        lambda: cornell.build_cornell_scene(tess=6, sphere_tess=(10, 14), blas_leaf_size=64,
                                            bvh_method="sah", device="cpu")[1],
        cornell.cornell_camera),
}


@pytest.mark.parametrize("case", list(ANYHIT_CASES))
def test_host_built_k5_equals_the_plain_walk_and_k4(host, case):
    """K5's own walk (csrc/stream_anyhit.cuh) with inactive lanes: occlusion
    equal to the plain walk and to K4's hit mask at t_max 5 and 1e29, on
    primary and bounce rays."""
    build, camera = ANYHIT_CASES[case]
    scene = build()
    ss = stream.prepare_stream(scene)
    o, d = host.jittered_rays(camera(48, 32), 48, 32, 1)
    launches = stream.LAUNCHES["stream_shadow"]
    assert host.check_anyhit(f"{case} primary", ss, o, d, 4)
    bo, bd = host.bounce_rays(scene, host.primary_hits(stream, ss, o, d), o, d, 2)
    assert bo.shape[0] > 100
    assert host.check_anyhit(f"{case} bounce", ss, bo, bd, 5)
    # the host build ran, not the plain walk: 2 K5 launches per check
    assert stream.LAUNCHES["stream_shadow"] - launches == 4


def _plain_order_walk(ks, o, d):
    """K4's (StreamScene) or K1's (WideScene) result in the plain walk's own
    test order: `treelet.plain_walk` from each instance's root, in instance
    order, carrying t_best and pp."""
    n = o.shape[0]
    t_best = torch.full((n,), T_INF)
    pp = torch.full((n,), -1, dtype=torch.int32)
    if isinstance(ks, stream.StreamScene):
        boxes = streamtreelet.stream_boxes(ks.wide_frame, ks.wide_qbounds)
        leaf, prim_bits = streamtreelet.stream_leaf, stream.SPP_PRIM_BITS
    else:
        boxes = treelet.wide_boxes(ks.wide_bounds)
        leaf, prim_bits = treelet.wide_leaf(ks.leaf_width), wide.PP_PRIM_BITS
    for entry in ks.meta:
        kind, root, w2o = entry[0], entry[1], entry[2]
        is_tri = kind == BLAS_TRI_MESH
        ro, rd = o, d
        if not wide._is_identity(w2o):
            ro, rd = binary.transform(torch.tensor(w2o, dtype=torch.float32), o, d)
        treelet.plain_walk(ks.wide_child, ks.wide_perm, boxes, leaf,
                           ks.tri_rows if is_tri else ks.sph_rows, is_tri, root, ro, rd,
                           treelet._inst_enc(entry) << prim_bits, t_best, pp,
                           ks.thread_stack)
    return t_best, pp


@pytest.mark.parametrize("case", list(ANYHIT_CASES))
def test_host_built_k4_keeps_the_plain_walk_order(host, case):
    """K4 (csrc/node_walk.cuh over the quantized records) equals the
    order-exact plain walk bit for bit in t and pp on primary and bounce
    rays: a tie in t goes to the primitive tested first, so equal pp pins
    the test order."""
    build, camera = ANYHIT_CASES[case]
    scene = build()
    ss = stream.prepare_stream(scene)
    o, d = host.jittered_rays(camera(48, 32), 48, 32, 1)
    bo, bd = host.bounce_rays(scene, host.primary_hits(stream, ss, o, d), o, d, 2)
    launches = stream.LAUNCHES["stream_closest"]
    for ro, rd in ((o, d), (bo, bd)):
        t_k, pp_k = stream._launch(ss, ro, rd, torch.full((ro.shape[0],), T_INF),
                                   any_hit=False)
        t_p, pp_p = _plain_order_walk(ss, ro, rd)
        assert int((pp_p >= 0).sum()) > 100
        assert torch.equal(t_k, t_p) and torch.equal(pp_k, pp_p)
    assert stream.LAUNCHES["stream_closest"] - launches == 2


WIDE_CASES = {
    "cornell_leaf8": (CASES["cornell_wide"][1], cornell.cornell_camera),
    "default_spheres": (ROUND_CASES["default_binary_treelet"][1], Camera.create),
}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_host_built_k1_keeps_the_plain_walk_order(host, case):
    """K1 (node_walk.cuh over the exact-box records) equals the order-exact
    plain walk bit for bit in t and pp on primary and bounce rays, as K4
    does: K7's rounds equal K1 on the card by this order."""
    build, camera = WIDE_CASES[case]
    scene = build()
    ws = wide.prepare_scene(scene)
    o, d = host.jittered_rays(camera(48, 32), 48, 32, 1)
    bo, bd = host.bounce_rays(scene, host.primary_hits(wide, ws, o, d), o, d, 2)
    launches = wide.LAUNCHES["wide_closest"]
    for ro, rd in ((o, d), (bo, bd)):
        t_k, pp_k = wide._launch(ws, ro, rd, torch.full((ro.shape[0],), T_INF),
                                 any_hit=False)
        t_p, pp_p = _plain_order_walk(ws, ro, rd)
        assert int((pp_p >= 0).sum()) > 100
        assert torch.equal(t_k, t_p) and torch.equal(pp_k, pp_p)
    assert wide.LAUNCHES["wide_closest"] - launches == 2


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_wide_node_records_equal_the_flat_tables(host, case):
    """K1/K2/K7's packed node table (wide.pack_wide_nodes): per wide node the
    48 child-box floats slot-major by axis, bit for bit, then the 8 child
    words and the 8 per-octant order words; rebuilt with the extended tables
    of a treelet cut."""
    ws = wide.prepare_scene(WIDE_CASES[case][0]())
    grown = treelet.prepare_treelets(ws, 8).wscene
    assert grown.wide_child.numel() >= ws.wide_child.numel()
    for ks in (ws, grown):
        w = ks.wide_child.numel() // 8
        rec = ks.nodes
        assert rec.dtype == torch.int32 and tuple(rec.shape) == (w, 64)
        assert rec.is_contiguous() and rec.data_ptr() % 16 == 0
        rec = rec.numpy()
        boxes = ks.wide_bounds.numpy().reshape(w, 8, 6)
        for axis in range(6):  # xlo ylo zlo xhi yhi zhi, 8 slots each
            np.testing.assert_array_equal(rec[:, 8 * axis: 8 * axis + 8],
                                          boxes[:, :, axis].view(np.int32))
        np.testing.assert_array_equal(rec[:, 48:56], ks.wide_child.numpy().reshape(w, 8))
        np.testing.assert_array_equal(rec[:, 56:64], ks.wide_perm.numpy().reshape(w, 8))
        assert 1 <= ks.wide_depth <= 36 and ks.thread_stack == 7 * ks.wide_depth + 1
    assert torch.equal(grown.nodes[:ws.nodes.shape[0]], ws.nodes)


@pytest.fixture(scope="module")
def small_terrain_stream():
    scene = CASES["terrain_stream"][1]()
    o, d = host_check.jittered_rays(terrain.terrain_camera(16, 8), 16, 8, 1)
    return stream.prepare_stream(scene), o, d


@pytest.fixture(scope="module")
def small_cornell_wide():
    scene = CASES["cornell_wide"][1]()
    o, d = host_check.jittered_rays(cornell.cornell_camera(16, 8), 16, 8, 1)
    return wide.prepare_scene(scene), o, d


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5", "K7", "K8"])
def test_wrappers_refuse_tables_deeper_than_the_stack(host, small_terrain_stream,
                                                      small_cornell_wide, kernel):
    """A wide depth above the node-group stack's capacity is refused before
    any launch (the kernel's assert is the last line, not the check)."""
    ss, o, d = small_terrain_stream
    tm = torch.full((o.shape[0],), T_INF)
    mask = torch.full((1,), -1, dtype=torch.int32)
    if kernel in ("K1", "K2"):
        ws, o, d = small_cornell_wide
        deep = copy.copy(ws)
        deep.wide_depth = wide.library()[0].wide_max_depth() + 1
        counts = wide.LAUNCHES
        call = lambda: wide._launch(deep, o, d, tm, any_hit=kernel == "K2")  # noqa: E731
    elif kernel == "K7":
        ws, o, d = small_cornell_wide
        ts = treelet.prepare_treelets(ws, 8)
        ts.wscene = copy.copy(ts.wscene)
        ts.wscene.wide_depth = treelet.library()[0].treelet_max_depth() + 1
        counts = treelet.LAUNCHES
        call = lambda: treelet._launch(ts, mask, o, d, tm, 1)  # noqa: E731
    elif kernel == "K8":
        sts = streamtreelet.prepare_treelets_stream(ss, 8)
        cap = streamtreelet.library()[0].streamtreelet_max_depth()
        sts.sscene = copy.copy(sts.sscene)
        sts.sscene.wide_depth = cap + 1
        counts = streamtreelet.LAUNCHES
        call = lambda: streamtreelet._launch(sts, mask, o, d, tm, 1)  # noqa: E731
    else:
        cap = stream.library()[0].stream_max_depth()
        deep = copy.copy(ss)
        deep.wide_depth = cap + 1
        counts = stream.LAUNCHES
        call = lambda: stream._launch(deep, o, d, tm, any_hit=kernel == "K5")  # noqa: E731
    before = dict(counts)
    with pytest.raises(ValueError, match="node-group stack holds"):
        call()
    assert counts == before


OVERFLOW_CHILD = """
import sys, torch
from ilgpu_raytracing_tpu_torch.models import cornell, terrain
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops.cuda import host_check, stream, wide
import ctypes
cu.load_kernel_library = lambda name: (ctypes.CDLL(sys.argv[1]), 0.0)
cu.stream_ptr = lambda t: None
if sys.argv[2] == "K4":
    mod, camera = stream, terrain.terrain_camera
    ks = stream.prepare_stream(terrain.build_terrain_scene(grid_x=64, grid_z=32,
                                                           device="cpu")[1])
else:
    mod, camera = wide, cornell.cornell_camera
    ks = wide.prepare_scene(cornell.build_cornell_scene(
        tess=4, sphere_tess=(8, 12), blas_leaf_size=8, bvh_method="sah", device="cpu")[1])
o, d = host_check.jittered_rays(camera(32, 16), 32, 16, 1)
ks.wide_depth = 0  # no stack entry: the first push must fail the walk's assert
mod._launch(ks, o, d, torch.full((o.shape[0],), 1e30), any_hit=False)
print("the walk returned")
"""


@pytest.mark.parametrize("kernel", ["K4", "K1"])
def test_host_built_k4_fails_its_assert_past_the_stack_bound(host, kernel):
    """K4 (small terrain) or K1 (leaf-8 Cornell box) called with a stack cap
    of 0 (the walks need at most wide depth - 1 entries, so a cap of 1 may
    hold): the walk's assert ends the process (on the card, the device-side
    assert fails the next synchronizing call; chip_smoke.py checks that in a
    child process)."""
    lib = "libstream_trace.so" if kernel == "K4" else "libwide_trace.so"
    so = os.path.join(BUILD_DIR, "host", lib)  # the fixture's build
    proc = subprocess.run(
        [sys.executable, "-c", OVERFLOW_CHILD, so, kernel], capture_output=True,
        text=True, timeout=300,  # the abort writes no core file
        preexec_fn=lambda: resource.setrlimit(resource.RLIMIT_CORE, (0, 0)),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "the walk returned" not in proc.stdout
    assert "node-group stack overflow" in proc.stderr, proc.stderr[-2000:]


BINARY_CASES = {
    "cornell_leaf8": CASES["cornell_wide"][1],
    "default_spheres": ROUND_CASES["default_binary_treelet"][1],
    "default_single": lambda: build_default_scene(single_instance=True, device="cpu")[1],
}


@pytest.mark.parametrize("case", list(BINARY_CASES))
def test_binary_pair_records_equal_the_flat_tables(case):
    """K6's child-pair records (binary.pair_records) against the flat
    (Nn, 6) / (Nn, 4) tables: one record per inner node reachable from an
    instance root, in node order; child 0 is `left`, child 1 is n + 1, which
    is also `left`'s skip; each child's box bit for bit and its word (the
    child's record index, or the leaf's row and count); each instance's
    root record (its box and word) in meta order; the depth of the deepest
    root-to-leaf path in inner nodes."""
    bs = binary.prepare_binary(BINARY_CASES[case]())
    boxes, node_i = bs.nodes.numpy(), bs.node_i.numpy()
    roots = [m[1] for m in bs.meta]
    inner, depth = [], 0
    todo = [(r, 0) for r in set(roots)]
    while todo:  # the tree under each root, with each node's inner depth
        n, above = todo.pop()
        if node_i[n, 2] > 0:
            depth = max(depth, above)
            continue
        inner.append(n)
        todo += [(node_i[n, 0], above + 1), (n + 1, above + 1)]
    inner = sorted(inner)
    rank = {n: k for k, n in enumerate(inner)}

    def word(c):
        if node_i[c, 2] == 0:
            return rank[c]
        return ~(int(node_i[c, 1]) << 3 | int(node_i[c, 2]) - 1)

    def assert_child(r, child):  # 8 ints: box bits, word, 0
        np.testing.assert_array_equal(r[:6], boxes[child].view(np.int32))
        assert r[6] == word(child) and r[7] == 0

    rec = bs.pairs.numpy()
    for x in (bs.pairs, bs.roots):
        assert x.dtype == torch.int32 and x.data_ptr() % 16 == 0
    assert rec.shape == (max(1, len(inner)), 16) and bs.depth == depth
    for n in inner:
        left = node_i[n, 0]
        assert left > n + 1 and node_i[left, 3] == n + 1  # n + 1 is left's skip
        for c, child in enumerate((left, n + 1)):
            assert_child(rec[rank[n], 8 * c: 8 * c + 8], child)
    assert bs.roots.shape == (len(roots), 8)
    for r, root in zip(bs.roots.numpy(), roots):
        assert_child(r, root)
    # six one-leaf instances; one six-sphere BLAS of leaf 4; the Cornell box
    assert len(inner) >= {"default_spheres": 0, "default_single": 1}.get(case, 50)


def _tie_scene(copies: int, leaf: int):
    """A 7 x 5 grid of 0.5-unit quads on y = 0 (x in [-2, 1.5], z in [-1.5,
    1]) whose triangles appear `copies` times (same vertices, new prim ids),
    SAH BVH leaves of `leaf` triangles, and rays that tie: straight down onto
    the grid's vertices and edge midpoints (dyadic, so t = 1 and the
    barycentrics are exact and each triangle touching the point accepts
    it), plus 768 camera rays, on which every hit ties between the copies.
    Returns the scene, the triangles in one copy, and the rays."""
    from ilgpu_raytracing_tpu_torch.models.materials import Material
    from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder

    nx, nz = 7, 5
    gx, gz = np.meshgrid(np.arange(nx + 1) * 0.5 - 2.0, np.arange(nz + 1) * 0.5 - 1.5,
                         indexing="ij")
    v = np.stack([gx.reshape(-1), np.zeros(gx.size), gz.reshape(-1)], 1)
    idx = np.arange(gx.size).reshape(nx + 1, nz + 1)
    a, b, c, d = (idx[:-1, :-1], idx[1:, :-1], idx[:-1, 1:], idx[1:, 1:])
    t = np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                        np.stack([a, d, c], -1).reshape(-1, 3)])
    sb = SceneBuilder(blas_leaf_size=leaf, bvh_method="sah")
    sb.add_material(Material(kd=(0.7, 0.6, 0.5)))
    sb.add_mesh_instance(v.astype(np.float32), np.concatenate([t] * copies))
    # the far edges x = 1.5, z = 1 lie on the slab's boundary, which a ray
    # along the axis misses (hi = 0 < T_EPS): left out
    x, z = (a.reshape(-1) for a in np.meshgrid(np.arange(2 * nx) * 0.25 - 2.0,
                                               np.arange(2 * nz) * 0.25 - 1.5,
                                               indexing="ij"))
    down = torch.as_tensor(np.stack([x, np.ones_like(x), z], 1), dtype=torch.float32)
    cam = Camera.look_at((0.3, 3.0, 2.5), (0, 0, 0), (0, 1, 0), 60.0, 1.5)
    o, d = host_check.jittered_rays(cam, 32, 24, 1)
    o = torch.cat([down, o]).contiguous()
    d = torch.cat([torch.tensor([[0.0, -1.0, 0.0]]).expand(down.shape[0], 3), d])
    return sb.commit(device="cpu"), t.shape[0], o, d.contiguous()


def _random_tree(scene, seed: int):
    """K6 tables of `scene`'s triangles (one identity instance) over a binary
    tree of random shape in the builders' layout (node, right subtree, left
    subtree; child 1 = n + 1 = left's skip): triangles in a random order,
    random split points, leaves of 1-4 triangles. Unlike the builders'
    median split, it makes inner-left / leaf-right nodes, where a walk
    that tested leaf children first would break a tie the other way."""
    rng = np.random.default_rng(seed)
    v0, e1, e2 = (getattr(scene, f).numpy() for f in ("tri_v0", "tri_e1", "tri_e2"))
    corners = np.stack([v0, v0 + e1, v0 + e2], 1)
    boxes, ifields, rows = [], [], []

    def build(ids, skip):
        n = len(ifields)
        boxes.append(np.concatenate([corners[ids].min((0, 1)), corners[ids].max((0, 1))]))
        ifields.append([-1, -1, 0, skip])
        if len(ids) == 1 or (len(ids) <= 4 and rng.random() < 0.5):
            row = np.zeros((128,), np.float32)
            for j, p in enumerate(ids):
                row[12 * j: 12 * j + 10] = np.concatenate([v0[p], e1[p], e2[p], [p]])
            ifields[n][1:3] = [len(rows), len(ids)]
            rows.append(row)
            return n
        mid = int(rng.integers(1, len(ids)))
        right = build(ids[mid:], skip)
        ifields[n][0] = build(ids[:mid], right)
        return n

    build(rng.permutation(v0.shape[0]), -1)
    nodes = np.zeros((len(boxes), 128), np.float32)
    nodes[:, :6] = np.stack(boxes)
    lo, hi = corners.min((0, 1)), corners.max((0, 1))
    meta = ((BLAS_TRI_MESH, 0, (1.0, 0, 0, 0, 0, 1.0, 0, 0, 0, 0, 1.0, 0),
             tuple(lo.tolist() + hi.tolist()), 0),)
    return binary.binary_from_numpy(dict(
        nodes_rows=nodes, node_ifields=np.asarray(ifields, np.int32).reshape(-1),
        tri_rows=np.stack(rows), sph_rows=np.zeros((1, 128), np.float32), meta=meta,
        leaf_width=max(f[2] for f in ifields), needs_bary=True), scene)


@pytest.mark.parametrize("copies,leaf,tree", [(1, 1, "sah"), (2, 1, "sah"), (3, 2, "sah"),
                                              (2, 1, "random"), (3, 1, "random")])
def test_host_built_k6_keeps_the_preorder_on_ties(host, copies, leaf, tree):
    """K6 on rays that tie in t between triangles (edge- and
    vertex-sharing triangles, duplicated triangles), over the SAH build and
    over trees of random shape: t, prim, inst, bu, bv equal the plain
    skip-index walk bit for bit. A tie goes to the primitive tested first,
    so this pins the walk's order: the left subtree before the right, and
    a leaf child no earlier than its place in that order. Later copies win
    somewhere, so no fixed rule of ids stands in for the order."""
    scene, n_tri, o, d = _tie_scene(copies, leaf)
    bs = binary.prepare_binary(scene) if tree == "sah" else _random_tree(scene, copies)
    tm = torch.full((o.shape[0],), T_INF)
    got = binary._launch(bs, o, d, tm, any_hit=False)
    want = binary.trace_plain(bs, o, d, tm)
    for name, a, b in zip(("t", "prim", "inst", "bu", "bv"), got, want):
        assert torch.equal(a, b), name
    prim = want[1][want[1] >= 0]
    assert prim.numel() > 250 and bool((want[0][:140] == 1.0).all())
    if copies > 1:
        assert bool((prim >= n_tri).any())


@pytest.mark.parametrize("tree", ["sah", "random"])
def test_host_built_k6_counts_the_skip_walks_work(host, tree):
    """K6's counting variant (closest at T_INF, any-hit at t_max 5 and
    1e29, some lanes inactive) counts the boxes and primitives that the
    plain skip-index walk tests, on trees of two shapes: its bound
    (chip_smoke.trace_bound) counts the function's work, not the extra
    tests of the design, such as an any-hit visit's test of a second
    child that the walk never reaches once it hits in the first."""
    scene, _, o, d = _tie_scene(2, 2)
    bs = binary.prepare_binary(scene) if tree == "sah" else _random_tree(scene, 5)
    live = torch.as_tensor(np.random.default_rng(3).random(o.shape[0]) < 0.9)
    for t_max, any_hit in ((T_INF, False), (5.0, True), (1e29, True)):
        tm = torch.where(live, t_max, 0.0).to(torch.float32)
        work = torch.zeros((2,), dtype=torch.int64)
        binary._launch(bs, o, d, tm, any_hit=any_hit, work=work)
        assert work.tolist() == list(binary.count_work(bs, o, d, tm, any_hit)), t_max


def test_k6_wrapper_refuses_tables_deeper_than_its_stack(host, small_cornell_wide):
    """A depth above the kernel's stack (binary_max_depth) is refused before
    any launch."""
    _, o, d = small_cornell_wide
    bs = binary.prepare_binary(CASES["cornell_wide"][1]())
    deep = copy.copy(bs)
    deep.depth = binary.library()[0].binary_max_depth() + 1
    before = dict(binary.LAUNCHES)
    for any_hit in (False, True):
        with pytest.raises(ValueError, match="node stack holds"):
            binary._launch(deep, o, d, torch.full((o.shape[0],), T_INF), any_hit=any_hit)
    assert binary.LAUNCHES == before


K6_OVERFLOW_CHILD = """
import sys, torch
from ilgpu_raytracing_tpu_torch.models import cornell
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops.cuda import binary, host_check
import ctypes
cu.load_kernel_library = lambda name: (ctypes.CDLL(sys.argv[1]), 0.0)
cu.stream_ptr = lambda t: None
bs = binary.prepare_binary(cornell.build_cornell_scene(
    tess=4, sphere_tess=(8, 12), blas_leaf_size=8, bvh_method="sah", device="cpu")[1])
o, d = host_check.jittered_rays(cornell.cornell_camera(32, 16), 32, 16, 1)
assert bs.depth > 1
bs.depth = 1  # one entry: a ray with two pending second children fails
binary._launch(bs, o, d, torch.full((o.shape[0],), 1e30), any_hit=False)
print("the walk returned")
"""


def test_host_built_k6_fails_its_assert_past_the_stack_bound(host):
    """K6 (leaf-8 Cornell box) called with a stack cap of 1, below the
    depth the host proved: the walk's assert ends the process (on the card,
    the device-side assert fails the next synchronizing call; chip_smoke.py
    checks that in a child process)."""
    so = os.path.join(BUILD_DIR, "host", "libbinary_trace.so")  # the fixture's build
    proc = subprocess.run(
        [sys.executable, "-c", K6_OVERFLOW_CHILD, so], capture_output=True,
        text=True, timeout=300,  # the abort writes no core file
        preexec_fn=lambda: resource.setrlimit(resource.RLIMIT_CORE, (0, 0)),
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode != 0, proc.stdout + proc.stderr
    assert "the walk returned" not in proc.stdout
    assert "binary walk: node stack overflow" in proc.stderr, proc.stderr[-2000:]
