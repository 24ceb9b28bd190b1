"""Port vs JAX reference on the CPU: every committed SceneData table and every
kernel-prep table (binary leaf packing + 8-wide collapse, including
stack_cap, leaf_width and needs_bary) must be exactly equal."""

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu.models import camera as jcamera
from ilgpu_raytracing_tpu.models import canyon as jcanyon
from ilgpu_raytracing_tpu.models import cornell as jcornell
from ilgpu_raytracing_tpu.models import scene as jscene
from ilgpu_raytracing_tpu.ops.pallas import traverse_kernel as jtk
from ilgpu_raytracing_tpu.ops.pallas import wide_kernel as jwk
from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.models import camera as tcamera
from ilgpu_raytracing_tpu_torch.models import canyon as tcanyon
from ilgpu_raytracing_tpu_torch.models import cornell as tcornell
from ilgpu_raytracing_tpu_torch.models import scene as tscene
from ilgpu_raytracing_tpu_torch.ops.cuda import wide as twide
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


def build_transformed_scene(scene_mod, cornell_mod, **commit_kw):
    """Two instances with non-identity transforms: a uniformly scaled and
    rotated sphere set, and a translated triangle grid. Built the same way
    with either package's modules (`commit_kw` carries the port's device)."""
    b = scene_mod.SceneBuilder(blas_leaf_size=4)
    mat = b.add_material(scene_mod.Material(kd=(0.7, 0.6, 0.5)))
    s0 = b.add_sphere((0.0, 0.0, 0.0), 0.5, (1, 1, 1), mat)
    s1 = b.add_sphere((0.8, 0.2, 0.0), 0.3, (1, 1, 1), mat)
    c, s = np.cos(0.5), np.sin(0.5)
    o2w = scene_mod.scale_affine(1.5, (0.2, 0.3, -0.5))
    o2w[:, :3] = o2w[:, :3] @ np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    b.add_sphere_instance([s0, s1], o2w)
    v, t = cornell_mod._quad_grid((-2, 0, -2), (2, 0, -2), (-2, 0, 2), 6)
    b.add_mesh_instance(v, t, object_to_world=scene_mod.translation_affine((0, -0.6, 0)))
    return None, b.commit(**commit_kw)


CASES = {
    "cornell_median": (
        lambda m, **kw: m.build_cornell_scene(tess=4, sphere_tess=(8, 12), **kw), False),
    "cornell_sah_leaf8": (
        lambda m, **kw: m.build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                                              bvh_method="sah", **kw), True),
    "default_single": (
        lambda m, **kw: m.build_default_scene(single_instance=True, **kw), False),
    "default_multi": (
        lambda m, **kw: m.build_default_scene(single_instance=False, **kw), False),
    "transformed": (None, False),
    "canyon": (lambda m, **kw: m.build_canyon_scene(**kw), False),
}


def _build(case):
    make, needs_native = CASES[case]
    if needs_native and not tnative.available():
        pytest.skip("no C++ compiler: the SAH build is native-only")
    if case == "transformed":
        return (build_transformed_scene(jscene, jcornell)[1],
                build_transformed_scene(tscene, tcornell, device="cpu")[1])
    jmod, tmod = ((jcornell, tcornell) if case.startswith("cornell") else
                  (jcanyon, tcanyon) if case == "canyon" else (jscene, tscene))
    return make(jmod)[1], make(tmod, device="cpu")[1]


@pytest.mark.parametrize("op", ["create", "look_at", "translate", "set_fov",
                                "rotate_yaw_pitch", "fly", "canyon_camera"])
def test_camera_matches_reference(op):
    jc = jcamera.Camera.create(320, 180, 55.0)
    tc = tcamera.Camera.create(320, 180, 55.0)
    if op == "canyon_camera":
        jc, tc = jcanyon.canyon_camera(320, 180), tcanyon.canyon_camera(320, 180)
    elif op == "look_at":
        args = ((0.3, 1.2, 4.0), (0.1, 0.0, -0.5), (0, 1, 0), 40.0, 1.7)
        jc, tc = jcamera.Camera.look_at(*args), tcamera.Camera.look_at(*args)
    elif op == "translate":
        jc, tc = jc.translate([0.5, -0.2, 1.0]), tc.translate([0.5, -0.2, 1.0])
    elif op == "set_fov":
        jc, tc = jc.set_fov(72.0, 1.5), tc.set_fov(72.0, 1.5)
    elif op == "rotate_yaw_pitch":
        jc, tc = jc.rotate_yaw_pitch(17.0, -8.0), tc.rotate_yaw_pitch(17.0, -8.0)
    elif op == "fly":
        jc, tc = jc.fly(1.0, -0.5, 0.25, 0.016), tc.fly(1.0, -0.5, 0.25, 0.016)
    for f in ("origin", "lower_left", "horizontal", "vertical", "forward",
              "right", "up", "aspect", "fov_y"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), getattr(tc, f))


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    np.testing.assert_array_equal(a.astype(b.dtype) if a.dtype != b.dtype else a, b,
                                  err_msg=what)


@pytest.mark.parametrize("case", list(CASES))
def test_scene_tables_equal(case):
    js, ts = _build(case)
    got = ts.to_numpy()
    for name in tscene._FIELDS:
        _same(getattr(js, name), got[name], name)
    assert (js.has_alpha, js.blas_leaf_max, js.tlas_leaf_max) == (
        ts.has_alpha, ts.blas_leaf_max, ts.tlas_leaf_max)
    # scene_from_numpy round trip of the JAX tables gives the same scene
    tables = {k: np.asarray(getattr(js, k)) for k in tscene._FIELDS}
    tables.update(has_alpha=js.has_alpha, blas_leaf_max=js.blas_leaf_max,
                  tlas_leaf_max=js.tlas_leaf_max)
    back = tscene.scene_from_numpy(tables, "cpu").to_numpy()
    for name in tscene._FIELDS:
        _same(got[name], back[name], name)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_prep_tables_equal(case):
    js, ts = _build(case)
    jp = jtk.prepare(js)
    tp = twide.prepare(ts)
    for name in ("nodes_rows", "node_ifields", "tri_rows", "sph_rows"):
        _same(getattr(jp, name), getattr(tp, name), name)
    assert jp.meta == tp.meta
    assert (jp.leaf_width, jp.needs_bary) == (tp.leaf_width, tp.needs_bary)

    jw = jwk.prepare_wide(jp)
    tw = twide.prepare_wide(tp, ts)
    for name in ("wide_bounds", "wide_child", "wide_perm", "tri_rows",
                 "sph_rows", "tri_v0e", "inst_w2o"):
        _same(getattr(jw, name), getattr(tw, name).numpy(), name)
    assert jw.meta == tw.meta
    assert (jw.stack_cap, jw.leaf_width, jw.needs_bary) == (
        tw.stack_cap, tw.leaf_width, tw.needs_bary)

    # the device instance table carries the meta tuple
    ii, ff = tw.inst_i.numpy(), tw.inst_f.numpy()
    for k, (kind, root, w2o, wb, inst_id) in enumerate(tw.meta):
        assert tuple(ii[k, :3]) == (kind, root, inst_id)
        np.testing.assert_array_equal(ff[k], np.asarray(w2o + wb, np.float32))
    # and the JAX tables load through wide_from_numpy to the same scene
    jt = {n: np.asarray(getattr(jw, n)) for n in (
        "wide_bounds", "wide_child", "wide_perm", "tri_rows", "sph_rows",
        "tri_v0e", "inst_w2o")}
    jt.update(meta=jw.meta, stack_cap=jw.stack_cap, leaf_width=jw.leaf_width,
              needs_bary=jw.needs_bary)
    tw2 = twide.wide_from_numpy(jt, ts)
    assert tw2.thread_stack == tw.thread_stack
    np.testing.assert_array_equal(tw2.inst_i.numpy(), ii)


def _wide_depth(wc, wid):
    kids = [c for c in wc[wid] if c >= 0]
    return 1 + max((_wide_depth(wc, c) for c in kids), default=0)


@pytest.mark.parametrize("case", ["cornell_median", "cornell_sah_leaf8"])
def test_thread_stack_bound_covers_dfs(case):
    """7 * wide depth + 1 bounds a per-thread DFS that pushes every child:
    simulate the all-hit walk (pop one node, push its inner children) and
    check the bound; every binary leaf appears once among wide children."""
    _, ts = _build(case)
    tp = twide.prepare(ts)
    tw = twide.prepare_wide(tp, ts)
    wc = tw.wide_child.numpy().reshape(-1, 8)
    worst = 0
    for _kind, root, _w, _b, _i in tw.meta:
        stack = [root]
        while stack:
            wid = stack.pop()
            stack.extend(int(c) for c in wc[wid] if c >= 0)
            worst = max(worst, len(stack))
        assert tw.thread_stack >= 7 * _wide_depth(wc, root) + 1
    assert 1 <= worst <= tw.thread_stack
    ifl = tp.node_ifields.reshape(-1, 4)
    binary = sorted((int(f), int(c)) for _l, f, c, _s in ifl if c > 0)
    wide_leaves = sorted(((-int(v) - 2) // 16, (-int(v) - 2) % 16) for v in wc[wc <= -2])
    assert wide_leaves == binary


def test_reference_native_recovers_from_a_failed_load():
    """A failed load of the reference scene core is remembered by its
    loader for the life of the process, and the reference then builds
    median BVHs where SAH ones are asked for. The helper clears it: the
    reference loads again and builds the same SAH tables as the port."""
    import ilgpu_raytracing_tpu.native as ref_native

    ref_native._tried, ref_native._lib = True, None
    assert not ref_native.available()
    ensure_reference_native()
    assert ref_native.available()
    js, ts = _build("cornell_sah_leaf8")
    got = ts.to_numpy()
    for name in ("blas_bmin", "blas_bmax", "blas_ifields", "tri_prim_idx"):
        _same(getattr(js, name), got[name], name)
    median = jcornell.build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                                          bvh_method="median")[1]
    assert not np.array_equal(np.asarray(median.blas_ifields), got["blas_ifields"])
