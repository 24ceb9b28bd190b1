"""Port vs JAX reference on the CPU: the dynamic-scene path (BASELINE
config 4).

- `bvh.refit_bvh` on random median and SAH trees, bit-equal to JAX's;
- the native refit and triangle bounds bit-equal to the port's numpy ones;
- `refit_mesh_instance` twice in a row: every table bit-equal to JAX's
  refit of the same builder, and the input scene's tensors unchanged;
- plain-walk hits on the refit scene against JAX's `traverse.trace_closest`
  on its refit scene, and against a fresh build of the moved geometry, at
  the traversal bar of tests/test_bvh.py (hit masks equal, t within 1e-5);
- a 3-frame animate loop (examples/animate.py: refit, `set_scene`, orbiting
  camera, progressive accumulation) through the port's CPU `Renderer`
  against the JAX `Renderer`, at the golden bar of tests/test_golden.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu.config import RenderConfig as JConfig
from ilgpu_raytracing_tpu.models import bvh as jbvh
from ilgpu_raytracing_tpu.models import camera as jcamera
from ilgpu_raytracing_tpu.models import cornell as jcornell
from ilgpu_raytracing_tpu.models import scene as jscene
from ilgpu_raytracing_tpu.ops import traverse as jtraverse
from ilgpu_raytracing_tpu.runtime import renderer as jrenderer
from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models import bvh as tbvh
from ilgpu_raytracing_tpu_torch.models import camera as tcamera
from ilgpu_raytracing_tpu_torch.models import cornell as tcornell
from ilgpu_raytracing_tpu_torch.models import scene as tscene
from ilgpu_raytracing_tpu_torch.ops import traverse as ttraverse
from ilgpu_raytracing_tpu_torch.runtime import renderer as trenderer
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


def _random_boxes(n, seed):
    rs = np.random.default_rng(seed)
    c = rs.normal(size=(n, 3)).astype(np.float32) * 3.0
    e = np.abs(rs.normal(size=(n, 3))).astype(np.float32) * 0.2
    return c - e, c + e, c


@pytest.mark.parametrize("method", ["median", "sah"])
def test_refit_bvh_matches_reference(method):
    if method == "sah" and not tnative.available():
        pytest.skip("no C++ compiler: the SAH build is native-only")
    bmin, bmax, c = _random_boxes(300, seed=5)
    _, _, nif, order = tbvh.build_skip_index_bvh(bmin, bmax, c, 4, method)
    rs = np.random.default_rng(6)
    shift = rs.normal(size=bmin.shape).astype(np.float32) * 0.5
    nb_j, nx_j = jbvh.refit_bvh(nif, order, bmin + shift, bmax + shift)
    nb_t, nx_t = tbvh.refit_bvh(nif, order, bmin + shift, bmax + shift)
    np.testing.assert_array_equal(nb_t, nb_j)
    np.testing.assert_array_equal(nx_t, nx_j)
    # the refit of the unmoved boxes is the build's own bounds
    nb0, nx0, _, _ = tbvh.build_skip_index_bvh(bmin, bmax, c, 4, method)
    rb, rx = tbvh.refit_bvh(nif, order, bmin, bmax)
    np.testing.assert_array_equal(rb, nb0)
    np.testing.assert_array_equal(rx, nx0)


def test_native_refit_and_triangle_bounds_equal_numpy():
    if not tnative.available():
        pytest.skip("no C++ compiler: nothing native to compare")
    rs = np.random.default_rng(11)
    v0, v1, v2 = (rs.normal(size=(500, 3)).astype(np.float32) for _ in range(3))
    bmin, bmax, cen = tnative.triangle_bounds(v0, v1, v2)
    pb, px = tbvh.triangle_bounds(v0, v1, v2)
    np.testing.assert_array_equal(bmin, pb)
    np.testing.assert_array_equal(bmax, px)
    np.testing.assert_allclose(cen, (v0 + v1 + v2) / 3.0, rtol=1e-6, atol=1e-6)
    _, _, nif, order = tbvh.build_skip_index_bvh(pb, px, cen, 8, "sah")
    moved = [x + rs.normal(size=x.shape).astype(np.float32) * 0.3 for x in (v0, v1, v2)]
    mb, mx = tbvh.triangle_bounds(*moved)
    got = tnative.refit_bvh(nif, order, mb, mx)
    want = tbvh.refit_bvh(nif, order, mb, mx)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _soup():
    rs = np.random.RandomState(3)
    v = rs.randn(80, 3).astype(np.float32)
    t = rs.randint(0, 80, size=(120, 3)).astype(np.int32)
    return v, t[(t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])]


def _mesh_scene(mod, v, t, **commit_kw):
    """A sphere instance beside a random triangle soup (tests/test_bvh.py's
    refit scene), built the same way with either package's modules."""
    b = mod.SceneBuilder()
    b.add_material(mod.Material())
    b.add_sphere((5, 0, 0), 1.0)
    b.add_sphere_instance([0])
    b.add_mesh_instance(v, t)
    return b, b.commit(**commit_kw)


def _moves():
    rs = np.random.RandomState(4)
    v = _soup()[0]
    v2 = (v + rs.randn(*v.shape).astype(np.float32) * 0.3).astype(np.float32)
    return v2, (v2 + 0.1).astype(np.float32)


def _tables(scene) -> dict:
    out = {k: np.asarray(getattr(scene, k)) if not isinstance(getattr(scene, k), torch.Tensor)
           else getattr(scene, k).numpy() for k in tscene._FIELDS}
    out.update(has_alpha=scene.has_alpha, blas_leaf_max=scene.blas_leaf_max,
               tlas_leaf_max=scene.tlas_leaf_max)
    return out


def _assert_tables_equal(got: dict, want: dict):
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape, k
            np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=k)
        else:
            assert g == w, k


def test_refit_mesh_instance_twice_matches_reference():
    jb, js = _mesh_scene(jscene, *_soup())
    tb, ts = _mesh_scene(tscene, *_soup(), device="cpu")
    _assert_tables_equal(_tables(ts), _tables(js))
    before = {k: v.clone() for k, v in vars(ts).items() if isinstance(v, torch.Tensor)}
    v2, v3 = _moves()
    js1 = jscene.refit_mesh_instance(jb, js, 1, v2)
    ts1 = tscene.refit_mesh_instance(tb, ts, 1, v2)
    _assert_tables_equal(_tables(ts1), _tables(js1))
    js2 = jscene.refit_mesh_instance(jb, js1, 1, v3)
    ts2 = tscene.refit_mesh_instance(tb, ts1, 1, v3)
    _assert_tables_equal(_tables(ts2), _tables(js2))
    np.testing.assert_array_equal(tb.positions, jb.positions)
    # the refit moved the tables it owns, and wrote into none of the input's
    assert not np.array_equal(ts2.tri_v0.numpy(), ts.tri_v0.numpy())
    for k, v in before.items():
        assert torch.equal(getattr(ts, k), v), f"refit wrote into the input scene's {k}"
    assert ts2.n_spheres == js2.n_spheres == 1 and ts2.n_tris == js2.n_tris


def test_refit_scene_hits_match_reference_and_rebuild():
    v, t = _soup()
    jb, js = _mesh_scene(jscene, v, t)
    tb, ts = _mesh_scene(tscene, v, t, device="cpu")
    rs = np.random.RandomState(5)
    o = rs.randn(256, 3).astype(np.float32) * 2
    d = rs.randn(256, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    for moved in _moves():  # two compounding refits
        js = jscene.refit_mesh_instance(jb, js, 1, moved)
        ts = tscene.refit_mesh_instance(tb, ts, 1, moved)
        h_t = ttraverse.trace_closest(ts, ot, dt)
        h_j = jtraverse.trace_closest(js, jnp.asarray(o), jnp.asarray(d))
        h_f = ttraverse.trace_closest(_mesh_scene(tscene, moved, t, device="cpu")[1],
                                      ot, dt)
        assert int(h_t.hit.sum()) > 20
        for hit_r, t_r in ((np.asarray(h_j.hit), np.asarray(h_j.t)),
                           (h_f.hit.numpy(), h_f.t.numpy())):
            np.testing.assert_array_equal(h_t.hit.numpy(), hit_r)
            np.testing.assert_allclose(h_t.t.numpy()[hit_r], t_r[hit_r],
                                       rtol=1e-5, atol=1e-5)


W = H = 32
FRAMES = 3


def _golden_bar(got, want):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.mean() < 0.02, f"mean drift {diff.mean():.4f}"
    frac_big = (diff.max(axis=-1) > 0.1).mean()
    assert frac_big < 0.01, f"{frac_big:.3%} pixels changed materially"


def _animate(mod_scene, mod_cornell, mod_camera, renderer_cls, cfg, **kw):
    """examples/animate.py's loop: bob the sphere, refit, set_scene, orbit
    the camera, render. Returns the frames (H, W, 3) uint8."""
    builder, scene = mod_cornell.build_cornell_scene(tess=4, sphere_tess=(8, 12), **kw)
    inst = builder.instances[0]
    verts = slice(inst.vertex_first, inst.vertex_first + inst.vertex_count)
    base = builder.positions.copy()
    r = renderer_cls(out_w=W, out_h=H, cfg=cfg, scene=scene, **kw)
    r.sun_azimuth, r.sun_elevation = 0.3, 0.6
    frames = []
    for f in range(FRAMES):
        phase = 2.0 * math.pi * f / FRAMES
        moved = base.copy()
        moved[-9 * 12:, 1] += 0.15 * math.sin(phase)  # the (8, 12) sphere's vertices
        r.set_scene(mod_scene.refit_mesh_instance(builder, r.scene, 0, moved[verts]))
        r.set_camera(mod_camera.Camera.look_at(
            (3.2 * math.sin(phase * 0.25), 0.2, 3.2 * math.cos(phase * 0.25)),
            (0, 0, 0), (0, 1, 0), 40.0, W / H))
        r.render()
        frames.append(np.asarray(r.frame_rgb()))
    return frames, r


def test_animate_loop_matches_reference():
    knobs = dict(spp=2, max_depth=3, progressive_accumulation=True)
    jframes, _ = _animate(jscene, jcornell, jcamera, jrenderer.Renderer, JConfig(**knobs))
    tframes, r = _animate(tscene, tcornell, tcamera, trenderer.Renderer,
                          RenderConfig(**knobs), device="cpu")
    assert r.wscene is not None and r.frame == FRAMES
    for f, (tf, jf) in enumerate(zip(tframes, jframes)):
        assert tf.shape == (H, W, 3)
        _golden_bar(tf / 255.0, jf / 255.0)
    assert not np.array_equal(tframes[0], tframes[-1])
