"""The port's large-scene streaming path vs the JAX reference on the CPU.

Scenes: the small terrain (grid 64 x 32 = 4,096 triangles, leaf 64, SAH)
and the Cornell box of tests/test_stream_kernel.py (tess=6, sphere_tess=
(10, 14), leaf 64, SAH). Host prep (terrain tables, `prepare_stream`,
`_quantize_bounds`, `cut_scene_treelets`, the treelet sort key) must equal
the JAX package's exactly. K4/K5 run their plain versions here (CPU
tensors) and are held to the bar of tests/test_stream_kernel.py:39-54
against the JAX XLA tracer, the oracle those tests use: no |dt| > 1e-3,
prim agreement > 99.5% (shared-edge t ties may pick either triangle), and
occlusion equal on active lanes. The JAX stream kernel itself is not run
(Pallas interpret mode costs tens of seconds per call on a CPU). The XLA
oracle traces the same triangles through a leaf-4 BVH: it unrolls its leaf
loop to the scene's largest leaf, and at leaf 64 XLA takes minutes to
compile the integrator on a CPU. The CUDA kernels run only on the card
(chip_smoke.py)."""

import functools
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene import _same as _same_scene_field
from test_torch_scene import build_transformed_scene

from ilgpu_raytracing_tpu.config import RenderConfig as JConfig
from ilgpu_raytracing_tpu.models import bvh as jbvh
from ilgpu_raytracing_tpu.models import cornell as jcornell_mod
from ilgpu_raytracing_tpu.models import scene as jscene_mod
from ilgpu_raytracing_tpu.models import terrain as jterrain
from ilgpu_raytracing_tpu.ops import integrator as jint
from ilgpu_raytracing_tpu.ops import rays as jrays
from ilgpu_raytracing_tpu.ops import sky as jsky
from ilgpu_raytracing_tpu.ops import sort as jsort
from ilgpu_raytracing_tpu.ops import traverse as jtr
from ilgpu_raytracing_tpu.ops.pallas import stream_kernel as jsk
from ilgpu_raytracing_tpu.ops.restir import Reservoirs as JRes
from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.config import PARITY_KNOBS, RenderConfig
from ilgpu_raytracing_tpu_torch.models import bvh as tbvh
from ilgpu_raytracing_tpu_torch.models import cornell as tcornell_mod
from ilgpu_raytracing_tpu_torch.models import scene as tscene_mod
from ilgpu_raytracing_tpu_torch.models import terrain as tterrain
from ilgpu_raytracing_tpu_torch.models.scene import _FIELDS
from ilgpu_raytracing_tpu_torch.ops import integrator as tint
from ilgpu_raytracing_tpu_torch.ops import sort as tsort
from ilgpu_raytracing_tpu_torch.ops import traverse as ttr
from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos as tspk
from ilgpu_raytracing_tpu_torch.ops.cuda import stream as tstream
from ilgpu_raytracing_tpu_torch.ops.cuda import wide as twide
from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs as TRes
from ilgpu_raytracing_tpu_torch.runtime import renderer as trenderer
from ilgpu_raytracing_tpu_torch.runtime.framestate import FrameState as TState
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


_STREAM_TABLES = ("wide_frame", "wide_qbounds", "wide_child", "wide_perm",
                  "tri_rows", "sph_rows", "tri_v0e", "inst_w2o", "sortkey_bounds")


def _need_native():
    if not tnative.available():
        pytest.skip("no C++ compiler: the SAH build is native-only")


def _build_terrain(pkg, leaf=64):
    if pkg == "jax":
        return jterrain.build_terrain_scene(grid_x=64, grid_z=32, blas_leaf_size=leaf)[1]
    return tterrain.build_terrain_scene(grid_x=64, grid_z=32, device="cpu")[1]


def _build_cornell(pkg, leaf=64):
    kw = dict(tess=6, sphere_tess=(10, 14), blas_leaf_size=leaf, bvh_method="sah")
    if pkg == "jax":
        return jcornell_mod.build_cornell_scene(**kw)[1]
    return tcornell_mod.build_cornell_scene(**kw, device="cpu")[1]


SCENES = {
    "terrain": (_build_terrain, jterrain.terrain_camera),
    "cornell": (_build_cornell, jcornell_mod.cornell_camera),
}


@functools.lru_cache(maxsize=None)
def _scenes(name):
    """(JAX scene, port scene, JAX StreamScene, port StreamScene), both
    scenes built by their own package."""
    _need_native()
    build = SCENES[name][0]
    js, ts = build("jax"), build("torch")
    return js, ts, jsk.prepare_stream(js), tstream.prepare_stream(ts)


@functools.lru_cache(maxsize=None)
def _oracle(name):
    """The JAX scene of the same triangles with leaf-4 BVH (the oracle)."""
    _need_native()
    return SCENES[name][0]("jax", leaf=4)


def _same(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (
        f"{what}: {a.shape} {a.dtype} vs {b.shape} {b.dtype}")
    np.testing.assert_array_equal(a, b, err_msg=what)


def test_terrain_tables_equal():
    """(1) The port's terrain builds the JAX package's scene bit for bit,
    and its camera is the same."""
    js, ts, _, _ = _scenes("terrain")
    assert ts.n_tris == 64 * 32 * 2
    got = ts.to_numpy()
    for name in _FIELDS:  # uint32 texels are int64 in the port
        _same_scene_field(getattr(js, name), got[name], name)
    jc, tc = jterrain.terrain_camera(96, 64), tterrain.terrain_camera(96, 64)
    for f in ("origin", "lower_left", "horizontal", "vertical"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)), getattr(tc, f))
    assert inspect.signature(tterrain.build_terrain_scene).parameters[
        "device"].default == "cuda"


@pytest.mark.parametrize("name", list(SCENES))
def test_stream_prep_tables_equal(name):
    """(2) Every table of the port's prepare_stream equals JAX's, and the
    JAX tables load through stream_from_numpy into the same StreamScene."""
    _, ts, jss, tss = _scenes(name)
    for f in _STREAM_TABLES:
        _same(getattr(jss, f), getattr(tss, f).numpy(), f)
    assert jss.meta == tss.meta
    assert (jss.rows_per_leaf, jss.stack_cap, jss.needs_bary) == (
        tss.rows_per_leaf, tss.stack_cap, tss.needs_bary)
    assert not tss.needs_bary  # untextured: the decode skips barycentrics
    jt = {f: np.asarray(getattr(jss, f)) for f in _STREAM_TABLES}
    jt.update(meta=jss.meta, rows_per_leaf=jss.rows_per_leaf,
              stack_cap=jss.stack_cap, needs_bary=jss.needs_bary)
    back = tstream.stream_from_numpy(jt, ts)
    for f in _STREAM_TABLES + ("inst_i", "inst_f"):
        assert torch.equal(getattr(back, f), getattr(tss, f)), f
    assert back.thread_stack == tss.thread_stack
    assert (back.meta, back.rows_per_leaf, back.stack_cap) == (
        tss.meta, tss.rows_per_leaf, tss.stack_cap)


def test_quantize_bounds_adversarial_exact():
    """(3) _quantize_bounds on the adversarial frames of
    tests/test_stream_kernel.py:94-103 (tiny extents, huge coordinates,
    flat dims, negative ranges) equals JAX's and covers every exact box
    under the kernels' unfused dequantization."""
    rs = np.random.RandomState(11)
    n = 512
    lo = np.float32(rs.uniform(-1e6, 1e6, (n, 8, 3)))
    ext = np.float32(10.0 ** rs.uniform(-6, 5, (n, 8, 3)))
    hi = np.where(rs.rand(n, 8, 3) < 0.1, lo, lo + ext).astype(np.float32)
    wb = np.concatenate([lo, hi], axis=2)
    wc = np.where(rs.rand(n, 8) < 0.2, -1, 1).astype(np.int32)
    wc[:, 0] = 1
    jwf, jwq = jsk._quantize_bounds(wb, wc)
    wf, wq = tstream._quantize_bounds(wb, wc)
    _same(jwf, wf, "wf")
    _same(jwq, wq, "wq")
    w = wq.view(np.uint32).reshape(n, 8, 2)
    q = np.stack([w[..., 0] & 255, (w[..., 0] >> 8) & 255, (w[..., 0] >> 16) & 255,
                  w[..., 0] >> 24, w[..., 1] & 255, (w[..., 1] >> 8) & 255],
                 axis=2).astype(np.float32)
    flo, fs = wf[:, None, 0:3], wf[:, None, 3:6]
    dlo = flo + q[..., 0:3] * fs
    dhi = flo + q[..., 3:6] * fs
    occ = np.broadcast_to((wc != -1)[:, :, None], dlo.shape)
    assert (dlo[occ] <= lo[occ]).all() and (dhi[occ] >= hi[occ]).all()


@pytest.mark.parametrize("name", list(SCENES))
def test_multirow_leaves_cover_every_triangle_once(name):
    """(4) Every triangle lands in exactly one row slot of exactly one leaf
    (tests/test_stream_kernel.py:57-72), leaf encodings address rows
    inside the table, and the per-thread stack bound covers the all-hit
    DFS of every instance."""
    _, ts, _, tss = _scenes(name)
    wc = tss.wide_child.numpy().reshape(-1, 8)
    rows = tss.tri_rows.numpy()
    enc = -wc[wc <= -2].astype(np.int64) - 2
    first, n_rows = enc // tstream._ENC_BASE, enc % tstream._ENC_BASE
    assert ((1 <= n_rows) & (n_rows <= tss.rows_per_leaf)).all()
    tri_kind = {m[1] for m in tss.meta if m[0] == tscene_mod.BLAS_TRI_MESH}
    tri_leaf = np.zeros(wc.shape, bool)
    for root in tri_kind:  # the leaves reachable from triangle instances
        stack = [root]
        while stack:
            wid = stack.pop()
            tri_leaf[wid] = wc[wid] <= -2
            stack.extend(int(c) for c in wc[wid] if c >= 0)
    tenc = -wc[tri_leaf].astype(np.int64) - 2
    tf, tn = tenc // tstream._ENC_BASE, tenc % tstream._ENC_BASE
    assert (tf + tn <= rows.shape[0] - tstream.ROWS_PER_LEAF).all()
    ids = []
    for f, k in zip(tf.tolist(), tn.tolist()):
        slots = rows[f:f + k, :96].reshape(-1, 12)
        real = np.any(slots[:, 3:9] != 0.0, axis=1)
        ids.extend(slots[real, 9].astype(np.int64).tolist())
    assert sorted(ids) == list(range(ts.n_tris))
    for _kind, root, _w, _b, _i in tss.meta:
        stack, worst = [root], 1
        while stack:
            wid = stack.pop()
            stack.extend(int(c) for c in wc[wid] if c >= 0)
            worst = max(worst, len(stack))
        assert worst <= tss.thread_stack


@pytest.mark.parametrize("name", ["terrain", "cornell", "transformed"])
def test_cut_scene_treelets_exact(name):
    """(5) The (T <= 32, 6) world treelet boxes equal JAX's exactly; the
    transformed scene carries two instances with non-identity affines."""
    if name == "transformed":
        js = build_transformed_scene(jscene_mod, jcornell_mod)[1]
        ts = build_transformed_scene(tscene_mod, tcornell_mod, device="cpu")[1]
    else:
        js, ts, _, _ = _scenes(name)
    for n_target in (32, 5):
        want = jbvh.cut_scene_treelets(js, n_target)
        got = tbvh.cut_scene_treelets(ts, n_target)
        _same(want, got, f"treelets n_target={n_target}")
        assert 1 <= got.shape[0] <= n_target


def test_treelet_sort_key_exact():
    """(6) The destination-treelet (perm, pos) equals JAX
    sort._ray_perm(..., treelet_bounds=...) exactly: 8T+2 = 258 bins at
    T = 32, uncovered live rays in bin 8T, dead lanes in 8T+1."""
    _, _, jss, tss = _scenes("terrain")
    bounds = tss.sortkey_bounds
    assert bounds.shape == (32, 6)
    rng = np.random.default_rng(21)
    n = 6000
    o = rng.uniform(-30.0, 30.0, (n, 3)).astype(np.float32)
    o[:, 1] = rng.uniform(-1.0, 6.0, n)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:7] = 0.0
    d[7:20, 1] = 0.0
    act = rng.uniform(size=n) < 0.7
    jp = jsort._ray_perm(jnp.asarray(o), jnp.asarray(d), jnp.asarray(act), None,
                         treelet_bounds=jss.sortkey_bounds)
    tp = tsort._ray_perm(torch.as_tensor(o), torch.as_tensor(d),
                         torch.as_tensor(act), None, bounds)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    t_lo = tsort._slab_entry(bounds, torch.as_tensor(o), torch.as_tensor(d))
    covered = torch.isfinite(t_lo.amin(dim=1)).numpy()
    assert (act & ~covered).any() and (act & covered).any()  # both live bins used
    assert tspk.LAUNCHES["sortpos"] == 0


def _jittered_rays(cam, w, h, seed):
    """Jittered camera rays (tests/test_stream_kernel.py:20-26), numpy."""
    rng = np.random.default_rng(seed)
    u = (np.arange(w * h) % w + rng.random(w * h).astype(np.float32)) / w
    v = (np.arange(w * h) // w + rng.random(w * h).astype(np.float32)) / h
    o, d = jrays.generate_rays(cam, jnp.asarray(u, jnp.float32),
                               jnp.asarray(v, jnp.float32))
    return np.array(o), np.array(d)


@pytest.mark.parametrize("name", list(SCENES))
def test_plain_k4_k5_meet_the_stream_kernel_bar(name):
    """(7) The port's K4/K5 wrappers (plain versions on CPU tensors) against
    the JAX XLA tracer, and the K4 decode against the JAX stream epilogue
    on the same packed record."""
    _, ts, jss, tss = _scenes(name)
    js = _oracle(name)
    w, h = 64, 48
    o, d = _jittered_rays(SCENES[name][1](w, h), w, h, seed=11)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    t, pp = tstream.trace_closest_stream_packed(tss, to, td)
    hit = tstream.decode_stream_hits(tss, to, td, t, pp)
    ref = jtr.trace_closest(js, jnp.asarray(o), jnp.asarray(d))
    assert hit.hit.numpy().mean() > 0.5
    np.testing.assert_array_equal(np.asarray(ref.hit), hit.hit.numpy())
    assert (np.abs(np.asarray(ref.t) - hit.t.numpy()) > 1e-3).sum() == 0
    assert (np.asarray(ref.prim) == hit.prim.numpy()).mean() > 0.995
    both = np.asarray(ref.hit)
    np.testing.assert_array_equal(np.asarray(ref.kind)[both], hit.kind.numpy()[both])
    np.testing.assert_array_equal(np.asarray(ref.inst)[both], hit.inst.numpy()[both])
    # the packed record itself: 23-bit prim, inst*4+kind above, miss = -1
    pp_np = pp.numpy()
    assert (pp_np[~both] == -1).all()
    np.testing.assert_array_equal(pp_np[both] & ((1 << 23) - 1), hit.prim.numpy()[both])
    jh = jsk._decode_jit(jss.tri_v0e, jss.inst_w2o, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t.numpy()), jnp.asarray(pp_np), True)
    th = twide._pp_to_record(*twide._decode_pp(
        tss.tri_v0e, tss.inst_w2o, to, td, t, pp, True, tstream.SPP_PRIM_BITS))
    for f in ("t", "kind", "prim", "inst"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, f)), getattr(th, f).numpy())
    for f in ("bu", "bv"):  # XLA contracts the Moller-Trumbore products into FMAs
        np.testing.assert_allclose(np.asarray(getattr(jh, f)), getattr(th, f).numpy(),
                                   rtol=0, atol=5e-5)

    # K5: sun shadow rays from the hit points (the port's shading of its
    # record; both tracers then get the same numpy rays)
    sun = np.asarray([0.35, 0.8, 0.49], np.float32)
    sun /= np.linalg.norm(sun)
    surf = ttr.shade_hits(ts, hit, to, td)
    so = (surf.pos + surf.normal * 1e-3).numpy()
    sd = np.broadcast_to(sun, so.shape).copy()
    occ_ref = np.asarray(jtr.shadow_occlusion(
        js, jnp.asarray(so), jnp.asarray(sd), 1e29, active=ref.hit))
    occ = tstream.shadow_occlusion_stream(
        tss, torch.as_tensor(so), torch.as_tensor(sd), 1e29,
        active=torch.as_tensor(both.copy())).numpy()
    assert ((occ != occ_ref) & both).sum() == 0
    assert not occ[~both].any()
    assert occ[both].any() and not occ[both].all()
    assert tstream.LAUNCHES == {"stream_closest": 0, "stream_shadow": 0}


def test_stream_frame_golden_bar():
    """(8) Two 32x32 frames (spp=2, max_depth=3, parity knobs, noise key
    1234) of the small terrain through the port's integrator with a
    StreamScene (treelet sort key on) against the JAX integrator on its
    XLA tracer: the golden bar of tests/test_golden.py:50-55 on colour and
    effective rays within 1%."""
    _, ts, _, tss = _scenes("terrain")
    js = _oracle("terrain")
    w = h = 32
    jcfg = JConfig(spp=2, max_depth=3, **PARITY_KNOBS)
    tcfg = RenderConfig(spp=2, max_depth=3, **PARITY_KNOBS)
    assert tcfg.sort_bounce_rays and tcfg.sort_stream_treelet_key
    jcam = jterrain.terrain_camera(w, h)
    tcam = tterrain.terrain_camera(w, h)
    sun = jsky.sun_direction(jcfg.sun_azimuth, jcfg.sun_elevation)
    n = w * h
    ja, jb, ta, tb = JRes.empty(n), JRes.empty(n), TRes.empty(n, "cpu"), TRes.empty(n, "cpu")
    calls = []
    real_perm = tsort._ray_perm

    def spy(o, d, active, morton_bounds, treelet_bounds=None):
        calls.append(treelet_bounds is not None)
        return real_perm(o, d, active, morton_bounds, treelet_bounds)

    tsort._ray_perm = spy
    try:
        # static camera: both frames share one G-buffer
        jgb = jint.primary_visibility(js, jcam, w, h)
        tgb = tint.primary_visibility(ts, tcam, w, h, 0, tss)
        for f in range(2):
            jp, jc = (ja, jb) if f % 2 == 0 else (jb, ja)
            tp, tc = (ta, tb) if f % 2 == 0 else (tb, ta)
            jcol, _, _, jc, jeff = jint.path_trace(
                js, jgb, jcam, jcam, jp, jc, f, np.uint32(1234), sun, jcfg, w, h)
            tcol, _, _, tc, teff = tint.path_trace(
                ts, tgb, tcam, tcam, tp, tc, f, 1234, sun, tcfg, w, h, tss)
            if f % 2 == 0:
                jb, tb = jc, tc
            else:
                ja, ta = jc, tc
            tcol = tcol.numpy()
            assert np.isfinite(tcol).all()
            diff = np.abs(tcol - np.asarray(jcol))
            assert diff.mean() < 0.02, f"frame {f}: mean drift {diff.mean():.4f}"
            assert (diff.max(axis=-1) > 0.1).mean() < 0.01, f"frame {f}"
            assert abs(float(jeff) - float(teff)) <= 0.01 * float(jeff)
            assert tcol.std() > 0.0
    finally:
        tsort._ray_perm = real_perm
    # every sorted trace of the frames took the treelet key
    assert calls and all(calls)


def test_renderer_routes_scenes_by_triangle_count(monkeypatch):
    """(9) Up to wide.MAX_TRIS triangles a WideScene, up to stream.MAX_TRIS
    a StreamScene, above that the plain walk on the CPU (and a refusal on
    the card). The caps are lowered so that 4,096 triangles cross them."""
    _, ts, _, _ = _scenes("terrain")
    cam = tterrain.terrain_camera(24, 16)
    cfg = RenderConfig(spp=1, max_depth=2, render_scale=1.0)
    assert twide.supports_scene(ts)
    monkeypatch.setattr(twide, "MAX_TRIS", ts.n_tris - 1)
    assert not twide.supports_scene(ts)
    r = trenderer.Renderer(24, 16, cfg, ts, cam, device="cpu")
    assert isinstance(r.wscene, tstream.StreamScene)
    img = r.render()
    assert img.shape == (24 * 16,) and len(np.unique(img.numpy())) > 1
    monkeypatch.setattr(tstream, "MAX_TRIS", ts.n_tris - 1)
    assert not tstream.supports_scene(ts)
    assert tstream.supports_scene(ts, max_tris=ts.n_tris)
    r = trenderer.Renderer(24, 16, cfg, ts, cam, device="cpu")
    assert r.wscene is None
    r.render()


def test_renderer_targets_the_card_by_default():
    """Renderer and the public constructors default to the card; without
    one, Renderer() refuses instead of rendering on the CPU."""
    for fn in (trenderer.Renderer.__init__, tscene_mod.scene_from_numpy,
               tscene_mod.SceneBuilder.commit, tscene_mod.build_default_scene,
               tcornell_mod.build_cornell_scene, tterrain.build_terrain_scene,
               TRes.empty, TState.create, TState.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        assert trenderer.Renderer(64, 64).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trenderer.Renderer(64, 64)
