"""The port's multi-device path (parallel/sharding.py, the kernel scene's
replicas, `Renderer(mesh=...)`) on a simulated CPU mesh.

torch has one CPU device, so the mesh is `make_mesh(devices=[cpu] * 8)`:
eight blocks, their launches and the gathers all on the CPU, the analog of
the JAX suite's `xla_force_host_platform_device_count=8`. It checks the
split, not scaling. Held against the JAX package without rendering a JAX
frame:

- block boundaries and contents equal JAX's `shard_pixels` shards
  (`addressable_shards`' index and data); `check_divisible` and
  `divisible_internal_resolution` equal the JAX functions over a grid;
- the mesh Renderer's frames (tests/test_sharding.py's renderer test on
  the port, Cornell tess=4, 64x32, spp=1, max_depth=2, rng_lock_noise=0,
  render_scale=1.0) bit-equal to the single-device Renderer's, also with
  `deferred_shadows` and `spp_pixel_major`, on the alpha-cutout courtyard,
  after `set_scene` and after a resize whose output blocks start mid-row,
  the Renderer holding one replica of its kernel scene on each distinct
  mesh device; a state saved from the mesh loads in the JAX npz format and renders the
  next frame bit-equal;
- the 8-block `path_trace` meets the golden bar against
  tests/goldens/cornell_64.npy, as test_torch_frame.py holds the
  single-device path;
- the binary route (K6) on a 4-block mesh: `replicate_kscene`'s replicas
  and its device-type refusal, a caller's BinaryScene under
  `Renderer(mesh=...)` replicated once and bit-equal to the single-device
  binary frame with 4x the K6 calls, and `render_frame_mesh` refusing a
  kernel scene off a block's device before any K6 call.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu.config import RenderConfig as JConfig
from ilgpu_raytracing_tpu.parallel import sharding as jshrd
from ilgpu_raytracing_tpu.runtime.framestate import FrameState as JState
from ilgpu_raytracing_tpu_torch.config import PARITY_KNOBS, RenderConfig
from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene, cornell_camera
from ilgpu_raytracing_tpu_torch.models.sponza_like import (
    build_sponza_like_scene,
    sponza_camera,
)
from ilgpu_raytracing_tpu_torch.ops import integrator, sky
from ilgpu_raytracing_tpu_torch.ops.cuda import binary, wide
from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs
from ilgpu_raytracing_tpu_torch.parallel import sharding as shrd
from ilgpu_raytracing_tpu_torch.runtime import renderer as renderer_mod
from ilgpu_raytracing_tpu_torch.runtime.framestate import FrameState
from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer, replicate_kscene

torch.set_num_threads(1)

CPU = torch.device("cpu")
_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "cornell_64.npy")


@pytest.fixture(autouse=True)
def _inference_mode():
    """Nothing here needs autograd; inference mode spares the per-op
    bookkeeping of the plain walks' many small ops."""
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def mesh():
    return shrd.make_mesh(devices=[CPU] * 8)


@pytest.fixture(scope="module")
def cornell():
    return build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                               device="cpu")[1]


# ---------------------------------------------------------------- placement


@pytest.mark.parametrize("shape", [(64,), (1000 + 24, 3)])
def test_blocks_equal_jax_shards(mesh, shape):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = shrd.shard_pixels(mesh, torch.as_tensor(x))
    want = jshrd.shard_pixels(jshrd.make_mesh(8), jnp.asarray(x))
    assert got.placement == shrd.pixel_sharding(mesh)
    shards = sorted(want.addressable_shards, key=lambda s: s.index[0].start)
    assert len(shards) == len(got.blocks) == 8
    for k, (s, bound, block) in enumerate(zip(shards, got.bounds, got.blocks)):
        assert (s.index[0].start, s.index[0].stop) == (bound.start, bound.stop)
        assert s.device == jax.devices()[k] and block.device == mesh.devices[k]
        np.testing.assert_array_equal(np.asarray(s.data), block.numpy())
    np.testing.assert_array_equal(got.gather(CPU).numpy(), x)


def test_replicate_and_shard_state(mesh):
    x = torch.arange(64.0)
    r = shrd.replicate(mesh, x)
    assert r.placement == shrd.replicated(mesh) and len(r.copies) == 8
    # a repeated device shares one copy
    assert all(c is r.copies[0] for c in r.copies)
    assert torch.equal(r.copies[0], x)

    state = FrameState.create(64, 128, "cpu")
    state.accum_count, state.taa_valid = 3, True
    sharded = shrd.shard_state(mesh, state)
    assert isinstance(sharded.res_prev, shrd.PixelShards)
    assert isinstance(sharded.res_prev.blocks[0], Reservoirs)
    assert [b.stop for b in sharded.res_cur.bounds] == list(range(8, 65, 8))
    assert [b.stop for b in sharded.taa_color.bounds] == list(range(16, 129, 16))
    assert (sharded.accum_count, sharded.taa_valid) == (3, True)
    back = sharded.res_prev.gather(CPU)
    for f in vars(back):
        assert torch.equal(getattr(back, f), getattr(state.res_prev, f))
    # the gathers count the bytes they copy; on one device nothing moves
    shrd.GATHER_BYTES.update(copied=0, moved=0)
    assert torch.equal(sharded.taa_obj.gather(CPU), state.taa_obj)
    assert shrd.GATHER_BYTES == dict(copied=128 * 4, moved=0)


def test_resolution_arithmetic_equals_jax():
    for scale in (0.67, 1.0):
        tcfg, jcfg = RenderConfig(render_scale=scale), JConfig(render_scale=scale)
        for out_w, out_h in ((64, 32), (100, 60), (1920, 1080), (1280, 720)):
            for n in (1, 2, 4, 8):
                assert shrd.divisible_internal_resolution(tcfg, out_w, out_h, n) == \
                    jshrd.divisible_internal_resolution(jcfg, out_w, out_h, n)
    for n in (1, 2, 4, 8):
        tm = shrd.make_mesh(devices=[CPU] * n)
        jm = jshrd.make_mesh(n)
        for pixels in (64, 63, 1000, 2073600, 901120):
            try:
                jshrd.check_divisible(pixels, jm)
                jax_ok = True
            except ValueError:
                jax_ok = False
            if jax_ok:
                shrd.check_divisible(pixels, tm)
            else:
                with pytest.raises(ValueError):
                    shrd.check_divisible(pixels, tm)
    shrd.check_divisible(64, shrd.make_mesh(devices=[CPU] * 8))
    with pytest.raises(ValueError):
        shrd.check_divisible(63, shrd.make_mesh(devices=[CPU] * 8))


def test_mesh_refusals(cornell):
    with pytest.raises(ValueError, match="mixed types"):
        shrd.make_mesh(devices=[CPU, torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="unsupported device"):
        shrd.make_mesh(devices=[torch.device("meta")])
    if torch.cuda.is_available():
        assert shrd.make_mesh().size == torch.cuda.device_count()
    else:
        # a CUDA mesh never falls back to the CPU
        for kw in (dict(), dict(n_devices=2), dict(devices=[torch.device("cuda", 0)] * 2)):
            with pytest.raises(RuntimeError):
                shrd.make_mesh(**kw)
    mesh = shrd.make_mesh(devices=[CPU] * 8)
    cfg = RenderConfig(spp=1, max_depth=1, render_scale=1.0)
    # the output pixel count must divide the mesh (TAA history is sharded)
    with pytest.raises(ValueError, match="must divide the mesh"):
        Renderer(63, 33, cfg, cornell, cornell_camera(63, 33), mesh=mesh, device="cpu")
    # the renderer runs on the mesh's devices, and nowhere else
    with pytest.raises(ValueError, match="not a device of the mesh"):
        Renderer(64, 32, cfg, cornell, cornell_camera(64, 32), mesh=mesh, device="cuda")
    r = Renderer(64, 32, cfg, cornell, cornell_camera(64, 32), mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="must divide the mesh"):
        r.resize(63, 33)
    with pytest.raises(ValueError):
        shrd.shard_pixels(mesh, torch.zeros(63))


def _rays(seed):
    rs = np.random.RandomState(seed)
    n = 1000
    o = torch.as_tensor(rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
    d = torch.as_tensor(rs.normal(size=(n, 3)).astype(np.float32))
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    return o, d, torch.as_tensor(rs.rand(n) < 0.8)


def _tensors(ks):
    return {k: v for k, v in vars(ks).items() if isinstance(v, torch.Tensor)}


def _assert_replicated(r, mesh):
    """The mesh Renderer holds one replica of its kernel scene on each
    distinct mesh device (block k's on mesh.devices[k]), with the kernel
    scene's tables."""
    reps = r._kscene_replicas()
    assert r._kscenes[0] is r.wscene and reps.placement == shrd.replicated(mesh)
    assert len({id(c) for c in reps.copies}) == len(mesh.distinct_devices)
    for rep, dev in zip(reps.copies, mesh.devices):
        assert type(rep) is type(r.wscene)
        assert _tensors(rep).keys() == _tensors(r.wscene).keys()
        for k, v in _tensors(r.wscene).items():
            assert getattr(rep, k).device == dev and torch.equal(getattr(rep, k), v), k


# ---------------------------------------------------------------- frames


def _pair(cfg, scene, camera, mesh, frames, out=(64, 32), **renderer_kw):
    """The single-device Renderer and the mesh Renderer, `frames` each."""
    pair = []
    for m in (None, mesh):
        r = Renderer(*out, cfg, scene, camera(*out), mesh=m, device="cpu", **renderer_kw)
        r.render_frames(frames)
        pair.append(r)
    return pair


def _assert_same_frame(single, multi):
    assert (single.in_w, single.in_h) == (multi.in_w, multi.in_h)
    assert (multi.in_w * multi.in_h) % 8 == 0
    np.testing.assert_array_equal(single.frame_rgb(), multi.frame_rgb())
    assert torch.equal(single._last_packed, multi._last_packed)
    assert torch.equal(single._last_aux["color"], multi._last_aux["color"])
    assert float(single._last_aux["eff_rays"]) == float(multi._last_aux["eff_rays"])


_BASE = dict(spp=1, max_depth=2, rng_lock_noise=0, render_scale=1.0)


def test_mesh_renderer_matches_single_device(mesh, cornell, tmp_path):
    """Frames 1 and 2 bit-equal. The mesh state is saved after frame 1,
    read by the JAX package's FrameState.load (its npz format) and loaded
    back onto the mesh, and frame 2 renders from the loaded state; the
    in-memory state carries frame 2 in the other frame tests."""
    cfg = RenderConfig(**_BASE)
    single, multi = _pair(cfg, cornell, cornell_camera, mesh, 1)
    assert isinstance(multi.wscene, wide.WideScene)
    _assert_replicated(multi, mesh)
    assert isinstance(multi.state.taa_color, shrd.PixelShards)
    _assert_same_frame(single, multi)

    path = str(tmp_path / "mesh_state.npz")
    multi.state.save(path)
    jstate = JState.load(path)
    np.testing.assert_array_equal(np.asarray(jstate.taa_color),
                                  single.state.taa_color.numpy().astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(jstate.res_cur.m), single.state.res_cur.m.numpy())
    multi.state = FrameState.load(path, mesh=mesh)
    assert isinstance(multi.state.res_cur, shrd.PixelShards)
    single.render()
    multi.render()
    _assert_same_frame(single, multi)
    assert len(np.unique(multi._last_packed.numpy())) > 50


def test_mesh_renderer_deferred_shadows_pixel_major(mesh, cornell):
    """Both integrator settings per block: one queued any-hit dispatch a
    block (max_depth 1: the ReSTIR and the sky segments) over 2 samples a
    pixel on adjacent lanes."""
    cfg = RenderConfig(deferred_shadows=True, spp_pixel_major=True,
                       **{**_BASE, "max_depth": 1, "spp": 2})
    single, multi = _pair(cfg, cornell, cornell_camera, mesh, 1)
    _assert_same_frame(single, multi)


def test_mesh_renderer_alpha_scene(mesh, tmp_path):
    _, scene = build_sponza_like_scene(str(tmp_path), device="cpu")
    assert scene.has_alpha
    single, multi = _pair(RenderConfig(**_BASE), scene, sponza_camera, mesh, 2)
    _assert_same_frame(single, multi)


def test_mesh_renderer_set_scene_and_resize(mesh, cornell):
    """`set_scene` (the refit path) keeps the mesh: the new tables are
    replicated onto it. After a resize to 64x36 at render scale 0.67
    (internal 43x24: the mesh divides both pixel counts) each output block
    of 288 pixels starts mid-row, so TAAU resolves partial rows."""
    cfg = RenderConfig(**{**_BASE, "render_scale": 0.67, "max_depth": 1})
    pair = []
    for m in (None, mesh):
        r = Renderer(64, 32, cfg, cornell, cornell_camera(64, 36), mesh=m, device="cpu")
        before = r.wscene
        r.set_scene(cornell)
        assert r.wscene is not before
        if m is None:
            assert r._kscenes is None
        else:
            _assert_replicated(r, m)
        r.resize(64, 36)
        assert (r.in_w, r.in_h, r.frame) == (43, 24, 0)
        r.render()
        pair.append(r)
    assert (64 * 36 // 8) % 64 != 0
    _assert_same_frame(*pair)


def _golden_bar(got, want):
    diff = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert diff.mean() < 0.02, f"mean drift {diff.mean():.4f}"
    frac_big = (diff.max(axis=-1) > 0.1).mean()
    assert frac_big < 0.01, f"{frac_big:.3%} pixels changed materially"


def test_block_split_path_trace_golden_bar(mesh, cornell):
    """test_torch_frame.py's golden inputs (64x64, spp=2, max_depth=3, the
    parity knobs, noise key 1234, 2 frames) through `path_trace` one
    8-block split at a time, each block's reuse reading the gathered
    full-image G-buffer and res_prev, against the committed golden. The
    scene's BVH has leaves of 8 (the golden's of 4): the same surfaces,
    fewer steps of the plain walk."""
    scene, ks = cornell, wide.prepare_scene(cornell)
    w = h = 64
    cfg = RenderConfig(spp=2, max_depth=3, **PARITY_KNOBS)
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    cam = cornell_camera(w, h)
    blocks = shrd.block_slices(w * h, mesh)
    gb = shrd.PixelShards(shrd.pixel_sharding(mesh), tuple(
        integrator.primary_visibility(scene, cam, w, h, 0, ks, rows) for rows in blocks))
    res = [shrd.shard_pixels(mesh, Reservoirs.empty(w * h, "cpu")) for _ in range(2)]
    color = None
    for f in range(2):
        prev, cur = (res[0], res[1]) if f % 2 == 0 else (res[1], res[0])
        out = [integrator.path_trace(scene, gb.gather(CPU), cam, cam, prev.gather(CPU),
                                     cur.blocks[k], f, 1234, sun, cfg, w, h, ks, rows)
               for k, rows in enumerate(blocks)]
        color = torch.cat([o[0] for o in out]).numpy()
        res[1 if f % 2 == 0 else 0] = shrd.PixelShards(
            shrd.pixel_sharding(mesh), tuple(o[3] for o in out))
    assert np.isfinite(color).all()
    _golden_bar(color, np.load(_GOLDEN))


# ---------------------------------------------------------------- binary route


@pytest.fixture(scope="module")
def mesh4():
    return shrd.make_mesh(devices=[CPU] * 4)


def test_binary_with_mesh_replicates_without_a_ray_split(mesh4, cornell):
    """`replicate_kscene`: one replica of the BinaryScene's tables per
    distinct device, `bs` itself untouched; a trace on a replica is the
    trace on `bs` (no ray split anywhere); the plain tracer's None
    replicates as None; a mesh of another device type than the tables is
    refused, directly and when a mesh Renderer replicates a caller's
    kernel scene."""
    bs = binary.prepare_binary(cornell)
    tables = dict(_tensors(bs))
    reps = replicate_kscene(mesh4, bs)
    assert reps.placement == shrd.replicated(mesh4) and len(reps.copies) == 4
    # a repeated device shares one replica
    assert all(rep is reps.copies[0] for rep in reps.copies)
    rep = reps.copies[0]
    assert rep.meta == bs.meta and rep.depth == bs.depth
    assert _tensors(rep).keys() == tables.keys()
    for k, v in tables.items():
        assert torch.equal(getattr(rep, k), v) and getattr(rep, k).device == CPU, k
        assert getattr(bs, k) is v, k  # the kernel scene keeps its own tables
    o, d, active = _rays(5)
    r1 = binary.trace_closest_binary(bs, o, d, active=active)
    r2 = binary.trace_closest_binary(rep, o, d, active=active)
    assert int(r1.hit.sum()) > 100
    for f in ("t", "prim", "inst", "bu", "bv"):
        assert torch.equal(getattr(r1, f), getattr(r2, f)), f
    assert torch.equal(binary.shadow_occlusion_binary(bs, o, d, 10.0, active=active),
                       binary.shadow_occlusion_binary(rep, o, d, 10.0, active=active))
    assert replicate_kscene(mesh4, None).copies == (None,) * 4
    with pytest.raises(ValueError, match="with_mesh: a mesh of"):
        replicate_kscene(shrd.Mesh((torch.device("cuda", 0),) * 4), bs)
    r = Renderer(64, 32, RenderConfig(**_BASE), cornell, cornell_camera(64, 32),
                 mesh=mesh4, device="cpu")
    r.wscene = shrd.to_device(bs, "meta")
    with pytest.raises(ValueError, match=r"with_mesh: a mesh of \['cpu'\] devices for "
                                         r"tables on meta"):
        r.render()
    assert r.frame == 0


def _count_k6(monkeypatch):
    """Count the calls of the K6 wrappers that the frame makes."""
    calls = {"closest": 0, "shadow": 0}
    for name, key in (("trace_closest_binary", "closest"),
                      ("shadow_occlusion_binary", "shadow")):
        real = getattr(binary, name)

        def spy(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(binary, name, spy)
    return calls


def test_mesh_renderer_binary_route(mesh4, cornell, monkeypatch):
    """A caller's BinaryScene (`r.wscene = prepare_binary(r.scene)`) under
    Renderer(mesh=...): the frames equal the single-device binary frames
    bit for bit, each block calls K6 as often as the single device, and
    the BinaryScene is replicated once, not every frame."""
    calls = _count_k6(monkeypatch)
    cfg = RenderConfig(**_BASE)
    pair, per_frame = [], []
    for m in (None, mesh4):
        r = Renderer(64, 32, cfg, cornell, cornell_camera(64, 32), mesh=m, device="cpu")
        bs = binary.prepare_binary(r.scene)
        r.wscene = bs
        replicas = []
        for _ in range(2):
            calls.update(closest=0, shadow=0)
            r.render()
            per_frame.append(dict(calls))
            replicas.append(r._kscenes)
        assert r.wscene is bs
        if m is None:
            assert replicas == [None, None]
        else:
            assert replicas[0] is replicas[1] and replicas[0][0] is bs
            _assert_replicated(r, mesh4)
        pair.append(r)
    _assert_same_frame(*pair)
    single = per_frame[:2]
    assert single[0]["closest"] > 0 and single[0]["shadow"] > 0
    assert per_frame[2:] == [{k: 4 * v for k, v in f.items()} for f in single]


def test_render_frame_mesh_refuses_a_kernel_scene_off_its_block(mesh4, cornell,
                                                                monkeypatch):
    """Block 1's replica on another device than block 1 (the meta device
    stands in for a second card; a faulty replication hands the frame
    these replicas): ValueError before any block calls K6."""
    calls = _count_k6(monkeypatch)
    bs = binary.prepare_binary(cornell)
    reps = replicate_kscene(mesh4, bs)
    rep = reps.copies[0]
    off = shrd.to_device(rep, "meta")
    bad = shrd.Replicated(reps.placement, (rep, off, off, off))
    monkeypatch.setattr(renderer_mod, "replicate_kscene", lambda mesh, ks: bad)
    r = Renderer(64, 32, RenderConfig(**_BASE), cornell, cornell_camera(64, 32),
                 mesh=mesh4, device="cpu")
    r.wscene = bs
    with pytest.raises(ValueError, match="block 1's kernel scene lies on meta"):
        r.render()
    assert calls == {"closest": 0, "shadow": 0}
    assert r.frame == 0
