"""Treelet rounds on the wide BVH (ops/treelet.py + ops/cuda/treelet.py, K7)
vs the JAX reference on the CPU.

`prepare_treelets` must build the JAX `TreeletScene`'s tables exactly. K7
runs its plain version here (CPU tensors). Against JAX's ops/treelet
functions in Pallas interpret mode, on bounce-like rays of the Cornell box
(64 x 48 lanes, packets of 128 or 256 lanes so that there are many): the
packed prim record pp and the round count are equal, and t equal to rtol
1e-5 -- XLA's CPU backend contracts the Moller-Trumbore products into
fused multiply-adds (ROADMAP Queue 3), which moves t by a few ulps, and the
port does not. The port's own contract is exact: t and pp equal the flat
closest walk in the kernels' arithmetic (K6's plain version, packed as K1
packs it) bit for bit, as tests/test_treelet.py holds the JAX treelet path
to the JAX wide kernel. The CUDA kernel runs only on the
card (chip_smoke.py); its host build is checked in
tests/test_torch_host_kernels.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene import build_transformed_scene

from ilgpu_raytracing_tpu.models import cornell as jcornell
from ilgpu_raytracing_tpu.models import scene as jscene
from ilgpu_raytracing_tpu.ops import treelet as jtreelet
from ilgpu_raytracing_tpu.ops.pallas import traverse_kernel as jtk
from ilgpu_raytracing_tpu.ops.pallas import treelet_kernel as jtlk
from ilgpu_raytracing_tpu.ops.pallas import wide_kernel as jwk
from ilgpu_raytracing_tpu_torch.models import cornell as tcornell
from ilgpu_raytracing_tpu_torch.models import scene as tscene
from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.ops import rays as trays
from ilgpu_raytracing_tpu_torch.ops import traverse as ttr
from ilgpu_raytracing_tpu_torch.ops import treelet as ttreelet
from ilgpu_raytracing_tpu_torch.ops.cuda import binary as tbin
from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos as tspk
from ilgpu_raytracing_tpu_torch.ops.cuda import treelet as ttl
from ilgpu_raytracing_tpu_torch.ops.cuda import wide as twide
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)

W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


def _cornell(pkg, tess=4):
    kw = dict(tess=tess, sphere_tess=(8, 12), blas_leaf_size=8, bvh_method="sah")
    if pkg == "jax":
        return jcornell.build_cornell_scene(**kw)[1]
    return tcornell.build_cornell_scene(**kw, device="cpu")[1]


def _default(pkg):
    if pkg == "jax":
        return jscene.build_default_scene(single_instance=False)[1]
    return tscene.build_default_scene(single_instance=False, device="cpu")[1]


def _transformed(pkg):
    if pkg == "jax":
        return build_transformed_scene(jscene, jcornell)[1]
    return build_transformed_scene(tscene, tcornell, device="cpu")[1]


SCENES = {"cornell": (_cornell, 8), "cornell_tess8": (lambda p: _cornell(p, 8), 24),
          "default_multi": (_default, 16), "transformed": (_transformed, 4)}


@functools.lru_cache(maxsize=None)
def _scenes(name):
    """(JAX TreeletScene, port scene, port WideScene, port TreeletScene)."""
    build, n_target = SCENES[name]
    js, ts = build("jax"), build("torch")
    jts = jtlk.prepare_treelets(jwk.prepare_wide(jtk.prepare(js)), n_target)
    tw = twide.prepare_scene(ts)
    return jts, ts, tw, ttl.prepare_treelets(tw, n_target)


@functools.lru_cache(maxsize=None)
def _bounce_rays(name, seed=11):
    """Bounce-like lanes as numpy (tests/test_treelet.py:26-39): origins on
    the primary hits of the port's tracer, random unit directions from a
    numpy seed, dead lanes where the primary missed."""
    _, ts, _, _ = _scenes(name)
    cam = tcornell.cornell_camera(W, H) if name.startswith("cornell") else Camera.create(W, H)
    o, d = trays.generate_primary_rays(cam, W, H, "cpu")
    hit = ttr.trace_closest(ts, o.contiguous(), d)
    surf = ttr.shade_hits(ts, hit, o, d)
    nd = np.random.RandomState(seed).normal(size=(W * H, 3)).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=-1, keepdims=True)
    return (np.ascontiguousarray((surf.pos + surf.normal * 1e-3).numpy()), nd,
            hit.hit.numpy().copy())


def _t(x):
    return torch.as_tensor(x)


_TABLES = ("t_root", "t_inst", "t_w2o", "t_bounds", "t_inst_idx")


@pytest.mark.parametrize("name", list(SCENES))
def test_prepare_treelets_tables_equal(name):
    """The cut, the extended wide tables and the treelet tables equal JAX's;
    the JAX tables load through treelet_from_numpy into the same scene; the
    per-thread stack bound covers an all-hit walk from every treelet root."""
    jts, _, tw, tts = _scenes(name)
    for f in _TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(jts, f)), getattr(tts, f).numpy(), f)
    for f in ("wide_child", "wide_bounds", "wide_perm"):
        np.testing.assert_array_equal(np.asarray(getattr(jts.wscene, f)),
                                      getattr(tts.wscene, f).numpy(), f)
    assert (jts.inst_spans, jts.n_treelets, jts.all_identity, jts.wscene.stack_cap) == (
        tts.inst_spans, tts.n_treelets, tts.all_identity, tts.wscene.stack_cap)
    assert tts.all_identity == (name != "transformed")
    jt = {f: np.asarray(getattr(jts, f)) for f in _TABLES}
    jt.update({f: np.asarray(getattr(jts.wscene, f))
               for f in ("wide_child", "wide_bounds", "wide_perm")})
    jt.update(stack_cap=jts.wscene.stack_cap, inst_spans=jts.inst_spans,
              n_treelets=jts.n_treelets, all_identity=jts.all_identity)
    back = ttl.treelet_from_numpy(jt, tw)
    for f in _TABLES:
        assert torch.equal(getattr(back, f), getattr(tts, f)), f
    assert back.wscene.thread_stack == tts.wscene.thread_stack >= tw.thread_stack
    wc = tts.wscene.wide_child.numpy().reshape(-1, 8)
    for root in tts.t_root.tolist()[: tts.n_treelets]:
        stack, worst = [root], 1
        while stack:
            wid = stack.pop()
            stack.extend(int(c) for c in wc[wid] if c >= 0)
            worst = max(worst, len(stack))
        assert worst <= tts.wscene.thread_stack


def _flat(name, o, d, active, t_max=None):
    """The flat closest walk of the same scene in the kernels' arithmetic:
    K6's plain version, packed as K1/K7 pack it (t = min(t_max, 1e30) and
    pp = -1 where nothing below t_max was hit)."""
    o, d = _t(o), _t(d)
    tm = twide._lane_t_max(o, t_max, _t(active))
    t, prim, inst, _, _ = tbin.trace_binary_raw(_binary(name), o, d, tm)
    kind = _binary(name).kind_of_inst[torch.clamp(inst, min=0).long()]
    pp = prim | ((inst * 4 + kind) << twide.PP_PRIM_BITS)
    return t, torch.where(prim >= 0, pp, torch.full_like(pp, -1))


@functools.lru_cache(maxsize=None)
def _binary(name):
    return tbin.prepare_binary(_scenes(name)[1])


@functools.lru_cache(maxsize=None)
def _jax_rounds(name):
    jts, _, _, _ = _scenes(name)
    o, d, act = _bounce_rays(name)
    t, pp, it = jtreelet.trace_closest_treelet_packed(
        jts, jnp.asarray(o), jnp.asarray(d), active=jnp.asarray(act), interpret=True,
        tile_rows=1, with_rounds=True)
    return np.asarray(t), np.asarray(pp), int(it)


def _hold(label, t, pp, jt, jpp, flat):
    np.testing.assert_array_equal(jpp, pp.numpy(), err_msg=f"{label}: pp vs JAX")
    np.testing.assert_allclose(jt, t.numpy(), rtol=1e-5, err_msg=f"{label}: t vs JAX")
    assert torch.equal(t, flat[0]) and torch.equal(pp, flat[1]), f"{label}: vs flat walk"


def test_treelet_rounds_match_jax():
    """Rounds (packets of 128 lanes) on the Cornell bounce population:
    pp and the round count equal JAX's, t to rtol 1e-5, and t / pp equal
    the flat walk bit for bit; dead lanes miss; K3 sorted the lanes
    through its plain version (no launch)."""
    o, d, act = _bounce_rays("cornell")
    _, _, _, tts = _scenes("cornell")
    jt, jpp, jit_rounds = _jax_rounds("cornell")
    t, pp, rounds = ttreelet.trace_closest_treelet_packed(
        tts, _t(o), _t(d), active=_t(act), tile_rows=1, with_rounds=True)
    assert rounds == jit_rounds >= 2
    _hold("rounds", t, pp, jt, jpp, _flat("cornell", o, d, act))
    assert (pp.numpy()[~act] == -1).all() and (pp.numpy()[act] >= 0).mean() > 0.5
    assert ttl.LAUNCHES == {"treelet": 0} and tspk.LAUNCHES["sortpos"] == 0


def test_treelet_single_matches_jax():
    """The single-dispatch variant (every lane's full candidate mask,
    packets of 256 lanes) against JAX's trace_closest_treelet_single."""
    jts, _, _, tts = _scenes("cornell")
    o, d, act = _bounce_rays("cornell")
    jt, jpp = jtreelet.trace_closest_treelet_single(
        jts, jnp.asarray(o), jnp.asarray(d), active=jnp.asarray(act), interpret=True,
        tile_rows=2)
    t, pp = ttreelet.trace_closest_treelet_single(tts, _t(o), _t(d), active=_t(act),
                                                  tile_rows=2)
    _hold("single", t, pp, np.asarray(jt), np.asarray(jpp), _flat("cornell", o, d, act))


@pytest.mark.parametrize("cleanup_after", [1, 2])
def test_treelet_cleanup_matches_jax_rounds(cleanup_after):
    """`cleanup_after=k`: k rounds, then one K1 dispatch for the pending
    tail. Exact either way, so it is held to the same JAX rounds result
    (JAX's own tests hold its cleanup variant to its flat kernel bit for
    bit) and to the flat walk."""
    _, _, _, tts = _scenes("cornell")
    o, d, act = _bounce_rays("cornell")
    jt, jpp, _ = _jax_rounds("cornell")
    t, pp, rounds = ttreelet.trace_closest_treelet_packed(
        tts, _t(o), _t(d), active=_t(act), tile_rows=1, cleanup_after=cleanup_after,
        with_rounds=True)
    assert rounds == cleanup_after
    _hold(f"cleanup_after={cleanup_after}", t, pp, jt, jpp, _flat("cornell", o, d, act))


@pytest.mark.parametrize("name", ["cornell_tess8", "default_multi"])
def test_treelet_rounds_equal_the_flat_walk(name):
    """Rounds at the JAX default packet (32 rows) and at 2 rows, a per-lane
    t_max cap of 1.5, and the HitRecord entry: equal to the flat walk bit
    for bit (the default scene mixes six sphere instances)."""
    _, ts, tw, tts = _scenes(name)
    o, d, act = _bounce_rays(name)
    flat = _flat(name, o, d, act)
    for tile_rows in (ttl.TILE_ROWS, 2):
        t, pp = ttreelet.trace_closest_treelet_packed(tts, _t(o), _t(d), active=_t(act),
                                                      tile_rows=tile_rows)
        assert torch.equal(t, flat[0]) and torch.equal(pp, flat[1])
    t, pp = ttreelet.trace_closest_treelet_packed(tts, _t(o), _t(d), active=_t(act),
                                                  t_max=1.5, tile_rows=2)
    capped = _flat(name, o, d, act, t_max=1.5)
    assert torch.equal(t, capped[0]) and torch.equal(pp, capped[1]) and (t <= 1.5).all()
    hit = ttreelet.trace_closest_treelet(tts, _t(o), _t(d), active=_t(act))
    want = twide.decode_wide_hits(tw, _t(o), _t(d), *flat)
    for f in ("t", "kind", "prim", "inst", "bu", "bv"):
        assert torch.equal(getattr(hit, f), getattr(want, f)), f


def test_transformed_instances_round_trip_the_affines():
    """Non-identity instances: each treelet walks the ray through its own
    world->object affine (t_w2o), exactly as the flat walk transforms it."""
    _, ts, tw, tts = _scenes("transformed")
    cam = Camera.look_at((0.5, 1.0, 4.0), (0, 0, 0), (0, 1, 0), 50.0, W / H)
    o, d = trays.generate_primary_rays(cam, W, H, "cpu")
    o = o.contiguous()
    act = np.ones(W * H, bool)
    t, pp, rounds = ttreelet.trace_closest_treelet_packed(tts, o, d, tile_rows=1,
                                                          with_rounds=True)
    flat = _flat("transformed", o.numpy(), d.numpy(), act)
    assert torch.equal(t, flat[0]) and torch.equal(pp, flat[1]) and rounds >= 1
    assert (pp >= 0).float().mean() > 0.3 and ((pp >> 22) == 0).any()  # both instances
    assert ((pp >> 22) == 1).any()


def test_round_wrapper_contract():
    """One round: t <= t_max everywhere, pp = -1 where nothing below t_max
    was hit, lanes of packets with an empty mask untouched; the mask must be
    int32 with one entry per packet."""
    _, _, _, tts = _scenes("cornell")
    o, d, act = _bounce_rays("cornell")
    n = o.shape[0]
    tm = torch.where(_t(act), torch.tensor(1e30), torch.tensor(0.0))
    g = -(-n // 128)
    mask = torch.full((g,), (1 << tts.n_treelets) - 1, dtype=torch.int32)
    mask[::2] = 0
    t, pp = ttl.run_treelet_trace(tts, mask, _t(o), _t(d), tm, tile_rows=1)
    lane_mask = ttl.lane_masks(mask, n, 1)
    assert (t <= tm).all()
    assert (pp[lane_mask == 0] == -1).all() and torch.equal(t[lane_mask == 0], tm[lane_mask == 0])
    full = _flat("cornell", o, d, act)
    on = lane_mask != 0
    assert torch.equal(t[on], full[0][on]) and torch.equal(pp[on], full[1][on])
    with pytest.raises(ValueError, match="mask must be int32"):
        ttl.run_treelet_trace(tts, mask[:-1], _t(o), _t(d), tm, tile_rows=1)
    with pytest.raises(ValueError, match="n_target"):
        ttl.prepare_treelets(_scenes("cornell")[2], 33)
