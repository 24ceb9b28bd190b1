"""Treelet rounds on the streaming tables (ops/treelet.py +
ops/cuda/streamtreelet.py, K8) vs the JAX reference on the CPU.

Scene: the small terrain (grid 64 x 32 = 4,096 triangles + 2 spheres, SAH,
leaf 64), the BASELINE config 5 class at test size. `prepare_treelets_stream`
must build the JAX `StreamTreeletScene`'s tables exactly (the shared cut on
the dequantized boxes, only the wrapper nodes quantized). K8 runs its plain
version here. Against JAX's `trace_closest_treelet_stream_packed` in Pallas
interpret mode on the terrain's primary rays (64 x 48 lanes, packets of 128
lanes): pp and the round count equal, t to rtol 1e-5 (XLA's CPU backend
contracts the Moller-Trumbore products into fused multiply-adds, ROADMAP
Queue 3); and t / pp equal the flat streaming walk (K4's wrapper) bit for
bit, as tests/test_streamtreelet.py holds the JAX rounds to the JAX flat
kernel. The CUDA kernel runs only on the card (chip_smoke.py); its host
build is checked in tests/test_torch_host_kernels.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene import build_transformed_scene

from ilgpu_raytracing_tpu.models import terrain as jterrain
from ilgpu_raytracing_tpu.ops import treelet as jtreelet
from ilgpu_raytracing_tpu.ops.pallas import stream_kernel as jsk
from ilgpu_raytracing_tpu.ops.pallas import streamtreelet_kernel as jtlsk
from ilgpu_raytracing_tpu_torch.models import cornell as tcornell
from ilgpu_raytracing_tpu_torch.models import scene as tscene
from ilgpu_raytracing_tpu_torch.models import terrain as tterrain
from ilgpu_raytracing_tpu_torch.ops import rays as trays
from ilgpu_raytracing_tpu_torch.ops import treelet as ttreelet
from ilgpu_raytracing_tpu_torch.ops.cuda import stream as tstream
from ilgpu_raytracing_tpu_torch.ops.cuda import streamtreelet as tstl
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)

W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


@functools.lru_cache(maxsize=None)
def _scenes(n_target):
    """(JAX StreamTreeletScene, port StreamScene, port StreamTreeletScene)."""
    js = jterrain.build_terrain_scene(grid_x=64, grid_z=32, blas_leaf_size=64)[1]
    ts = tterrain.build_terrain_scene(grid_x=64, grid_z=32, device="cpu")[1]
    tss = tstream.prepare_stream(ts)
    return (jtlsk.prepare_treelets_stream(jsk.prepare_stream(js), n_target), tss,
            tstl.prepare_treelets_stream(tss, n_target))


@functools.lru_cache(maxsize=None)
def _rays():
    o, d = trays.generate_primary_rays(tterrain.terrain_camera(W, H), W, H, "cpu")
    return o.contiguous(), d.contiguous()


_TABLES = ("t_root", "t_inst", "t_bounds")
_NODES = ("wide_frame", "wide_qbounds", "wide_child", "wide_perm")


@pytest.mark.parametrize("n_target", [8, 32])
def test_prepare_treelets_stream_tables_equal(n_target):
    """The cut, the extended (partly re-quantized) node tables and the
    treelet tables equal JAX's and load back through
    stream_treelet_from_numpy; the original nodes keep their tables; every
    treelet root is walkable within the per-thread stack bound."""
    jst, tss, tst = _scenes(n_target)
    for f in _TABLES:
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)), getattr(tst, f).numpy(), f)
    for f in _NODES:
        np.testing.assert_array_equal(np.asarray(getattr(jst.sscene, f)),
                                      getattr(tst.sscene, f).numpy(), f)
        n_orig = getattr(tss, f).numel()
        assert torch.equal(getattr(tst.sscene, f)[:n_orig], getattr(tss, f)), f
    assert (jst.inst_spans, jst.n_treelets, jst.any_spheres, jst.sscene.stack_cap) == (
        tst.inst_spans, tst.n_treelets, tst.any_spheres, tst.sscene.stack_cap)
    assert tst.any_spheres and 2 <= tst.n_treelets <= n_target
    jt = {f: np.asarray(getattr(jst, f)) for f in _TABLES}
    jt.update({f: np.asarray(getattr(jst.sscene, f)) for f in _NODES})
    jt.update(stack_cap=jst.sscene.stack_cap, inst_spans=jst.inst_spans,
              n_treelets=jst.n_treelets, any_spheres=jst.any_spheres)
    back = tstl.stream_treelet_from_numpy(jt, tss)
    for f in _TABLES:
        assert torch.equal(getattr(back, f), getattr(tst, f)), f
    assert back.sscene.thread_stack == tst.sscene.thread_stack >= tss.thread_stack
    wc = tst.sscene.wide_child.numpy().reshape(-1, 8)
    for root in tst.t_root.tolist()[: tst.n_treelets]:
        stack, worst = [root], 1
        while stack:
            wid = stack.pop()
            stack.extend(int(c) for c in wc[wid] if c >= 0)
            worst = max(worst, len(stack))
        assert worst <= tst.sscene.thread_stack


def test_stream_rounds_match_jax_and_the_flat_walk():
    """Rounds in packets of 128 lanes on the terrain's primary rays."""
    jst, tss, tst = _scenes(8)
    o, d = _rays()
    jt, jpp, jit_rounds = jtreelet.trace_closest_treelet_stream_packed(
        jst, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), interpret=True, tile_rows=1,
        with_rounds=True)
    t, pp, rounds = ttreelet.trace_closest_treelet_stream_packed(
        tst, o, d, tile_rows=1, with_rounds=True)
    assert rounds == int(jit_rounds) >= 2
    np.testing.assert_array_equal(np.asarray(jpp), pp.numpy())
    np.testing.assert_allclose(np.asarray(jt), t.numpy(), rtol=1e-5)
    ft, fpp = tstream.trace_closest_stream_packed(tss, o, d)
    assert torch.equal(t, ft) and torch.equal(pp, fpp)
    assert (pp >= 0).float().mean() > 0.5 and (((pp >> 23) & 3) == 1).any()  # spheres
    assert tstl.LAUNCHES == {"streamtreelet": 0}


@pytest.mark.parametrize("variant", ["default_packet", "cleanup", "t_max"])
def test_stream_rounds_variants_equal_the_flat_walk(variant):
    """The JAX default packet (16 rows), cleanup_after=1 (one K4 dispatch
    for the pending tail), and a per-lane t_max of 40 with a third of the
    lanes inactive; the HitRecord entry decodes as K4's."""
    _, tss, tst = _scenes(32)
    o, d = _rays()
    n = o.shape[0]
    kw, flat_kw = {}, {}
    if variant == "cleanup":
        kw = dict(cleanup_after=1, tile_rows=1)
    elif variant == "t_max":
        act = torch.arange(n) % 3 != 0
        kw = flat_kw = dict(t_max=40.0, active=act)
    t, pp = ttreelet.trace_closest_treelet_stream_packed(tst, o, d, **kw)
    ft, fpp = tstream.trace_closest_stream_packed(tss, o, d, **flat_kw)
    assert torch.equal(t, ft) and torch.equal(pp, fpp)
    if variant == "t_max":
        assert (pp[~flat_kw["active"]] == -1).all() and (t <= 40.0).all()
    if variant == "default_packet":
        hit = ttreelet.trace_closest_treelet_stream(tst, o, d)
        want = tstream.decode_stream_hits(tss, o, d, ft, fpp)
        for f in ("t", "kind", "prim", "inst", "bu", "bv"):
            assert torch.equal(getattr(hit, f), getattr(want, f)), f


def test_stream_treelets_refuse_transforms():
    """As on the TPU, stream treelet rounds take identity transforms only."""
    ts = build_transformed_scene(tscene, tcornell, device="cpu")[1]
    with pytest.raises(ValueError, match="identity instance transforms"):
        tstl.prepare_treelets_stream(tstream.prepare_stream(ts), 8)
