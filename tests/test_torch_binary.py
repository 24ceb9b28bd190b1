"""The binary skip-index kernel K6 (ops/cuda/binary.py) vs the JAX reference
on the CPU.

`prepare_binary` must build the JAX `PallasScene`'s tables exactly, and
`binary_from_numpy` must load them into the same BinaryScene. K6 runs its
plain version here (CPU tensors) and is held to the bar of
tests/test_pallas_traverse.py against `traverse_kernel.trace_closest_pallas`
in interpret mode: sphere scenes hit-equal with t to rtol 1e-5 and prim /
inst / kind equal; the Cornell box near-exact (relative t mismatch above
1e-3 on < 0.5% of rays, prim agreement > 99% where t agrees), because XLA's
CPU backend contracts the Moller-Trumbore products into fused multiply-adds
(ROADMAP Queue 3) and the port does not. On triangle scenes the plain K6
equals the port's own skip-index tracer (ops/traverse.py) bit for bit. A
64x64 frame through `Renderer` with `r.wscene = prepare_binary(scene)` is
held to the JAX Renderer's XLA-traced frame at the bar of
tests/test_pallas_integration.py:28-31. The CUDA kernel runs only on the
card (chip_smoke.py); its host build is checked in
tests/test_torch_host_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene import build_transformed_scene

from ilgpu_raytracing_tpu.config import RenderConfig as JConfig
from ilgpu_raytracing_tpu.models import cornell as jcornell
from ilgpu_raytracing_tpu.models import scene as jscene
from ilgpu_raytracing_tpu.ops.pallas import traverse_kernel as jtk
from ilgpu_raytracing_tpu.runtime import renderer as jrenderer
from ilgpu_raytracing_tpu_torch.config import PARITY_KNOBS, RenderConfig
from ilgpu_raytracing_tpu_torch.models import cornell as tcornell
from ilgpu_raytracing_tpu_torch.models import scene as tscene
from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.ops import rays as trays
from ilgpu_raytracing_tpu_torch.ops import traverse as ttr
from ilgpu_raytracing_tpu_torch.ops.cuda import binary as tbin
from ilgpu_raytracing_tpu_torch.runtime import renderer as trenderer
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


CASES = {
    "cornell_sah_leaf8": lambda m, **kw: m.build_cornell_scene(
        tess=4, sphere_tess=(8, 12), blas_leaf_size=8, bvh_method="sah", **kw),
    "default_single": lambda m, **kw: m.build_default_scene(single_instance=True, **kw),
    "default_multi": lambda m, **kw: m.build_default_scene(single_instance=False, **kw),
    "transformed": None,
}


def _build(case):
    if case == "transformed":
        return (build_transformed_scene(jscene, jcornell)[1],
                build_transformed_scene(tscene, tcornell, device="cpu")[1])
    jmod = jcornell if case.startswith("cornell") else jscene
    tmod = tcornell if case.startswith("cornell") else tscene
    return CASES[case](jmod)[1], CASES[case](tmod, device="cpu")[1]


def _tables(jp):
    return dict(nodes_rows=np.asarray(jp.nodes_rows), node_ifields=np.asarray(jp.node_ifields),
                tri_rows=np.asarray(jp.tri_rows), sph_rows=np.asarray(jp.sph_rows),
                meta=jp.meta, leaf_width=jp.leaf_width, needs_bary=jp.needs_bary)


_FIELDS = ("nodes", "node_i", "tri", "sph", "inst_i", "inst_f", "kind_of_inst")


@pytest.mark.parametrize("case", list(CASES))
def test_prepare_binary_tables_equal(case):
    """The port's K6 tables equal the JAX PallasScene's, compacted: node
    boxes, node records, 8 x 12 triangle and 8 x 16 sphere slots per leaf
    row, the meta tuple and its instance tables."""
    js, ts = _build(case)
    jp = jtk.prepare(js)
    bs = tbin.prepare_binary(ts)
    back = tbin.binary_from_numpy(_tables(jp), ts)
    for f in _FIELDS:
        assert torch.equal(getattr(bs, f), getattr(back, f)), f
    assert (bs.meta, bs.leaf_width, bs.needs_bary) == (jp.meta, jp.leaf_width, jp.needs_bary)
    np.testing.assert_array_equal(np.asarray(jp.nodes_rows)[:, :6], bs.nodes.numpy())
    np.testing.assert_array_equal(np.asarray(jp.node_ifields).reshape(-1, 4),
                                  bs.node_i.numpy())
    tri = np.asarray(jp.tri_rows)
    assert not tri[:, 96:].any()  # the compaction drops only zero lanes
    np.testing.assert_array_equal(tri[:, :96].reshape(-1, 8, 12), bs.tri.numpy())
    np.testing.assert_array_equal(np.asarray(jp.sph_rows).reshape(-1, 8, 16), bs.sph.numpy())
    for k, (kind, root, w2o, wb, inst_id) in enumerate(bs.meta):
        assert tuple(bs.inst_i[k, :3].tolist()) == (kind, root, inst_id)
        np.testing.assert_array_equal(bs.inst_f[k].numpy(), np.asarray(w2o + wb, np.float32))
    assert tbin.LAUNCHES == {"binary_closest": 0, "binary_shadow": 0}


def _rays(case, w, h):
    if case.startswith("cornell"):
        cam = tcornell.cornell_camera(w, h)
    elif case == "transformed":
        cam = Camera.look_at((0.5, 1.0, 4.0), (0, 0, 0), (0, 1, 0), 50.0, w / h)
    else:
        cam = Camera.create(w, h)
    o, d = trays.generate_primary_rays(cam, w, h, "cpu")
    return o.contiguous(), d.contiguous()


@pytest.mark.parametrize("case", ["default_single", "transformed", "cornell_sah_leaf8"])
def test_k6_plain_meets_the_pallas_traverse_bar(case):
    """K6's plain version (the wrapper on CPU tensors) against the JAX K6 in
    interpret mode on the same tables and rays."""
    js, ts = _build(case)
    jp = jtk.prepare(js)
    bs = tbin.prepare_binary(ts)
    o, d = _rays(case, 48, 32)
    ref = jtk.trace_closest_pallas(jp, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
                                   interpret=True)
    hit = tbin.trace_closest_binary(bs, o, d)
    rh, th = np.asarray(ref.hit), hit.hit.numpy()
    assert th.mean() > 0.3
    rt, tt = np.asarray(ref.t), hit.t.numpy()
    if case == "cornell_sah_leaf8":
        mismatch = np.abs(rt - tt) > 1e-3 * np.minimum(np.abs(rt), 1e6)
        assert mismatch.mean() < 0.005, f"{mismatch.sum()} mismatched rays"
        agree = ~mismatch & rh
        np.testing.assert_allclose(rt[agree], tt[agree], rtol=1e-5)
        assert (np.asarray(ref.prim)[agree] == hit.prim.numpy()[agree]).mean() > 0.99
        # the port's own skip-index tracer walks the same tree with the same
        # unfused arithmetic: bit for bit
        own = ttr.trace_closest(ts, o, d)
        for f in ("t", "prim", "inst", "kind"):
            assert torch.equal(getattr(own, f), getattr(hit, f)), f
        return
    np.testing.assert_array_equal(rh, th)
    # atol: the default scene's ground sphere (radius 1000) loses ~200x in
    # the t = (-b - sqrt(disc)) / 2a cancellation, so the reference's one-ulp
    # FMA difference in b reaches a relative 1e-5 of t
    np.testing.assert_allclose(rt[rh], tt[rh], rtol=1e-5, atol=1e-4)
    for f in ("prim", "inst", "kind"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f))[rh],
                                      getattr(hit, f).numpy()[rh], err_msg=f)


@pytest.mark.parametrize("case", ["default_single", "cornell_sah_leaf8"])
def test_k6_any_hit(case):
    """The any-hit instantiation (stops at the first accepted primitive)
    gives the closest walk's `prim >= 0` under the same t_max on every
    lane, agrees with the JAX shadow_occlusion_pallas on > 99.5% of rays
    (tests/test_pallas_traverse.py:81-89), and inactive lanes never occlude."""
    js, ts = _build(case)
    bs = tbin.prepare_binary(ts)
    o, d = _rays(case, 48, 32)
    n = o.shape[0]
    act = torch.arange(n) % 3 != 0
    for t_max in (5.0, 1e29):
        occ = tbin.shadow_occlusion_binary(bs, o, d, t_max, active=act)
        closest = tbin.trace_closest_binary(bs, o, d, active=act,
                                            t_max=torch.full((n,), t_max))
        assert torch.equal(occ, closest.prim >= 0)
        assert not occ[~act].any() and occ.any()
    ref = jtk.shadow_occlusion_pallas(jtk.prepare(js), jnp.asarray(o.numpy()),
                                      jnp.asarray(d.numpy()), 5.0, interpret=True)
    occ = tbin.shadow_occlusion_binary(bs, o, d, 5.0)
    assert (np.asarray(ref) == occ.numpy()).mean() > 0.995


def test_k6_wrapper_contract():
    """Inactive lanes miss and report t = T_INF; rays must be contiguous
    float32 on the scene's device; on the CPU nothing is launched."""
    _, ts = _build("default_single")
    bs = tbin.prepare_binary(ts)
    o, d = _rays("default_single", 40, 30)  # 1200 rays
    active = torch.arange(1200) % 2 == 0
    h = tbin.trace_closest_binary(bs, o, d, active=active)
    assert not h.hit[1::2].any() and (h.t[1::2] == 1e30).all()
    full = tbin.trace_closest_binary(bs, o, d)
    assert torch.equal(h.hit[::2], full.hit[::2]) and torch.equal(h.t[::2], full.t[::2])
    with pytest.raises(ValueError, match="contiguous float32"):
        tbin.trace_closest_binary(bs, o.double(), d)
    assert tbin.LAUNCHES == {"binary_closest": 0, "binary_shadow": 0}


def test_binary_frame_vs_jax_renderer(monkeypatch):
    """A 64x64 Cornell frame (spp=1, max_depth=2, locked noise, parity
    knobs) rendered by the port's Renderer with `r.wscene =
    prepare_binary(scene)` -- every trace of the frame through K6's
    wrapper -- against the JAX Renderer's XLA-traced frame: the golden bar
    of tests/test_golden.py:50-55 that the port's other frames meet
    (tests/test_torch_frame.py). At the 2-level bar of
    tests/test_pallas_integration.py:28-31 the port's frames, binary and
    wide route alike (they are equal), differ from JAX's on 1.2% of pixels
    here: the G-buffer divergence of ROADMAP Queue 3, spread by TAAU.
    chip_smoke.py holds the 1080p binary-route frame to the K1/K2 frame at
    the 2-level bar on the card."""
    _, js = jcornell.build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8)
    _, ts = tcornell.build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                                         device="cpu")
    jcfg = JConfig(spp=1, max_depth=2, rng_lock_noise=0, use_pallas_trace=False,
                   **PARITY_KNOBS)
    jr = jrenderer.Renderer(out_w=64, out_h=64, cfg=jcfg, scene=js,
                            camera=jcornell.cornell_camera(64, 64))
    jr.render_frames(2)
    want = jr.frame_rgb().astype(np.float32) / 255.0

    calls = {"closest": 0, "shadow": 0}
    real_c, real_s = tbin.trace_closest_binary, tbin.shadow_occlusion_binary

    def spy_c(*a, **k):
        calls["closest"] += 1
        return real_c(*a, **k)

    def spy_s(*a, **k):
        calls["shadow"] += 1
        return real_s(*a, **k)

    monkeypatch.setattr(tbin, "trace_closest_binary", spy_c)
    monkeypatch.setattr(tbin, "shadow_occlusion_binary", spy_s)
    cfg = RenderConfig(spp=1, max_depth=2, rng_lock_noise=0, **PARITY_KNOBS)
    r = trenderer.Renderer(64, 64, cfg, ts, tcornell.cornell_camera(64, 64), device="cpu")
    r.wscene = tbin.prepare_binary(r.scene)
    r.render_frames(2)
    got = r.frame_rgb().astype(np.int32)
    # one primary and one bounce closest trace a frame; sun, ReSTIR and sky
    # any-hit traces
    assert calls["closest"] == 4 and calls["shadow"] >= 4
    assert isinstance(r.wscene, tbin.BinaryScene)
    diff = np.abs(got / 255.0 - want)
    assert diff.mean() < 0.02, f"mean drift {diff.mean():.4f}"
    assert (diff.max(axis=-1) > 0.1).mean() < 0.01
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 1
