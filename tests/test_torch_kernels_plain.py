"""The plain versions of the port's kernels vs the JAX reference on the CPU.

K1/K2 (ops/cuda/wide.py on CPU tensors) against the JAX wide kernel in
Pallas interpret mode and against the JAX XLA tracer, held to the bar of
tests/test_wide_kernel.py:45-58 (relative t mismatch above 1e-3 on < 0.5%
of rays, > 99.5% shadow agreement). K3 (ops/cuda/sortpos.py on CPU
tensors) against the JAX Pallas counting kernel and ops/sort.py, exactly.
The CUDA kernels themselves run only on the card (chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene import build_transformed_scene

from ilgpu_raytracing_tpu.models import cornell as jcornell_mod
from ilgpu_raytracing_tpu.models import scene as jscene_mod
from ilgpu_raytracing_tpu.models.camera import Camera as JCamera
from ilgpu_raytracing_tpu.models.cornell import build_cornell_scene as jcornell
from ilgpu_raytracing_tpu.models.cornell import cornell_camera as jcam
from ilgpu_raytracing_tpu.models.scene import build_default_scene as jdefault
from ilgpu_raytracing_tpu.ops import rays as jrays
from ilgpu_raytracing_tpu.ops import sort as jsort
from ilgpu_raytracing_tpu.ops import traverse as jtr
from ilgpu_raytracing_tpu.ops.pallas import sortpos_kernel as jspk
from ilgpu_raytracing_tpu.ops.pallas import traverse_kernel as jtk
from ilgpu_raytracing_tpu.ops.pallas import wide_kernel as jwk
from ilgpu_raytracing_tpu_torch.models.scene import _FIELDS, scene_from_numpy
from ilgpu_raytracing_tpu_torch.ops import sort as tsort
from ilgpu_raytracing_tpu_torch.ops.cuda import sortpos as tspk
from ilgpu_raytracing_tpu_torch.ops.cuda import wide as twide
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


W, H = 64, 48

SCENES = {
    "cornell": (lambda: jcornell(tess=4, sphere_tess=(8, 12))[1], lambda: jcam(W, H)),
    "default_multi": (lambda: jdefault(single_instance=False)[1],
                      lambda: JCamera.create(W, H)),
    # rotated + scaled sphere set and a translated mesh: the w2o path
    "transformed": (lambda: build_transformed_scene(jscene_mod, jcornell_mod)[1],
                    lambda: JCamera.look_at((0.5, 1.0, 4.0), (0, 0, 0), (0, 1, 0),
                                            50.0, W / H)),
}


def _port_scene(js):
    tables = {k: np.asarray(getattr(js, k)) for k in _FIELDS}
    tables.update(has_alpha=js.has_alpha, blas_leaf_max=js.blas_leaf_max,
                  tlas_leaf_max=js.tlas_leaf_max)
    return scene_from_numpy(tables, "cpu")


def _setup(name, incoherent=False):
    js = SCENES[name][0]()
    jws = jwk.prepare_wide(jtk.prepare(js))
    ts = _port_scene(js)
    tws = twide.prepare_scene(ts)
    o, d = jrays.generate_primary_rays(SCENES[name][1](), W, H)
    o, d = np.array(o), np.array(d)
    if incoherent:
        rng = np.random.default_rng(5)
        o = rng.uniform(-0.8, 0.8, o.shape).astype(np.float32)
        d = rng.normal(size=d.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return js, jws, ts, tws, o, d


def _t_mismatch(t_ref, t_got):
    return (np.abs(t_ref - t_got) > 1e-3 * np.minimum(np.abs(t_ref), 1e6)).mean()


@pytest.mark.parametrize("name", list(SCENES))
@pytest.mark.parametrize("incoherent", [False, True])
def test_plain_k1_k2_meet_the_wide_kernel_bar(name, incoherent):
    js, jws, ts, tws, o, d = _setup(name, incoherent)
    # the interpreted 6-instance kernel costs ~45 s to compile on this CPU,
    # so the multi-instance scene is held to the XLA tracer only
    interp = name == "cornell"
    h_xla = jtr.trace_closest(js, jnp.asarray(o), jnp.asarray(d))
    refs = [h_xla]
    if interp:
        refs.append(jwk.trace_closest_wide(jws, jnp.asarray(o), jnp.asarray(d),
                                           interpret=True))
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    t, pp = twide.trace_closest_wide_packed(tws, to, td)
    h = twide.decode_wide_hits(tws, to, td, t, pp)
    assert h.hit.numpy().mean() > 0.1
    for ref in refs:
        assert _t_mismatch(np.asarray(ref.t), h.t.numpy()) < 0.005
        assert (np.asarray(ref.hit) == h.hit.numpy()).mean() > 0.995
    same = np.asarray(h_xla.hit) & h.hit.numpy()
    assert (np.asarray(h_xla.inst)[same] == h.inst.numpy()[same]).mean() > 0.995
    assert (np.asarray(h_xla.kind)[same] == h.kind.numpy()[same]).all()
    for t_max in (5.0, 1e29):
        occ = twide.shadow_occlusion_wide(tws, to, td, t_max).numpy()
        occ_x = np.asarray(jtr.shadow_occlusion(js, jnp.asarray(o), jnp.asarray(d), t_max))
        assert (occ_x == occ).mean() > 0.995
        if interp:
            occ_k = np.asarray(jwk.shadow_occlusion_wide(
                jws, jnp.asarray(o), jnp.asarray(d), t_max, interpret=True))
            assert (occ_k == occ).mean() > 0.995


def test_plain_k1_active_and_t_max_contract():
    """Inactive lanes (t_max 0) miss; a finite t_max turns farther hits into
    misses and leaves nearer ones; misses carry min(T_INF, t_max)."""
    _, _, _, tws, o, d = _setup("cornell")
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    t_all, pp_all = twide.trace_closest_wide_packed(tws, to, td)
    hit = pp_all >= 0
    active = torch.arange(o.shape[0]) % 3 != 0
    t, pp = twide.trace_closest_wide_packed(tws, to, td, active=active)
    assert (pp[~active] == -1).all() and (t[~active] == 0.0).all()
    assert torch.equal(pp[active], pp_all[active])
    lim = float(torch.median(t_all[hit]))
    t2, pp2 = twide.trace_closest_wide_packed(tws, to, td, t_max=lim)
    near = hit & (t_all < lim)
    assert torch.equal(pp2[near], pp_all[near])
    assert (pp2[hit & (t_all >= lim)] == -1).all()
    assert (t2[pp2 < 0] == lim).all()
    occ = twide.shadow_occlusion_wide(tws, to, td, lim)
    assert torch.equal(occ, near)
    assert twide.LAUNCHES == {"wide_closest": 0, "wide_shadow": 0}


def test_decode_matches_reference_epilogue():
    """decode_wide_hits == the JAX decode on the same packed record, with
    barycentrics forced on."""
    js, jws, ts, tws, o, d = _setup("cornell")
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    t, pp = twide.trace_closest_wide_packed(tws, to, td)
    jh = jwk._decode_jit(jws.tri_v0e, jws.inst_w2o, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t.numpy()), jnp.asarray(pp.numpy()), True)
    th = twide._pp_to_record(*twide._decode_pp(
        tws.tri_v0e, tws.inst_w2o, to, td, t, pp, True))
    for f in ("t", "kind", "prim", "inst"):
        np.testing.assert_array_equal(np.asarray(getattr(jh, f)), getattr(th, f).numpy())
    for f in ("bu", "bv"):
        np.testing.assert_allclose(np.asarray(getattr(jh, f)), getattr(th, f).numpy(),
                                   rtol=0, atol=1e-5)
    # needs_bary=False on this scene: the wrapper's decode returns zero bary
    h = twide.decode_wide_hits(tws, to, td, t, pp)
    assert not tws.needs_bary and (h.bu == 0).all() and (h.bv == 0).all()


def test_wrappers_refuse_bad_inputs():
    _, _, _, tws, o, d = _setup("cornell")
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    with pytest.raises(ValueError):
        twide.trace_closest_wide_packed(tws, to.double(), td)
    with pytest.raises(ValueError):
        twide.shadow_occlusion_wide(tws, to[:, :2], td, 1.0)
    with pytest.raises(ValueError):
        twide.trace_closest_wide_packed(tws, to.t().contiguous().t(), td)
    with pytest.raises(ValueError):
        tspk.counting_pos(torch.zeros(10, dtype=torch.int64), 16)
    with pytest.raises(ValueError):
        tspk.counting_pos(torch.full((10,), 16, dtype=torch.int32), 16)
    with pytest.raises(ValueError):
        tspk.counting_pos(torch.zeros(10, dtype=torch.int32), tspk.MAX_BINS + 1)


@pytest.mark.parametrize("bins", [16, 129])
@pytest.mark.parametrize("n", [1024, 5000, 7777])
def test_plain_k3_exact(bins, n):
    rng = np.random.default_rng(n * bins)
    key = rng.integers(0, bins, size=n).astype(np.int32)
    key[-n // 4:] = bins - 1  # dead-lane tail
    ref = np.asarray(jspk.counting_pos(jnp.asarray(key), bins, interpret=True))
    got = tspk.counting_pos(torch.as_tensor(key), bins)
    np.testing.assert_array_equal(ref, got.numpy())
    jperm, jpos = jsort._perm_from_key(jnp.asarray(key), bins)
    tperm, tpos = tsort._perm_from_key(torch.as_tensor(key), bins)
    np.testing.assert_array_equal(np.asarray(jpos), tpos.numpy())
    np.testing.assert_array_equal(np.asarray(jperm), tperm.numpy())
    assert tspk.LAUNCHES["sortpos"] == 0


def test_ray_sort_keys_exact():
    rng = np.random.default_rng(9)
    n = 6000
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:5] = 0.0
    act = rng.uniform(size=n) < 0.7
    bmin = np.array([-1, -1, -1], np.float32)
    inv_ext = np.float32(1.0) / np.array([2, 2, 2], np.float32)
    jp = jsort._ray_perm(jnp.asarray(o), jnp.asarray(d), jnp.asarray(act),
                         (jnp.asarray(bmin), jnp.asarray(inv_ext)))
    tp = tsort._ray_perm(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(act),
                         (torch.as_tensor(bmin), torch.as_tensor(inv_ext)))
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jp = jsort._ray_perm(jnp.asarray(o), jnp.asarray(d), jnp.asarray(act), None)
    tp = tsort._ray_perm(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(act), None)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
