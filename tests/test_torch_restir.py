"""restir_direct: port vs JAX reference on the CPU, on seeded inputs.

A real 64x64 Cornell G-buffer (from the JAX package) with seeded previous
reservoirs, RNG states and lane masks goes through both implementations:
integer fields (reservoir m / light_id, RNG state, selection masks) must
be equal, floats within rtol=1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu.models.cornell import build_cornell_scene as jcornell
from ilgpu_raytracing_tpu.models.cornell import cornell_camera as jcam
from ilgpu_raytracing_tpu.ops import integrator as jint
from ilgpu_raytracing_tpu.ops import restir as jrestir
from ilgpu_raytracing_tpu.ops import sky as jsky
from ilgpu_raytracing_tpu_torch.models.cornell import cornell_camera as tcam
from ilgpu_raytracing_tpu_torch.ops import integrator as tint
from ilgpu_raytracing_tpu_torch.ops import restir as trestir
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


W = H = 64
SPP = 2


def _inputs(seed):
    rng = np.random.default_rng(seed)
    _, js = jcornell(tess=4, sphere_tess=(8, 12))
    gb = jint.primary_visibility(js, jcam(W, H), W, H)
    gbn = {k: np.array(getattr(gb, k)) for k in
           ("pos", "normal", "albedo", "shading", "ior", "obj_id", "hit")}
    n = W * H
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=1, keepdims=True)
    prev = dict(
        L=rng.uniform(0, 3, (n, 3)).astype(np.float32), wi=wi,
        pdf=rng.uniform(0.05, 1, n).astype(np.float32),
        w=rng.uniform(0.0, 1, n).astype(np.float32),
        w_sum=rng.uniform(0.0, 5, n).astype(np.float32),
        m=rng.integers(0, 20, n).astype(np.int32),
        light_id=rng.integers(1, 3, n).astype(np.int32),
        W=rng.uniform(0.0, 2, n).astype(np.float32),
    )
    lanes = {k: np.concatenate([v] * SPP) for k, v in gbn.items()}
    state = (rng.integers(1, 2**32, size=SPP * n, dtype=np.uint64)
             .astype(np.uint32) | 1)
    active = lanes["hit"] & (lanes["shading"] == 0) & (rng.uniform(size=SPP * n) < 0.9)
    en = active & (rng.uniform(size=SPP * n) < 0.8)
    return gbn, prev, lanes, state, active, en


CASES = {
    "reuse": dict(static_reuse=True, reference_weighting=False),
    "reference_weighting": dict(static_reuse=True, reference_weighting=True),
    "candidates_only": dict(static_reuse=False, reference_weighting=False),
    # lanes i*SPP + s: a pixel's samples adjacent (config.spp_pixel_major)
    "pixel_major": dict(static_reuse=True, reference_weighting=False,
                        reps_pixel_major=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_restir_direct_matches_reference(case):
    kw = CASES[case]
    gbn, prev, lanes, state, active, en = _inputs(17)
    n = W * H
    cam_j, cam_t = jcam(W, H), tcam(W, H)
    prev_j = cam_j.translate([0.01, 0.0, 0.0])
    prev_t = cam_t.translate([0.01, 0.0, 0.0])
    sun = jsky.sun_direction(0.3, 0.6)
    common = dict(width=W, height=H, frame=3, sun_dir=sun,
                  sun_radiance=(10.0, 10.0, 10.0), sky_top=(0.5, 0.7, 1.0),
                  sky_bottom=(1.0, 1.0, 1.0), local_candidates=8,
                  delta_candidates=1, reps=SPP, **kw)
    pixel_idx = np.tile(np.arange(n, dtype=np.int32), SPP)
    if kw.get("reps_pixel_major"):
        lanes = {k: np.repeat(v, SPP, axis=0) for k, v in gbn.items()}
        pixel_idx = np.repeat(np.arange(n, dtype=np.int32), SPP)

    jgb = jint.GBuffer(**{k: jnp.asarray(v) for k, v in gbn.items()})
    jst, jres, jsel = jrestir.restir_direct(
        None, jgb, jrestir.Reservoirs(**{k: jnp.asarray(v) for k, v in prev.items()}),
        jnp.asarray(state), jnp.asarray(active), jnp.asarray(lanes["pos"]),
        jnp.asarray(lanes["normal"]), jnp.asarray(lanes["albedo"]),
        jnp.asarray(pixel_idx), prev_cam=prev_j,
        cam_origin=jnp.asarray(cam_j.origin), enable_temporal=jnp.asarray(en),
        enable_spatial=jnp.asarray(en), **common,
    )
    tgb = tint.GBuffer(**{k: torch.as_tensor(v) for k, v in gbn.items()})
    tst, tres, tsel = trestir.restir_direct(
        None, tgb, trestir.Reservoirs(**{k: torch.as_tensor(v) for k, v in prev.items()}),
        torch.as_tensor(state.astype(np.int64)), torch.as_tensor(active),
        torch.as_tensor(lanes["pos"]), torch.as_tensor(lanes["normal"]),
        torch.as_tensor(lanes["albedo"]), torch.as_tensor(pixel_idx),
        prev_cam=prev_t, cam_origin=torch.as_tensor(cam_t.origin),
        enable_temporal=torch.as_tensor(en), enable_spatial=torch.as_tensor(en),
        **common,
    )
    np.testing.assert_array_equal(np.asarray(jst).astype(np.int64), tst.numpy())
    for f in ("m", "light_id"):
        np.testing.assert_array_equal(np.asarray(getattr(jres, f)), getattr(tres, f).numpy())
    for f in ("L", "wi", "pdf", "w", "w_sum", "W"):
        np.testing.assert_allclose(np.asarray(getattr(jres, f)), getattr(tres, f).numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    for f in ("ok", "is_sun"):
        np.testing.assert_array_equal(np.asarray(jsel[f]), tsel[f].numpy())
    for f in ("wi", "contrib"):
        np.testing.assert_allclose(np.asarray(jsel[f]), tsel[f].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert int(tres.m.max()) > 9 if kw["static_reuse"] else int(tres.m.max()) == 9


def test_reservoir_gather_matches_reference():
    _gbn, prev, *_ = _inputs(29)
    n = W * H
    idx = np.random.default_rng(3).integers(-5, n + 5, size=3000).astype(np.int32)
    idx[:4] = [-1, 0, n - 1, n]
    jg = jrestir.Reservoirs(**{k: jnp.asarray(v) for k, v in prev.items()}).gather(
        jnp.asarray(idx))
    tg = trestir.Reservoirs(**{k: torch.as_tensor(v) for k, v in prev.items()}).gather(
        torch.as_tensor(idx))
    for k in prev:
        np.testing.assert_array_equal(np.asarray(getattr(jg, k)), getattr(tg, k).numpy(),
                                      err_msg=k)


def test_reproject_and_spatial_rows_exact():
    gbn, prev, _lanes, _state, _a, _e = _inputs(23)
    cam_j, cam_t = jcam(W, H), tcam(W, H)
    pj = jrestir.reproject_to_prev_pixel(
        jnp.asarray(gbn["pos"]), cam_j.translate([0.02, 0.01, 0.0]), W, H)
    pt = trestir.reproject_to_prev_pixel(
        torch.as_tensor(gbn["pos"]), cam_t.translate([0.02, 0.01, 0.0]), W, H)
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    jrp = jrestir._pack_reservoirs(jrestir.Reservoirs(**{k: jnp.asarray(v) for k, v in prev.items()}))
    trp = trestir._pack_reservoirs(trestir.Reservoirs(**{k: torch.as_tensor(v) for k, v in prev.items()}))
    jgp = jrestir._pack_gbuffer(jint.GBuffer(**{k: jnp.asarray(v) for k, v in gbn.items()}))
    tgp = trestir._pack_gbuffer(tint.GBuffer(**{k: torch.as_tensor(v) for k, v in gbn.items()}))
    jf = jrestir._spatial_row_fetcher(jrp, jgp, W, H, 5)
    tf = trestir._spatial_row_fetcher(trp, tgp, W, H, 5)
    idx = np.arange(W * H, dtype=np.int32)
    for slot in range(8):
        for a, b in zip(jf(slot, 0, W * H), tf(slot, torch.as_tensor(idx))):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
