"""The two integrator settings on port CPU frames, at the sizes of the JAX
package's tests/test_deferred_shadows.py and tests/test_spp_layout.py.

- `deferred_shadows` traces the same visibility rays in one frame-wide
  sorted dispatch: colour within JAX's bar (rtol 3e-5, atol 3e-6), `eff`
  and the reservoirs bit-equal, and the any-hit dispatches of a frame fall
  from max_depth + 2 to 2. Without a kernel scene (`wscene=None`) and on
  an alpha scene the queue is ignored and the frame is bit-identical.
- `spp_pixel_major` is a pure lane permutation: colour, `eff` and every
  reservoir field bit-identical to the sample-major frame, on the plain
  walk and on the wide kernel scene, alone and with the queue.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene, cornell_camera
from ilgpu_raytracing_tpu_torch.ops import integrator, route, sky
from ilgpu_raytracing_tpu_torch.ops.cuda import wide
from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs

torch.set_num_threads(1)


def _run(cfg, scene, wscene, w, h):
    cam = cornell_camera(w, h)
    gb = integrator.primary_visibility(scene, cam, w, h, 0, wscene)
    res0 = Reservoirs.empty(w * h, "cpu")
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    color, _, _, res, eff = integrator.path_trace(
        scene, gb, cam, cam, res0, res0, 0, 0, sun, cfg, w, h, wscene)
    return color.numpy(), float(eff), {k: v.numpy() for k, v in vars(res).items()}


@pytest.fixture(scope="module")
def scene32():
    _, scene = build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                                   device="cpu")
    return scene, wide.prepare_scene(scene)


def _shadow_calls(monkeypatch):
    calls = []
    real = route.any_hit

    def spy(scene, ks, o, *a, **kw):
        calls.append(o.shape[0])
        return real(scene, ks, o, *a, **kw)

    monkeypatch.setattr(route, "any_hit", spy)
    return calls


@pytest.mark.parametrize("base", [
    RenderConfig(spp=2, max_depth=2, rng_lock_noise=0),
    RenderConfig(spp=1, max_depth=2, rng_lock_noise=0, dedup_sun_shadow=False),
], ids=["spp2", "no_sun_dedup"])
def test_deferred_matches_inline(scene32, monkeypatch, base):
    scene, ws = scene32
    calls = _shadow_calls(monkeypatch)
    out = {}
    for defer in (False, True):
        del calls[:]
        out[defer] = _run(dataclasses.replace(base, deferred_shadows=defer), scene, ws,
                          32, 32)
        out[defer, "calls"] = list(calls)
    color_i, eff_i, res_i = out[False]
    color_d, eff_d, res_d = out[True]
    np.testing.assert_allclose(color_d, color_i, rtol=3e-5, atol=3e-6)
    assert eff_d == eff_i
    for k in ("w_sum", "m", "pdf", "light_id"):
        np.testing.assert_array_equal(res_d[k], res_i[k], err_msg=k)
    # inline: the sun dedup trace (when on), one ReSTIR batch a bounce and
    # the final sky batch; deferred: the sun dedup trace and one queue of
    # (max_depth + 1) segments
    n = 32 * 32 * base.spp
    sun = [32 * 32] if base.dedup_sun_shadow else []
    assert out[False, "calls"] == sun + [n] * (base.max_depth + 1)
    assert out[True, "calls"] == sun + [n * (base.max_depth + 1)]


@pytest.mark.parametrize("where", ["no kernel scene", "alpha scene"])
def test_deferred_ignored_off_the_kernel_path(scene32, where):
    scene, ws = scene32
    if where == "alpha scene":
        scene = dataclasses.replace(scene, has_alpha=True)
    else:
        ws = None
    base = RenderConfig(spp=1, max_depth=2, rng_lock_noise=0)
    a = _run(base, scene, ws, 32, 32)
    b = _run(dataclasses.replace(base, deferred_shadows=True), scene, ws, 32, 32)
    np.testing.assert_array_equal(b[0], a[0])
    assert b[1] == a[1]


def _assert_layout_invariant(base, scene, ws, w, h):
    out = {pm: _run(dataclasses.replace(base, spp_pixel_major=pm), scene, ws, w, h)
           for pm in (False, True)}
    np.testing.assert_array_equal(out[True][0], out[False][0])
    assert out[True][1] == out[False][1]
    for k in out[False][2]:
        np.testing.assert_array_equal(out[True][2][k], out[False][2][k], err_msg=k)


def test_pixel_major_bit_identical_plain_walk():
    _, scene = build_cornell_scene(tess=2, sphere_tess=(6, 8), blas_leaf_size=8,
                                   device="cpu")
    _assert_layout_invariant(RenderConfig(spp=2, max_depth=1, rng_lock_noise=0),
                             scene, None, 24, 16)


@pytest.mark.parametrize("deferred", [False, True])
def test_pixel_major_bit_identical_wide(scene32, deferred):
    scene, ws = scene32
    base = RenderConfig(spp=2, max_depth=2, rng_lock_noise=0, deferred_shadows=deferred)
    _assert_layout_invariant(base, scene, ws, 32, 32)
