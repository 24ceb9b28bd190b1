"""Estimator parity of the port against the JAX package on the CPU
(examples/parity_check.py's comparison, BASELINE configs 2 and 3).

For each config both integrators render the same G-buffer's path trace
over K = 8 noise seeds (`(s * 2654435761 & 0xFFFFFFFF) | 1`, as
parity_check.py draws them) on the same scene tables (the JAX scene read
into the port with `scene_from_numpy`), with the RR defaults on and reuse
off (parity_check.py:40-43). The per-pixel means must agree within the
Monte-Carlo floor: the RMSE of the means over the 95% of pixels away from
discrete-decision boundaries at most 1.5x sqrt(mean((var_jax +
var_port) / K)) (parity_check.py:94-112). Single frames legitimately
differ pixel-wise: XLA contracts FMAs on the CPU and flips whole samples
at chaotic decision boundaries; the estimator means may not.

Cuts (the CPU's time, not the estimator): config 2 (the default sphere
scene, diffuse / metal / dielectric, 4 bounces) at spp 4 of BASELINE's
16, 32x32; config 3 (Cornell tess=4, the triangle-mesh scene) at 32x24
of BASELINE's 800x600, spp 2, max_depth 3. The port runs the Renderer's
route: the WideScene's wrappers, here the plain versions of K1/K2/K3.

Most of the file's time is XLA's CPU compile of the two configs' frame
graphs (path_trace unrolls its bounces), so the frame graph is compiled
without LLVM's optimisation passes. Both configs are traced, compiled and
run on worker threads (XLA compiles without the GIL) while the port's
frames render on the main thread.
"""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu.config import RenderConfig as JConfig
from ilgpu_raytracing_tpu.models.camera import Camera as JCamera
from ilgpu_raytracing_tpu.models.cornell import build_cornell_scene as jcornell
from ilgpu_raytracing_tpu.models.cornell import cornell_camera as jcornell_camera
from ilgpu_raytracing_tpu.models.scene import build_default_scene as jdefault
from ilgpu_raytracing_tpu.ops import integrator as jint
from ilgpu_raytracing_tpu.ops import sky as jsky
from ilgpu_raytracing_tpu.ops.restir import Reservoirs as JRes
from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.models.cornell import cornell_camera
from ilgpu_raytracing_tpu_torch.models.scene import _FIELDS, scene_from_numpy
from ilgpu_raytracing_tpu_torch.ops import integrator, sky
from ilgpu_raytracing_tpu_torch.ops.cuda import wide
from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)

SEEDS = 8
# reuse off, RR defaults (examples/parity_check.py:40-43)
_KNOBS = dict(rng_lock_noise=1, enable_temporal_reuse=False, enable_spatial_reuse=False)


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


def _keys():
    return [(s * 2654435761 & 0xFFFFFFFF) | 1 for s in range(SEEDS)]


def _mean_var(frames):
    c = np.asarray(frames, np.float64)
    mean = c.mean(axis=0)
    return mean, np.maximum((c * c).mean(axis=0) - mean ** 2, 0.0)


def _jax_frames(w, h, knobs, js, jcam):
    """A function that renders a config's JAX frames over the seeds. The
    frame graph is traced here (which holds the GIL), and compiled at the
    function's first call (which mostly does not)."""
    jcfg = JConfig(**knobs)
    sun = jsky.sun_direction(jcfg.sun_azimuth, jcfg.sun_elevation)
    gb = jint.primary_visibility(js, jcam, w, h, jcfg.chunk_pixels)
    n = w * h
    args = (js, gb, jcam, jcam, JRes.empty(n), JRes.empty(n), 0)
    # LLVM's optimisation passes are most of XLA's CPU compile, and a 32x32
    # frame runs in well under a second without them
    trace = jax.jit(functools.partial(jint.path_trace, cfg=jcfg, width=w, height=h),
                    compiler_options={"xla_backend_optimization_level": 0})
    trace.lower(*args, np.uint32(1), sun)
    return lambda: [np.asarray(trace(*args, np.uint32(key), sun)[0]) for key in _keys()]


def _port_frames(js, cam, w, h, cfg):
    tables = {k: np.asarray(getattr(js, k)) for k in _FIELDS}
    tables.update(has_alpha=js.has_alpha, blas_leaf_max=js.blas_leaf_max,
                  tlas_leaf_max=js.tlas_leaf_max)
    ts = scene_from_numpy(tables, "cpu")
    ks = wide.prepare_scene(ts)
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    n = w * h
    with torch.inference_mode():
        gb = integrator.primary_visibility(ts, cam, w, h, cfg.chunk_pixels, ks)
        return [integrator.path_trace(
            ts, gb, cam, cam, Reservoirs.empty(n, "cpu"), Reservoirs.empty(n, "cpu"),
            0, key, sun, cfg, w, h, ks)[0].numpy() for key in _keys()]


def _config(config):
    """(w, h, knobs, JAX scene, JAX camera, port camera) of a config."""
    if config == "2":
        w, h, knobs = 32, 32, dict(spp=4, max_depth=4, **_KNOBS)
        _, js = jdefault()
        return w, h, knobs, js, JCamera.create(w, h, 60.0), Camera.create(w, h, 60.0)
    w, h, knobs = 32, 24, dict(spp=2, max_depth=3, **_KNOBS)
    _, js = jcornell(tess=4, sphere_tess=(8, 12))
    return w, h, knobs, js, jcornell_camera(w, h), cornell_camera(w, h)


@pytest.fixture(scope="module")
def means():
    """Per config the (mean, var) of the JAX frames and of the port's. The
    JAX frames of both configs are worker threads started together, so
    both compile at once while the port's frames render."""
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cases = {c: _config(c) for c in ("2", "3")}
        jax_frames = {c: pool.submit(_jax_frames(*case[:5])) for c, case in cases.items()}
        port = {c: _mean_var(_port_frames(js, cam, w, h, RenderConfig(**knobs)))
                for c, (w, h, knobs, js, _, cam) in cases.items()}
        return {c: (*_mean_var(jax_frames[c].result()), *port[c]) for c in cases}


@pytest.mark.parametrize("config", ["2", "3"])
def test_estimator_means_within_noise_floor(config, means):
    mean_a, var_a, mean_b, var_b = means[config]
    assert np.isfinite(mean_b).all()

    err2 = ((mean_a - mean_b) ** 2).mean(axis=1)
    robust = float(np.sqrt(np.sort(err2)[:int(err2.shape[0] * 0.95)].mean()))
    floor = float(np.sqrt(np.mean((var_a + var_b) / SEEDS)))
    signal = float(np.sqrt(np.mean(mean_a ** 2)))
    print(f"config {config}: rmse_of_means {np.sqrt(err2.mean()):.6f}, "
          f"rmse_robust_p95 {robust:.6f}, noise_floor {floor:.6f}, "
          f"robust/floor {robust / floor:.4f}, signal_rms {signal:.6f}")
    assert floor > 0.01 * signal, "no Monte-Carlo noise: the seeds did not vary"
    assert robust <= 1.5 * floor
