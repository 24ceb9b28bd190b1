"""ReSTIR reuse must win on the port too: tests/test_restir_win.py on the
port's integrator and `models/canyon.py` (tables equal to the JAX
package's, tests/test_torch_scene.py), with the same seeds, frames and
bars, on the CPU through the plain tracer (no kernel scene, as the JAX
test renders without a Pallas scene).

The JAX file's docstring has the scene, the measurement and the reasoning:
at 2+1 fresh candidates on occlusion-structured lighting the reuse chain
cuts variance (0.75x measured there) and stays unbiased; at the 8+1
default it is cost-neutral (0.95x). Marked slow as the JAX file is: 48
and 24 seeds of 48x32 frame sequences.
"""

from __future__ import annotations

import numpy as np
import pytest

import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.canyon import build_canyon_scene, canyon_camera
from ilgpu_raytracing_tpu_torch.ops import integrator, restir, sky

pytestmark = pytest.mark.slow  # 48-seed statistical render sequences

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _inference_mode():
    with torch.inference_mode():
        yield


W, H = 48, 32
SEEDS = 48
WARM_FRAMES = 3

_CANYON_LIGHTING = dict(
    spp=2,
    max_depth=1,
    sun_azimuth=float(np.pi),  # toward -x: the left wall occludes it
    sun_elevation=0.25,
    sun_radiance=(6.0, 6.0, 6.0),
    sky_tint_top=(4.0, 4.2, 4.5),
    sky_tint_bottom=(0.02, 0.02, 0.03),
)


def _frame_sequence(scene, gb, cam, cfg, noise_key, frames):
    n = W * H
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    ra = restir.Reservoirs.empty(n, "cpu")
    rb = restir.Reservoirs.empty(n, "cpu")
    color = None
    for f in range(frames):
        rp, rc = (ra, rb) if f % 2 == 0 else (rb, ra)
        color, _, _, rc_out, _ = integrator.path_trace(
            scene, gb, cam, cam, rp, rc, f, noise_key, sun, cfg, W, H,
        )
        if f % 2 == 0:
            rb = rc_out
        else:
            ra = rc_out
    return color.numpy()


def _variance_ratio(scene, cam, local_candidates: int, seeds: int = SEEDS):
    cfg_reuse = RenderConfig(
        local_candidates=local_candidates,
        enable_temporal_reuse=True, enable_spatial_reuse=True,
        **_CANYON_LIGHTING,
    )
    cfg_base = RenderConfig(
        local_candidates=local_candidates,
        enable_temporal_reuse=False, enable_spatial_reuse=False,
        **_CANYON_LIGHTING,
    )
    gb = integrator.primary_visibility(scene, cam, W, H)
    reuse = np.zeros((seeds, W * H, 3), np.float32)
    base = np.zeros_like(reuse)
    for s in range(seeds):
        key = (s * 2654435761 + 1) & 0xFFFFFFFF
        reuse[s] = _frame_sequence(scene, gb, cam, cfg_reuse, key, WARM_FRAMES)
        base[s] = _frame_sequence(scene, gb, cam, cfg_base, key ^ 0xA5A5A5A5, 1)

    lum = np.array([0.2126, 0.7152, 0.0722], np.float32)
    rl = reuse @ lum
    bl = base @ lum
    vr = rl.var(axis=0, ddof=1)
    vb = bl.var(axis=0, ddof=1)
    se = np.sqrt((vr + vb) / seeds)
    lit = se > 1e-6
    assert lit.sum() > 500
    z = (rl.mean(axis=0)[lit] - bl.mean(axis=0)[lit]) / se[lit]
    return vr[lit].mean() / vb[lit].mean(), z


def test_reuse_wins_when_candidates_underresolve():
    """At 2+1 fresh candidates the reuse chain must cut variance >=10%
    (measured 0.75x) while staying unbiased."""
    _, scene = build_canyon_scene(device="cpu")
    cam = canyon_camera(W, H)
    ratio, z = _variance_ratio(scene, cam, local_candidates=2)
    assert abs(z.mean()) < 5.0 / np.sqrt(z.size), (
        f"reuse biased on canyon: mean z = {z.mean():.4f}"
    )
    assert ratio < 0.90, (
        f"reuse variance ratio {ratio:.3f} -- expected a clear win (<0.90) "
        f"at 2+1 candidates on occlusion-structured lighting"
    )


def test_reuse_cost_neutral_at_default_candidates():
    """At the reference's 8+1 default, candidates-only RIS is close to
    converged even here; reuse must at least not hurt (measured 0.95x)."""
    _, scene = build_canyon_scene(device="cpu")
    cam = canyon_camera(W, H)
    ratio, z = _variance_ratio(scene, cam, local_candidates=8, seeds=24)
    assert abs(z.mean()) < 5.0 / np.sqrt(z.size)
    assert ratio < 1.15, (
        f"reuse variance ratio {ratio:.3f} at 8+1 candidates -- regressed "
        f"past cost-neutral on the scene class it exists for"
    )
