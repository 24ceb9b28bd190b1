"""Environment light: vertical sky gradient + animated directional sun
(reference SkyWeighted RTRay.cs:163-168; sun RTRenderer.cs:168-178)."""

from __future__ import annotations

import math

import numpy as np
import torch


def sky_radiance(d: torch.Tensor, tint_top, tint_bottom) -> torch.Tensor:
    """lerp(bottom, top, 0.5*(dir.y + 1))."""
    t = 0.5 * (d[..., 1] + 1.0)
    top = torch.as_tensor(tint_top, dtype=torch.float32, device=d.device)
    bottom = torch.as_tensor(tint_bottom, dtype=torch.float32, device=d.device)
    return bottom * (1.0 - t)[..., None] + top * t[..., None]


def advance_sun_azimuth(azimuth: float, speed_rad_per_sec: float, dt: float) -> float:
    """dt-based azimuth integration, dt clamped to 0.1 s, 2*pi wrap
    (RTRenderer.cs:169-172). Host-side."""
    dt = min(max(dt, 0.0), 0.1)
    az = azimuth + speed_rad_per_sec * dt
    two_pi = 2.0 * math.pi
    if az >= two_pi:
        az -= two_pi
    elif az < 0.0:
        az += two_pi
    return az


def sun_direction(azimuth: float, elevation: float) -> np.ndarray:
    """Unit sun direction from azimuth/elevation (RTRenderer.cs:174-178)."""
    d = np.array(
        [
            math.cos(azimuth) * math.cos(elevation),
            math.sin(elevation),
            math.sin(azimuth) * math.cos(elevation),
        ],
        dtype=np.float32,
    )
    return d / np.linalg.norm(d)
