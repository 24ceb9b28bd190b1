"""Primary ray generation from the camera plane parametrization."""

from __future__ import annotations

import torch

from ilgpu_raytracing_tpu_torch.ops import layout
from ilgpu_raytracing_tpu_torch.utils import vec


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def generate_rays(camera, u: torch.Tensor, v: torch.Tensor):
    """Rays through normalized plane coords (u, v) in [0,1]
    (reference RTUtils.cs Ray.GenerateRay:13-17). Returns (o, d), (N,3)."""
    dev = u.device
    origin = _f32(camera.origin, dev)
    lower_left = _f32(camera.lower_left, dev)
    horizontal = _f32(camera.horizontal, dev)
    vertical = _f32(camera.vertical, dev)
    d = lower_left + horizontal * u[..., None] + vertical * v[..., None] - origin
    d = vec.normalize(d)
    o = torch.broadcast_to(origin, d.shape)
    return o, d


def pixel_centers(width: int, height: int, device=None):
    """Flat pixel-center (u, v) grid in the frame's block-linear order."""
    idx = torch.arange(width * height, dtype=torch.int32, device=device)
    x, y = layout.xy_from_position(idx, width, height)
    u = (x.to(torch.float32) + 0.5) / float(max(1, width))
    v = (y.to(torch.float32) + 0.5) / float(max(1, height))
    return u, v


def generate_primary_rays(camera, width: int, height: int, device=None):
    u, v = pixel_centers(width, height, device)
    return generate_rays(camera, u, v)
