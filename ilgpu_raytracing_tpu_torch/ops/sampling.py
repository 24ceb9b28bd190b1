"""Cosine-hemisphere sampling and pdfs (RTRay.cs:585-606, 630-634)."""

from __future__ import annotations

import math

import torch

from ilgpu_raytracing_tpu_torch.utils import rng as rng_mod
from ilgpu_raytracing_tpu_torch.utils import vec

INV_PI = 0.31830988618379067154


def sample_hemisphere_cosine(n: torch.Tensor, state: torch.Tensor):
    """Cosine-weighted hemisphere sample around unit normal n.
    Returns (new_rng_state, wi); two RNG draws per lane."""
    state, r1 = rng_mod.next_float(state)
    state, r2 = rng_mod.next_float(state)
    phi = 2.0 * math.pi * r1
    cos_theta = torch.sqrt(1.0 - r2)
    sin_theta = torch.sqrt(r2)
    x = torch.cos(phi) * sin_theta
    y = torch.sin(phi) * sin_theta
    z = cos_theta
    t, b = vec.orthonormal_basis(n)
    wi = t * x[..., None] + b * y[..., None] + n * z[..., None]
    return state, vec.normalize(wi)


def cos_hemisphere_pdf(n: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    return torch.clamp(vec.dot(n, wi), min=0.0) * INV_PI
