"""Color / material packing helpers (port of utils/packing.py).

Packed colors are `0xAARRGGBB` uint32 values held in int64 tensors (see
utils/rng.py for why uint32 lives in int64 here).
"""

from __future__ import annotations

import torch


def _to_byte(x: torch.Tensor) -> torch.Tensor:
    """saturate, scale by 255.99, truncate (RTRay.cs:71-76)."""
    return (255.99 * torch.clamp(x, 0.0, 1.0)).to(torch.int64)


def pack_rgba8(c: torch.Tensor) -> torch.Tensor:
    """(..., 3) linear-clamped color -> 0xAARRGGBB (alpha=255)."""
    r = _to_byte(c[..., 0])
    g = _to_byte(c[..., 1])
    b = _to_byte(c[..., 2])
    return (0xFF << 24) | (r << 16) | (g << 8) | b


def unpack_rgb8(p: torch.Tensor) -> torch.Tensor:
    """0xAARRGGBB -> (..., 3) floats in [0,1] (RTRenderer.cs:322-329)."""
    p = p.to(torch.int64)
    r = ((p >> 16) & 255).to(torch.float32)
    g = ((p >> 8) & 255).to(torch.float32)
    b = (p & 255).to(torch.float32)
    return torch.stack([r, g, b], dim=-1) * (1.0 / 255.0)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Exact piecewise sRGB EOTF (RTTaa.cs:236-240)."""
    return torch.where(
        c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4)
    )


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """Exact piecewise sRGB OETF (RTTaa.cs:250-253)."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(
        c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055
    )


def pack_srgb(c_linear: torch.Tensor) -> torch.Tensor:
    """Linear (..., 3) -> sRGB-encoded 0xAARRGGBB, round-to-nearest
    (RTTaa.cs:245-258)."""
    s = linear_to_srgb(c_linear)
    b = torch.round(torch.clamp(s, 0.0, 1.0) * 255.0).to(torch.int64)
    return (0xFF << 24) | (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2]


def unpack_srgb(p: torch.Tensor) -> torch.Tensor:
    """0xAARRGGBB (sRGB-encoded) -> linear (..., 3) (RTTaa.cs:232-242)."""
    return srgb_to_linear(unpack_rgb8(p))


def pack_mat_id(shade: torch.Tensor, ior: torch.Tensor) -> torch.Tensor:
    """Shading mode in the low 16 bits, IOR x1000 in the high 16
    (RTRay.cs:199, 608-615)."""
    q = torch.clamp(ior * 1000.0, 0.0, 65535.0).to(torch.int32)
    return (shade.to(torch.int32) & 0xFFFF) | (q << 16)


def unpack_mat_id(packed: torch.Tensor):
    shade = packed & 0xFFFF
    ior = ((packed >> 16) & 0xFFFF).to(torch.float32) / 1000.0
    return shade, ior
