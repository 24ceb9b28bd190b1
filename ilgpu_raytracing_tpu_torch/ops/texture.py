"""Texture sampling from the flat texel pool (port of ops/texture.py).

V flip, (w-1)/(h-1) footprint, wrap-by-fraction addressing and the luma
alpha read of the reference samplers (SceneDeviceViews.cs:329-472). Ids
< 0 or empty textures return white / alpha 1. Every gather index is
clamped, as `jnp.take(mode="clip")` clamps in the JAX package.
"""

from __future__ import annotations

import torch

from ilgpu_raytracing_tpu_torch.models.scene import SceneData


def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather with indices clamped into range (jnp mode="clip")."""
    return arr[idx.long().clamp(0, arr.shape[0] - 1)]


def _texinfo(scene: SceneData, tex_id):
    off = take(scene.tex_offset, tex_id)
    w = take(scene.tex_width, tex_id)
    h = take(scene.tex_height, tex_id)
    valid = (tex_id >= 0) & (tex_id < scene.tex_offset.shape[0]) & (w > 0) & (h > 0)
    return off, w, h, valid


def _texel(scene: SceneData, off, w, h, x, y):
    """Clamped texel fetch (SceneDeviceViews.cs:330-339)."""
    sx = torch.minimum(torch.clamp(x, min=0), torch.clamp(w - 1, min=0))
    sy = torch.minimum(torch.clamp(y, min=0), torch.clamp(h - 1, min=0))
    return take(scene.texels, off + sy * w + sx)


def _rgb(p):
    r = ((p >> 16) & 255).to(torch.float32)
    g = ((p >> 8) & 255).to(torch.float32)
    b = (p & 255).to(torch.float32)
    return torch.stack([r, g, b], dim=-1) * (1.0 / 255.0)


def _bilinear_setup(u, v, w, h):
    """Wrap by fraction, V flip, (dim-1) footprint (SceneDeviceViews.cs:360-375)."""
    fu = u - torch.floor(u)
    fv = 1.0 - (v - torch.floor(v))
    x = fu * (w - 1).to(torch.float32)
    y = fv * (h - 1).to(torch.float32)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1 = torch.minimum(w - 1, x0 + 1)
    y1 = torch.minimum(h - 1, y0 + 1)
    tx = x - x0.to(torch.float32)
    ty = y - y0.to(torch.float32)
    return x0, y0, x1, y1, tx, ty


def sample_texture_bilinear(scene: SceneData, tex_id, u, v):
    """Bilinear RGB; invalid ids -> white (SceneDeviceViews.cs:358-385)."""
    off, w, h, valid = _texinfo(scene, tex_id)
    x0, y0, x1, y1, tx, ty = _bilinear_setup(u, v, w, h)
    c00 = _rgb(_texel(scene, off, w, h, x0, y0))
    c10 = _rgb(_texel(scene, off, w, h, x1, y0))
    c01 = _rgb(_texel(scene, off, w, h, x0, y1))
    c11 = _rgb(_texel(scene, off, w, h, x1, y1))
    cx0 = c00 * (1.0 - tx)[..., None] + c10 * tx[..., None]
    cx1 = c01 * (1.0 - tx)[..., None] + c11 * tx[..., None]
    c = cx0 * (1.0 - ty)[..., None] + cx1 * ty[..., None]
    return torch.where(valid[..., None], c, torch.ones_like(c))


def _luma01(p):
    c = _rgb(p)
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def sample_mask_bilinear(scene: SceneData, tex_id, u, v):
    """Bilinear alpha mask from luma; invalid -> 1
    (SceneDeviceViews.cs:387-415)."""
    off, w, h, valid = _texinfo(scene, tex_id)
    x0, y0, x1, y1, tx, ty = _bilinear_setup(u, v, w, h)
    a00 = _luma01(_texel(scene, off, w, h, x0, y0))
    a10 = _luma01(_texel(scene, off, w, h, x1, y0))
    a01 = _luma01(_texel(scene, off, w, h, x0, y1))
    a11 = _luma01(_texel(scene, off, w, h, x1, y1))
    ax0 = a00 * (1.0 - tx) + a10 * tx
    ax1 = a01 * (1.0 - tx) + a11 * tx
    a = ax0 * (1.0 - ty) + ax1 * ty
    return torch.where(valid, a, torch.ones_like(a))


def sample_mask_point(scene: SceneData, tex_id, u, v):
    """Point-sampled alpha mask (SceneDeviceViews.cs:417-428). torch.round
    rounds half to even, as jnp.round does."""
    off, w, h, valid = _texinfo(scene, tex_id)
    fu = u - torch.floor(u)
    fv = 1.0 - (v - torch.floor(v))
    x = torch.round(fu * (w - 1).to(torch.float32)).to(torch.int32)
    y = torch.round(fv * (h - 1).to(torch.float32)).to(torch.int32)
    a = _luma01(_texel(scene, off, w, h, x, y))
    return torch.where(valid, a, torch.ones_like(a))
