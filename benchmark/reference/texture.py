"""The reference's texture reads: RGBA8 textures in one flat pool of texels,
sampled as the upstream renderer samples them (`SceneDeviceViews.cs:329-472`).

A texture is stored top row first, its texel (x, y) at `off + y * w + x`.
Coordinates wrap by their fraction and V is flipped (`v = 0` is the bottom
row); the footprint is (w - 1) x (h - 1) texels, so `u = 1` lands on the
last column. A fetch clamps into the texture. Colour is each byte over
255; a mask is the luminance of that colour. The bilinear sample blends the
four texels around the point; the point sample rounds to the nearest texel,
half to even. An id below 0 reads white, and a mask of 1.

A material's cutout: a closest hit accepts a triangle where its bilinear
mask is at least the cutoff (`:208-218`). A shadow ray's any-hit test
point-samples the mask, accepts at or above cutoff + `BAND`, rejects below
cutoff - `BAND`, and only between the two lets the bilinear mask decide
(`:297-315`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BAND = 0.10


@dataclasses.dataclass
class Pool:
    rgb: torch.Tensor  # (X, 3) float32 in [0, 1]
    luma: torch.Tensor  # (X,)
    off: torch.Tensor  # (K,) int64
    w: torch.Tensor
    h: torch.Tensor


def pool(textures: list, device, round_to=None) -> Pool:
    """The pool of (H, W, 4) uint8 RGBA arrays, in their order (the texture
    ids). `round_to` (a torch dtype) rounds every texel's values to that
    precision: the control."""
    sizes = [(int(t.shape[1]), int(t.shape[0])) for t in textures]
    off = np.cumsum([0] + [w * h for w, h in sizes])[:-1]
    flat = np.concatenate([np.asarray(t, np.uint8)[..., :3].reshape(-1, 3) for t in textures])
    c = torch.as_tensor(flat, device=device).to(torch.float32) * (1.0 / 255.0)
    if round_to is not None:
        c = c.to(round_to).to(torch.float32)
    luma = 0.2126 * c[:, 0] + 0.7152 * c[:, 1] + 0.0722 * c[:, 2]
    if round_to is not None:
        luma = luma.to(round_to).to(torch.float32)
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return Pool(rgb=c, luma=luma, off=i(off), w=i([s[0] for s in sizes]),
                h=i([s[1] for s in sizes]))


def uv_at(corner_uv, bu, bv):
    """(u, v) at barycentrics (bu, bv) of triangles with corner UVs
    `corner_uv` (..., 3, 2)."""
    w = 1.0 - bu - bv
    return tuple(corner_uv[..., 0, k] * w + corner_uv[..., 1, k] * bu
                 + corner_uv[..., 2, k] * bv for k in (0, 1))


def _info(p: Pool, tex):
    t = tex.long().clamp(0, p.off.shape[0] - 1)
    return p.off[t], p.w[t], p.h[t], tex >= 0


def _fetch(img, off, w, h, x, y):
    sx = torch.minimum(x.clamp(min=0), (w - 1).clamp(min=0))
    sy = torch.minimum(y.clamp(min=0), (h - 1).clamp(min=0))
    return img[off + sy * w + sx]


def _wrap(u, v):
    return u - torch.floor(u), 1.0 - (v - torch.floor(v))


def bilinear(p: Pool, img, tex, u, v):
    """`img` (p.rgb or p.luma) sampled bilinearly at (u, v) of texture
    `tex`; white (1) where `tex` < 0."""
    off, w, h, valid = _info(p, tex)
    fu, fv = _wrap(u, v)
    x = fu * (w - 1).to(torch.float32)
    y = fv * (h - 1).to(torch.float32)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    x1, y1 = torch.minimum(w - 1, x0 + 1), torch.minimum(h - 1, y0 + 1)
    tx, ty = x - x0.to(torch.float32), y - y0.to(torch.float32)
    if img.dim() == 2:
        tx, ty = tx[..., None], ty[..., None]
    a = _fetch(img, off, w, h, x0, y0) * (1.0 - tx) + _fetch(img, off, w, h, x1, y0) * tx
    b = _fetch(img, off, w, h, x0, y1) * (1.0 - tx) + _fetch(img, off, w, h, x1, y1) * tx
    out = a * (1.0 - ty) + b * ty
    return torch.where(valid[..., None] if img.dim() == 2 else valid, out,
                       torch.ones_like(out))


def point(p: Pool, img, tex, u, v):
    """`img` at the texel nearest (u, v), half to even; 1 where `tex` < 0."""
    off, w, h, valid = _info(p, tex)
    fu, fv = _wrap(u, v)
    x = torch.round(fu * (w - 1).to(torch.float32)).long()
    y = torch.round(fv * (h - 1).to(torch.float32)).long()
    out = _fetch(img, off, w, h, x, y)
    return torch.where(valid, out, torch.ones_like(out))


def opaque(p: Pool, alpha_tex, cutoff, u, v, closest: bool):
    """Whether a candidate hit at (u, v) is accepted by its material's
    cutout (True where the material has no mask)."""
    if closest:
        ok = bilinear(p, p.luma, alpha_tex, u, v) >= cutoff
    else:
        a_pt = point(p, p.luma, alpha_tex, u, v)
        sure = a_pt >= cutoff + BAND
        band = ~(a_pt < cutoff - BAND) & ~sure
        ok = sure | (band & (bilinear(p, p.luma, alpha_tex, u, v) >= cutoff))
    return ok | (alpha_tex < 0)
