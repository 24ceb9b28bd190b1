"""TAAU: temporal AA + upsample resolve (port of ops/taa.py, reference
RTTaa.cs).

Smoothstep-weighted taps in linearized sRGB, a 3x3 neighborhood min/max
from +-0.5-texel taps, history reset on objId disocclusion, history clamp,
feedback blend and a light unsharp mask. Taps depend only on the output x
(columns) or y (rows), so each is two separable axis gathers over a
linear-light image converted once. No motion vectors (motionScale=0).
"""

from __future__ import annotations

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.ops import layout
from ilgpu_raytracing_tpu_torch.utils import packing


def _axis_taps(out_size: int, in_size: int, offset: float, device):
    """Per-axis tap indices + smoothstep weight for one sample offset, in
    float32 as RTTaa.cs:206-229 computes them per pixel."""
    p = np.arange(out_size, dtype=np.float32)
    ratio = np.float32(float(in_size) / float(out_size))
    s = (p + np.float32(0.5)) * ratio - np.float32(0.5)
    if offset:
        s = s + np.float32(offset)
    i1 = np.clip(np.floor(s).astype(np.int32), 0, in_size - 1)
    i2 = np.minimum(i1 + 1, in_size - 1)
    f = s - i1.astype(np.float32)
    tt = f * (np.float32(2.0) - f)
    t = lambda a: torch.as_tensor(a, device=device)
    return t(i1.astype(np.int64)), t(i2.astype(np.int64)), t(tt)


def _nearest_taps(out_size: int, in_size: int, device):
    """Nearest low-res index per output index (RTTaa.cs:196-202)."""
    p = np.arange(out_size, dtype=np.float32)
    ratio = np.float32(float(in_size) / float(out_size))
    s = (p + np.float32(0.5)) * ratio - np.float32(0.5)
    idx = np.clip(np.round(s).astype(np.int64), 0, in_size - 1)
    return torch.as_tensor(idx, device=device)


def _sample_x(img, out_w: int, offset: float):
    """(in_h, in_w, 3) -> (in_h, out_w, 3) smoothstep blend along x."""
    x1, x2, ttx = _axis_taps(out_w, img.shape[1], offset, img.device)
    w = ttx[None, :, None]
    return img[:, x1] * (1.0 - w) + img[:, x2] * w


def _sample_y(img, out_h: int, offset: float):
    """(in_h, W, 3) -> (out_h, W, 3) smoothstep blend along y."""
    y1, y2, tty = _axis_taps(out_h, img.shape[0], offset, img.device)
    w = tty[:, None, None]
    return img[y1] * (1.0 - w) + img[y2] * w


def resolve_upsample(low_color, low_obj_id, history_color, history_obj_id,
                     history_valid: bool, in_w: int, in_h: int, out_w: int,
                     out_h: int, feedback: float = 0.075,
                     sharpness: float = 0.10):
    """Returns (out_packed, new_history_color, new_history_obj); packed
    colors are 0xAARRGGBB in int64, history row-major at output res."""
    low_img = packing.unpack_srgb(layout.to_image(low_color, in_w, in_h))

    # 3 x-offsets x 3 y-offsets = the center tap + 8 neighborhood taps
    tx = {ox: _sample_x(low_img, out_w, ox * 0.5) for ox in (-1, 0, 1)}
    cur = _sample_y(tx[0], out_h, 0.0)
    nmin = cur
    nmax = cur
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            if ox == 0 and oy == 0:
                continue
            c = _sample_y(tx[ox], out_h, oy * 0.5)
            nmin = torch.minimum(nmin, c)
            nmax = torch.maximum(nmax, c)

    obj_img = layout.to_image(low_obj_id, in_w, in_h)
    dev = low_color.device
    obj = obj_img[_nearest_taps(out_h, in_h, dev)][:, _nearest_taps(out_w, in_w, dev)]

    cur = cur.reshape(-1, 3)
    nmin = nmin.reshape(-1, 3)
    nmax = nmax.reshape(-1, 3)
    obj = obj.reshape(-1)

    hist = packing.unpack_srgb(history_color)
    reset = (history_obj_id != obj) | (not bool(history_valid))
    hist_clamped = torch.minimum(torch.maximum(hist, nmin), nmax)
    a = torch.where(reset, 1.0, feedback)
    accum = hist_clamped * (1.0 - a)[..., None] + cur * a[..., None]

    sharpen = accum * (1.0 + 2.0 * sharpness) - (nmin + nmax) * (0.5 * sharpness)
    accum = accum * (1.0 - sharpness) + sharpen * sharpness

    out = packing.pack_srgb(accum)
    return out, out, obj
