"""Bilinear blit of packed color (non-TAAU present path, reference
RTRenderer.cs:281-320), evaluated separably (port of ops/upsample.py)."""

from __future__ import annotations

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.ops import layout
from ilgpu_raytracing_tpu_torch.utils import packing


def _axis_taps(out_size: int, in_size: int, device):
    """i0/i1/weight per output index."""
    p = np.arange(out_size, dtype=np.float32)
    ratio = np.float32(float(in_size) / float(out_size))
    s = (p + np.float32(0.5)) * ratio - np.float32(0.5)
    i0 = np.clip(np.floor(s).astype(np.int64), 0, in_size - 1)
    i1 = np.clip(i0 + 1, 0, in_size - 1)
    t = np.clip(s - i0.astype(np.float32), 0.0, 1.0).astype(np.float32)
    return (torch.as_tensor(i0, device=device), torch.as_tensor(i1, device=device),
            torch.as_tensor(t, device=device))


def bilinear_upsample(src_packed, src_w: int, src_h: int, dst_w: int, dst_h: int):
    if (src_w, src_h) == (dst_w, dst_h):
        # block-linear src -> row-major presented frame (pure transpose)
        return layout.to_image(src_packed, src_w, src_h).reshape(-1)
    dev = src_packed.device
    img = packing.unpack_rgb8(layout.to_image(src_packed, src_w, src_h))
    x0, x1, tx = _axis_taps(dst_w, src_w, dev)
    y0, y1, ty = _axis_taps(dst_h, src_h, dev)
    w = tx[None, :, None]
    cx = img[:, x0] * (1.0 - w) + img[:, x1] * w
    w = ty[:, None, None]
    return packing.pack_rgba8((cx[y0] * (1.0 - w) + cx[y1] * w).reshape(-1, 3))
