"""Host-side image IO (port of utils/image.py): device tensor -> host -> PNG."""

from __future__ import annotations

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.utils import packing


def packed_to_numpy_rgb(packed, width: int, height: int) -> np.ndarray:
    """0xAARRGGBB flat (H*W,) -> (H, W, 3) uint8."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    p = np.asarray(packed).astype(np.uint32).reshape(height, width)
    out = np.empty((height, width, 3), dtype=np.uint8)
    out[..., 0] = (p >> 16) & 255
    out[..., 1] = (p >> 8) & 255
    out[..., 2] = p & 255
    return out


def linear_to_uint8(color, srgb: bool = False) -> np.ndarray:
    """(H, W, 3) linear float -> uint8, clamped; optionally sRGB-encoded."""
    c = torch.as_tensor(color, dtype=torch.float32)
    if srgb:
        c = packing.linear_to_srgb(c)
    arr = (torch.clamp(c, 0.0, 1.0) * 255.99).cpu().numpy().astype(np.float32)
    return arr.astype(np.uint8)


def save_png(path: str, rgb_uint8: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(rgb_uint8, mode="RGB").save(path)


def save_packed_png(path: str, packed, width: int, height: int) -> None:
    save_png(path, packed_to_numpy_rgb(packed, width, height))
