"""Block-linear pixel layout (port of ops/layout.py).

Every flat per-pixel array at the internal resolution is ordered by
position p holding pixel `xy_from_position(p)`: 64x64 screen blocks when
both axes are multiples of 64, row-major otherwise. Output-resolution
arrays stay row-major.
"""

from __future__ import annotations

import torch

BLOCK_LOG2 = 6
BLOCK = 1 << BLOCK_LOG2


def is_blocked(width: int, height: int) -> bool:
    return width % BLOCK == 0 and height % BLOCK == 0 and width > 0 and height > 0


def xy_from_position(pos: torch.Tensor, width: int, height: int):
    """Array position -> pixel coords (int32 tensors)."""
    pos = pos.to(torch.int32)
    if not is_blocked(width, height):
        return pos % width, torch.div(pos, width, rounding_mode="floor")
    blocks_x = width >> BLOCK_LOG2
    b = pos >> (2 * BLOCK_LOG2)
    l = pos & (BLOCK * BLOCK - 1)
    x = ((b % blocks_x) << BLOCK_LOG2) | (l & (BLOCK - 1))
    y = (torch.div(b, blocks_x, rounding_mode="floor") << BLOCK_LOG2) | (
        l >> BLOCK_LOG2
    )
    return x, y


def position_from_xy(x: torch.Tensor, y: torch.Tensor, width: int, height: int):
    """Pixel coords -> array position. No bounds checks (callers mask)."""
    x = x.to(torch.int32)
    y = y.to(torch.int32)
    if not is_blocked(width, height):
        return y * width + x
    blocks_x = width >> BLOCK_LOG2
    b = (y >> BLOCK_LOG2) * blocks_x + (x >> BLOCK_LOG2)
    l = ((y & (BLOCK - 1)) << BLOCK_LOG2) | (x & (BLOCK - 1))
    return (b << (2 * BLOCK_LOG2)) | l


def to_image(flat: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(N, ...) position-ordered -> (height, width, ...) image."""
    if not is_blocked(width, height):
        return flat.reshape(height, width, *flat.shape[1:])
    by, bx = height >> BLOCK_LOG2, width >> BLOCK_LOG2
    t = flat.reshape(by, bx, BLOCK, BLOCK, *flat.shape[1:])
    order = (0, 2, 1, 3) + tuple(range(4, t.dim()))
    return t.permute(order).reshape(height, width, *flat.shape[1:])


def from_image(img: torch.Tensor) -> torch.Tensor:
    """(height, width, ...) image -> (N, ...) position-ordered."""
    height, width = img.shape[0], img.shape[1]
    if not is_blocked(width, height):
        return img.reshape(height * width, *img.shape[2:])
    by, bx = height >> BLOCK_LOG2, width >> BLOCK_LOG2
    t = img.reshape(by, BLOCK, bx, BLOCK, *img.shape[2:])
    order = (0, 2, 1, 3) + tuple(range(4, t.dim()))
    return t.permute(order).reshape(height * width, *img.shape[2:])
