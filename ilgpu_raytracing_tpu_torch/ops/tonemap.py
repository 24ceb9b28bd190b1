"""Tone mapping operators for the progressive-accumulation path."""

from __future__ import annotations

import torch


def clamp(c: torch.Tensor) -> torch.Tensor:
    return torch.clamp(c, 0.0, 1.0)


def reinhard(c: torch.Tensor) -> torch.Tensor:
    return c / (1.0 + c)


def aces(c: torch.Tensor) -> torch.Tensor:
    """Narkowicz ACES fit."""
    a, b, cc, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((c * (a * c + b)) / (c * (cc * c + d) + e), 0.0, 1.0)


OPERATORS = {"clamp": clamp, "reinhard": reinhard, "aces": aces}
