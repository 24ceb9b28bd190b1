"""Counter-based per-pixel RNG (port of utils/rng.py), bit-exact.

PyTorch lacks uint32 shifts and multiplies on CPU and covers them only in
part on CUDA, so a uint32 value lives in an int64 tensor holding
[0, 2^32). Every left shift and multiply is masked back to 32 bits, and a
multiply by a 32-bit constant is split into 16-bit halves so no
intermediate leaves int64's range (signed overflow is never relied on).
Streams, lock semantics and the returned floats are bit-identical to the
JAX package's uint32 arithmetic.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF


def u32(x, device=None) -> torch.Tensor:
    """Python int / numpy value / tensor -> int64 tensor of uint32 values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.as_tensor(int(x) & MASK, dtype=torch.int64, device=device)


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c."""
    lo = c & 0xFFFF
    hi = (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def _shl(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) & MASK


def rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    r = r & 31
    if r == 0:
        return v
    return _shl(v, r) | (v >> (32 - r))


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Integer finalizer (reference Hash32, RTUtils.cs:77-84)."""
    x = x ^ (x >> 17)
    x = _mul(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul(x, 0x31848BAB)
    x = x ^ (x >> 14)
    return x


def pcg_permute(x: torch.Tensor) -> torch.Tensor:
    """PCG XSH-RR-like output permutation (RTUtils.cs:65-74)."""
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def make_seed32(a, b, c, d) -> torch.Tensor:
    """Mix four 32-bit lanes into one nonzero seed (RTUtils.cs:87-97)."""
    s0 = pcg_permute((hash32(a ^ 0xD1B54A33) + rotl(b, 16)) & MASK)
    s1 = pcg_permute((hash32(c ^ 0x94D049BB) + rotl(d, 8)) & MASK)
    s = pcg_permute(s0 ^ ((rotl(s1, 13) + 0x9E3779B1) & MASK))
    return s | 1


def seed_from_pixel(px, py, frame, sample, salt, noise_key) -> torch.Tensor:
    """Seed per (pixel, frame, sample, salt) with lockNoise semantics
    (RTUtils.cs:121-133). px/py/sample may be tensors; frame, salt and
    noise_key are host integers (the frame index and key come from the
    host loop every frame)."""
    dev = px.device if isinstance(px, torch.Tensor) else None
    px = u32(px, dev)
    py = u32(py, dev)
    sample = u32(sample, dev)
    ln = int(noise_key) & MASK
    salt = int(salt) & MASK
    f = 0 if ln != 0 else int(frame) & MASK
    if ln != 0:
        lnt = u32(ln, dev)
        ln_mix0 = hash32(lnt) ^ _mul(lnt, 0x1B873593)
        ln_mix1 = _mul(rotl(lnt, 7), 0x85EBCA6B)
    else:
        ln_mix0 = ln_mix1 = 0

    f_term = ((f * 0x9E3779B1) + 0x85EBCA6B) & MASK
    lane0a = px ^ 0xB5297A4D
    lane0b = _mul(py, 0x68E31DA4) ^ f_term ^ ln_mix0
    lane1a = ((sample ^ 0xC2B2AE35) + rotl(px, 16)) & MASK
    lane1b = (((salt ^ 0x27D4EB2F) + rotl(py, 8)) & MASK) ^ ln_mix1
    return make_seed32(lane0a, lane0b, lane1a, lane1b)


def seed_from_index(index, width, frame, sample, salt, noise_key) -> torch.Tensor:
    """Seed from a flat pixel index (RTUtils.cs:108-113)."""
    index = u32(index)
    w = max(int(width) & MASK, 1)
    return seed_from_pixel(index % w, index // w, frame, sample, salt, noise_key)


# --------- xorshift32 stream (RTUtils.cs:33-49) ---------


def next_uint(state: torch.Tensor):
    """One xorshift32 step. Returns (new_state, value) where value == state."""
    x = state
    x = x ^ _shl(x, 13)
    x = x ^ (x >> 17)
    x = x ^ _shl(x, 5)
    x = torch.where(x != 0, x, torch.ones_like(x))
    return x, x


def _unit_float(v: torch.Tensor) -> torch.Tensor:
    return (v & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)


def next_float(state: torch.Tensor):
    """Uniform float32 in [0, 1) with 24-bit mantissa (RTUtils.cs:44-49)."""
    state, v = next_uint(state)
    return state, _unit_float(v)


def next_float2(state: torch.Tensor):
    """Two uniforms; returns (new_state, u1, u2)."""
    state, u1 = next_float(state)
    state, u2 = next_float(state)
    return state, u1, u2


def side_float(state: torch.Tensor, salt) -> torch.Tensor:
    """Uniform [0, 1) from the CURRENT state without advancing it: a
    decorrelated side-stream (see the reference module's docstring)."""
    return _unit_float(pcg_permute(hash32(state ^ (int(salt) & MASK))))
