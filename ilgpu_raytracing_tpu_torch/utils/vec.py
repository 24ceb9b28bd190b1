"""Vector math over `(..., 3)` float32 tensors (port of utils/vec.py).

Dot products are written out term by term, left to right, so every device
and the CUDA kernels (csrc/) evaluate them in one fixed order.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the trailing axis -> (...)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1
    )


def length2(v: torch.Tensor) -> torch.Tensor:
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(length2(v))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """rsqrt-based normalize with epsilon floor (Float3.cs Normalize)."""
    inv = torch.rsqrt(torch.clamp(length2(v), min=eps))
    return v * inv[..., None]


def vec3(x, y, z, dtype=torch.float32, device="cuda") -> torch.Tensor:
    return torch.tensor([x, y, z], dtype=dtype, device=device)


def saturate(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(v, 0.0, 1.0)


def lerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    return a * (1.0 - t) + b * t


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of incident dir `i` about normal `n` (RTRay.cs:561)."""
    return i - n * (2.0 * dot(i, n))[..., None]


def refract(i: torch.Tensor, n: torch.Tensor, eta_i, eta_t):
    """Snell refraction. Returns (ok_mask, refracted_dir); dir is zeros
    under total internal reflection (RTRay.cs:564-572)."""
    eta = torch.as_tensor(eta_i / eta_t, dtype=i.dtype, device=i.device)
    cos_i = -dot(i, n)
    eta = torch.broadcast_to(eta, cos_i.shape)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0.0
    k_safe = torch.clamp(k, min=0.0)
    t = i * eta[..., None] + n * (eta * cos_i - torch.sqrt(k_safe))[..., None]
    t = normalize(t)
    return ok, torch.where(ok[..., None], t, torch.zeros_like(t))


def schlick_fresnel(cos, eta_i, eta_t) -> torch.Tensor:
    """Schlick dielectric Fresnel reflectance (RTRay.cs:574-583)."""
    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0
    omc = 1.0 - cos
    omc2 = omc * omc
    omc5 = omc2 * omc2 * omc
    return r0 + (1.0 - r0) * omc5


def orthonormal_basis(n: torch.Tensor):
    """Tangent/bitangent frame around unit normal n (RTRay.cs:600-606)."""
    up_y = torch.abs(n[..., 1]) < 0.999
    y = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    x = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    up = torch.where(up_y[..., None], y, x)
    t = normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Rec.709 luma (RTRay.cs:627)."""
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def safe_color(c: torch.Tensor, max_abs: float = 1e6) -> torch.Tensor:
    """NaN/Inf scrub + clamp to +-max_abs (RTRay.cs:645-655)."""
    c = torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.clamp(c, -max_abs, max_abs)


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """Reciprocal ray direction with zero-guard (RTRay.cs:548-549)."""
    safe = torch.where(d != 0.0, d, torch.full_like(d, 1e-8))
    return 1.0 / safe


def transform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Row-major 3x4 affine `m` (..., 3, 4) applied to points (..., 3)."""
    return torch.stack(
        [
            m[..., r, 0] * p[..., 0] + m[..., r, 1] * p[..., 1]
            + m[..., r, 2] * p[..., 2] + m[..., r, 3]
            for r in range(3)
        ],
        dim=-1,
    )


def transform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Linear part of a 3x4 affine applied to vectors (..., 3)."""
    return torch.stack(
        [
            m[..., r, 0] * v[..., 0] + m[..., r, 1] * v[..., 1]
            + m[..., r, 2] * v[..., 2]
            for r in range(3)
        ],
        dim=-1,
    )
