"""Plain PyTorch building blocks of the reference frame.

A frozen restatement of the path tracer's plain arithmetic: vector math,
the counter-based RNG (uint32 values held in int64, every shift and
multiply masked to 32 bits), the block-linear pixel layout, primary rays,
the sky and sun, cosine sampling, the intersection tests and the colour
packing. It imports nothing of the program under test. Every expression
keeps the order of operations of the renderer it judges, so both sides
round alike and a frame can be compared pixel for pixel.
"""

from __future__ import annotations

import math

import numpy as np
import torch

T_EPS = 0.001
T_INF = 1e30
T_HIT_MAX = 1e29
INV_PI = 0.31830988618379067154
MASK = 0xFFFFFFFF

# ---------------- vectors ----------------


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v, eps: float = 1e-20):
    inv = torch.rsqrt(torch.clamp(dot(v, v), min=eps))
    return v * inv[..., None]


def reflect(i, n):
    return i - n * (2.0 * dot(i, n))[..., None]


def refract(i, n, eta_i, eta_t):
    eta = torch.as_tensor(eta_i / eta_t, dtype=i.dtype, device=i.device)
    cos_i = -dot(i, n)
    eta = torch.broadcast_to(eta, cos_i.shape)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0.0
    k_safe = torch.clamp(k, min=0.0)
    t = i * eta[..., None] + n * (eta * cos_i - torch.sqrt(k_safe))[..., None]
    t = normalize(t)
    return ok, torch.where(ok[..., None], t, torch.zeros_like(t))


def schlick_fresnel(cos, eta_i, eta_t):
    r0 = (eta_i - eta_t) / (eta_i + eta_t)
    r0 = r0 * r0
    omc = 1.0 - cos
    omc2 = omc * omc
    omc5 = omc2 * omc2 * omc
    return r0 + (1.0 - r0) * omc5


def orthonormal_basis(n):
    up_y = torch.abs(n[..., 1]) < 0.999
    y = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    x = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    up = torch.where(up_y[..., None], y, x)
    t = normalize(cross(up, n))
    b = cross(n, t)
    return t, b


def luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def safe_color(c, max_abs: float):
    c = torch.nan_to_num(c, nan=0.0, posinf=0.0, neginf=0.0)
    return torch.clamp(c, -max_abs, max_abs)


def inv_dir(d):
    safe = torch.where(d != 0.0, d, torch.full_like(d, 1e-8))
    return 1.0 / safe


def transform_point(m, p):
    return torch.stack([m[..., r, 0] * p[..., 0] + m[..., r, 1] * p[..., 1]
                        + m[..., r, 2] * p[..., 2] + m[..., r, 3] for r in range(3)], dim=-1)


def transform_vector(m, v):
    return torch.stack([m[..., r, 0] * v[..., 0] + m[..., r, 1] * v[..., 1]
                        + m[..., r, 2] * v[..., 2] for r in range(3)], dim=-1)


# ---------------- RNG (xorshift32 streams, hashed seeds) ----------------


def u32(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK
    return torch.as_tensor(int(x) & MASK, dtype=torch.int64, device=device)


def _mul(x, c: int):
    lo = c & 0xFFFF
    hi = (c >> 16) & 0xFFFF
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def _shl(x, r: int):
    return (x << r) & MASK


def rotl(v, r: int):
    r = r & 31
    if r == 0:
        return v
    return _shl(v, r) | (v >> (32 - r))


def hash32(x):
    x = x ^ (x >> 17)
    x = _mul(x, 0xED5AD4BB)
    x = x ^ (x >> 11)
    x = _mul(x, 0xAC4C1B51)
    x = x ^ (x >> 15)
    x = _mul(x, 0x31848BAB)
    x = x ^ (x >> 14)
    return x


def pcg_permute(x):
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _make_seed32(a, b, c, d):
    s0 = pcg_permute((hash32(a ^ 0xD1B54A33) + rotl(b, 16)) & MASK)
    s1 = pcg_permute((hash32(c ^ 0x94D049BB) + rotl(d, 8)) & MASK)
    s = pcg_permute(s0 ^ ((rotl(s1, 13) + 0x9E3779B1) & MASK))
    return s | 1


def seed_from_index(index, width, frame, sample, salt, noise_key):
    index = u32(index)
    w = max(int(width) & MASK, 1)
    px, py = index % w, index // w
    dev = px.device
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
    return _make_seed32(lane0a, lane0b, lane1a, lane1b)


def _unit_float(v):
    return (v & 0x00FFFFFF).to(torch.float32) * (1.0 / 16777216.0)


def next_float(state):
    x = state
    x = x ^ _shl(x, 13)
    x = x ^ (x >> 17)
    x = x ^ _shl(x, 5)
    x = torch.where(x != 0, x, torch.ones_like(x))
    return x, _unit_float(x)


def side_float(state, salt):
    return _unit_float(pcg_permute(hash32(state ^ (int(salt) & MASK))))


# ---------------- pixel layout (64x64 blocks when both axes divide) -------

BLOCK_LOG2 = 6
BLOCK = 1 << BLOCK_LOG2


def is_blocked(width: int, height: int) -> bool:
    return width % BLOCK == 0 and height % BLOCK == 0 and width > 0 and height > 0


def xy_from_position(pos, width: int, height: int):
    pos = pos.to(torch.int32)
    if not is_blocked(width, height):
        return pos % width, torch.div(pos, width, rounding_mode="floor")
    blocks_x = width >> BLOCK_LOG2
    b = pos >> (2 * BLOCK_LOG2)
    lo = pos & (BLOCK * BLOCK - 1)
    x = ((b % blocks_x) << BLOCK_LOG2) | (lo & (BLOCK - 1))
    y = (torch.div(b, blocks_x, rounding_mode="floor") << BLOCK_LOG2) | (lo >> BLOCK_LOG2)
    return x, y


def position_from_xy(x, y, width: int, height: int):
    x = x.to(torch.int32)
    y = y.to(torch.int32)
    if not is_blocked(width, height):
        return y * width + x
    blocks_x = width >> BLOCK_LOG2
    b = (y >> BLOCK_LOG2) * blocks_x + (x >> BLOCK_LOG2)
    lo = ((y & (BLOCK - 1)) << BLOCK_LOG2) | (x & (BLOCK - 1))
    return (b << (2 * BLOCK_LOG2)) | lo


def to_image(flat, width: int, height: int):
    if not is_blocked(width, height):
        return flat.reshape(height, width, *flat.shape[1:])
    by, bx = height >> BLOCK_LOG2, width >> BLOCK_LOG2
    t = flat.reshape(by, bx, BLOCK, BLOCK, *flat.shape[1:])
    order = (0, 2, 1, 3) + tuple(range(4, t.dim()))
    return t.permute(order).reshape(height, width, *flat.shape[1:])


def from_image(img):
    height, width = img.shape[0], img.shape[1]
    if not is_blocked(width, height):
        return img.reshape(height * width, *img.shape[2:])
    by, bx = height >> BLOCK_LOG2, width >> BLOCK_LOG2
    t = img.reshape(by, BLOCK, bx, BLOCK, *img.shape[2:])
    order = (0, 2, 1, 3) + tuple(range(4, t.dim()))
    return t.permute(order).reshape(height * width, *img.shape[2:])


# ---------------- camera, rays, sky ----------------


def _np3(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float32)


def _normalize_np(v: np.ndarray) -> np.ndarray:
    return v * (1.0 / math.sqrt(max(1e-20, float(np.dot(v, v)))))


def look_at(origin, target, up, vfov_degrees: float, aspect: float) -> dict:
    """Pinhole camera plane {origin, lower_left, horizontal, vertical} and
    the derived basis used by reprojection, all float32."""
    origin, target, up = _np3(origin), _np3(target), _np3(up)
    half_h = math.tan(0.5 * math.radians(vfov_degrees))
    half_w = aspect * half_h
    fwd = _normalize_np(target - origin)
    f = _normalize_np(fwd)  # the basis normalizes the forward axis once more
    hint = up
    if abs(float(np.dot(f, hint))) > 0.999:
        hint = _np3((0, 1, 0))
        if abs(float(np.dot(f, hint))) > 0.999:
            hint = _np3((1, 0, 0))
    u = _normalize_np(np.cross(f, hint))
    v = _normalize_np(np.cross(u, f))
    horizontal = u * (2.0 * half_w)
    vertical = v * (2.0 * half_h)
    lower_left = origin - u * half_w - v * half_h + fwd
    center = lower_left + horizontal * 0.5 + vertical * 0.5
    forward = _normalize_np(center - origin)
    cup = _normalize_np(vertical)
    right = _normalize_np(np.cross(forward, cup))
    focus = float(np.linalg.norm(center - origin))
    hh = 0.5 * float(np.linalg.norm(vertical))
    tan_half = hh / focus if focus > 1e-6 else hh
    lh, lv = float(np.linalg.norm(horizontal)), float(np.linalg.norm(vertical))
    return dict(origin=origin.astype(np.float32), lower_left=lower_left.astype(np.float32),
                horizontal=horizontal.astype(np.float32), vertical=vertical.astype(np.float32),
                forward=forward.astype(np.float32), right=right.astype(np.float32),
                up=cup.astype(np.float32),
                aspect=np.float32(lh / lv if (lh > 1e-6 and lv > 1e-6) else 1.0),
                fov_y=np.float32(2.0 * math.atan(tan_half)))


def camera_moved(cam: dict, prev: dict) -> bool:
    return not (np.allclose(cam["origin"], prev["origin"])
                and np.allclose(cam["lower_left"], prev["lower_left"]))


def f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def generate_rays(cam: dict, u, v):
    dev = u.device
    origin = f32(cam["origin"], dev)
    d = (f32(cam["lower_left"], dev) + f32(cam["horizontal"], dev) * u[..., None]
         + f32(cam["vertical"], dev) * v[..., None] - origin)
    d = normalize(d)
    return torch.broadcast_to(origin, d.shape), d


def pixel_centers(width: int, height: int, device):
    idx = torch.arange(width * height, dtype=torch.int32, device=device)
    x, y = xy_from_position(idx, width, height)
    return ((x.to(torch.float32) + 0.5) / float(max(1, width)),
            (y.to(torch.float32) + 0.5) / float(max(1, height)))


def sky_radiance(d, tint_top, tint_bottom):
    t = 0.5 * (d[..., 1] + 1.0)
    top = torch.as_tensor(tint_top, dtype=torch.float32, device=d.device)
    bottom = torch.as_tensor(tint_bottom, dtype=torch.float32, device=d.device)
    return bottom * (1.0 - t)[..., None] + top * t[..., None]


def advance_sun_azimuth(azimuth: float, speed: float, dt: float) -> float:
    dt = min(max(dt, 0.0), 0.1)
    az = azimuth + speed * dt
    if az >= 2.0 * math.pi:
        az -= 2.0 * math.pi
    elif az < 0.0:
        az += 2.0 * math.pi
    return az


def sun_direction(azimuth: float, elevation: float) -> np.ndarray:
    d = np.array([math.cos(azimuth) * math.cos(elevation), math.sin(elevation),
                  math.sin(azimuth) * math.cos(elevation)], dtype=np.float32)
    return d / np.linalg.norm(d)


def sample_hemisphere_cosine(n, state):
    state, r1 = next_float(state)
    state, r2 = next_float(state)
    phi = 2.0 * math.pi * r1
    cos_theta = torch.sqrt(1.0 - r2)
    sin_theta = torch.sqrt(r2)
    x = torch.cos(phi) * sin_theta
    y = torch.sin(phi) * sin_theta
    t, b = orthonormal_basis(n)
    wi = t * x[..., None] + b * y[..., None] + n * cos_theta[..., None]
    return state, normalize(wi)


def cos_hemisphere_pdf(n, wi):
    return torch.clamp(dot(n, wi), min=0.0) * INV_PI


# ---------------- intersection tests ----------------


def intersect_aabb(o, inv_d, bmin, bmax, t_min: float, t_max):
    t1 = (bmin - o) * inv_d
    t2 = (bmax - o) * inv_d
    tlo = torch.minimum(t1, t2)
    thi = torch.maximum(t1, t2)
    tmin = torch.maximum(torch.maximum(tlo[..., 0], tlo[..., 1]), tlo[..., 2])
    tmax = torch.minimum(torch.minimum(thi[..., 0], thi[..., 1]), thi[..., 2])
    lo = torch.clamp(tmin, min=t_min)
    return (tmax >= lo) & (tmin <= t_max)


def intersect_sphere(o, d, center, radius):
    oc = o - center
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    c = dot(oc, oc) - radius * radius
    disc = b * b - 4.0 * a * c
    sqrt_d = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_2a = 1.0 / (2.0 * a)
    t0 = (-b - sqrt_d) * inv_2a
    t1 = (-b + sqrt_d) * inv_2a
    t = torch.where(t0 >= T_EPS, t0, t1)
    ok = (disc >= 0.0) & (t >= T_EPS)
    return ok, torch.where(ok, t, torch.zeros_like(t))


def intersect_triangle(o, d, v0, e1, e2):
    p = cross(d, e2)
    det = dot(e1, p)
    ok = torch.abs(det) >= 1e-8
    inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - v0
    bu = dot(tv, p) * inv_det
    ok = ok & (bu >= 0.0) & (bu <= 1.0)
    q = cross(tv, e1)
    bv = dot(d, q) * inv_det
    ok = ok & (bv >= 0.0) & (bu + bv <= 1.0)
    t = dot(e2, q) * inv_det
    ok = ok & (t > 0.0)
    z = torch.zeros_like(t)
    return ok, torch.where(ok, t, z), torch.where(ok, bu, z), torch.where(ok, bv, z)


# ---------------- colour packing (0xAARRGGBB in int64) ----------------


def pack_rgba8(c):
    r, g, b = ((255.99 * torch.clamp(c[..., i], 0.0, 1.0)).to(torch.int64) for i in range(3))
    return (0xFF << 24) | (r << 16) | (g << 8) | b


def unpack_rgb8(p):
    p = p.to(torch.int64)
    r = ((p >> 16) & 255).to(torch.float32)
    g = ((p >> 8) & 255).to(torch.float32)
    b = (p & 255).to(torch.float32)
    return torch.stack([r, g, b], dim=-1) * (1.0 / 255.0)


def srgb_to_linear(c):
    return torch.where(c <= 0.04045, c / 12.92, torch.pow((c + 0.055) / 1.055, 2.4))


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, 12.92 * c, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def pack_srgb(c_linear):
    s = linear_to_srgb(c_linear)
    b = torch.round(torch.clamp(s, 0.0, 1.0) * 255.0).to(torch.int64)
    return (0xFF << 24) | (b[..., 0] << 16) | (b[..., 1] << 8) | b[..., 2]


def unpack_srgb(p):
    return srgb_to_linear(unpack_rgb8(p))
