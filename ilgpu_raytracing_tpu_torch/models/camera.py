"""Pinhole camera with the reference's plane parametrization.

The camera is {origin, lowerLeft, horizontal, vertical} plus cached derived
basis {forward, right, up, aspect, fovY} used for temporal reprojection
(reference Camera.cs:5-18; derived baking RTRenderer.cs:241-263).

Host-side numpy, as in the JAX package (port of models/camera.py); the
render functions read its fields and move them to their device.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

_WORLD_UP = np.array([0.0, 1.0, 0.0], dtype=np.float32)


def _np3(x, y, z) -> np.ndarray:
    return np.array([x, y, z], dtype=np.float32)


def _normalize(v: np.ndarray) -> np.ndarray:
    n2 = float(np.dot(v, v))
    return v * (1.0 / math.sqrt(max(1e-20, n2)))


def _rotate_around_axis(v: np.ndarray, axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation (Camera.cs:207-216)."""
    a = _normalize(axis)
    c, s = math.cos(angle), math.sin(angle)
    return v * c + np.cross(a, v) * s + a * (np.dot(a, v) * (1.0 - c))


def _ortho_basis(forward: np.ndarray, up_hint: np.ndarray):
    """(u, v, w) with gimbal fallback (Camera.cs:193-205)."""
    f = _normalize(forward)
    up = up_hint
    if abs(float(np.dot(f, up))) > 0.999:
        up = _np3(0, 1, 0)
        if abs(float(np.dot(f, up))) > 0.999:
            up = _np3(1, 0, 0)
    u = _normalize(np.cross(f, up))
    v = _normalize(np.cross(u, f))
    w = -f
    return u, v, w


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: np.ndarray
    lower_left: np.ndarray
    horizontal: np.ndarray
    vertical: np.ndarray
    # derived (baked):
    forward: np.ndarray
    right: np.ndarray
    up: np.ndarray
    aspect: np.ndarray  # f32 scalar
    fov_y: np.ndarray  # f32 scalar, radians

    # ---- constructors ----

    @staticmethod
    def create(width: int, height: int, fov_degrees: float = 60.0) -> "Camera":
        """Default pose: origin (0,1,3) looking at (0,0.5,0) (Camera.cs:19-47)."""
        return Camera.look_at(
            origin=_np3(0, 1, 3),
            target=_np3(0, 0.5, 0),
            up=_np3(0, 1, 0),
            vfov_degrees=fov_degrees,
            aspect=float(width) / float(max(1, height)),
        )

    @staticmethod
    def look_at(origin, target, up, vfov_degrees: float, aspect: float) -> "Camera":
        """(Camera.cs:100-119 semantics, focusDist=1.)"""
        origin = np.asarray(origin, dtype=np.float32)
        target = np.asarray(target, dtype=np.float32)
        up = np.asarray(up, dtype=np.float32)
        theta = math.radians(vfov_degrees)
        half_h = math.tan(0.5 * theta)
        half_w = aspect * half_h
        fwd = _normalize(target - origin)
        u, v, _w = _ortho_basis(fwd, up)
        horizontal = u * (2.0 * half_w)
        vertical = v * (2.0 * half_h)
        lower_left = origin - u * half_w - v * half_h + fwd
        return Camera._with_derived(origin, lower_left, horizontal, vertical)

    @staticmethod
    def _with_derived(origin, lower_left, horizontal, vertical) -> "Camera":
        """Bake forward/right/up/aspect/fovY from the plane parametrization
        (RTRenderer.cs BakeCameraDerived:241-263)."""
        center = lower_left + horizontal * 0.5 + vertical * 0.5
        forward = _normalize(center - origin)
        up = _normalize(vertical)
        right = _normalize(np.cross(forward, up))
        focus = float(np.linalg.norm(center - origin))
        half_h = 0.5 * float(np.linalg.norm(vertical))
        tan_half = half_h / focus if focus > 1e-6 else half_h
        fov_y = 2.0 * math.atan(tan_half)
        lh = float(np.linalg.norm(horizontal))
        lv = float(np.linalg.norm(vertical))
        aspect = lh / lv if (lh > 1e-6 and lv > 1e-6) else 1.0
        return Camera(
            origin=origin.astype(np.float32),
            lower_left=lower_left.astype(np.float32),
            horizontal=horizontal.astype(np.float32),
            vertical=vertical.astype(np.float32),
            forward=forward.astype(np.float32),
            right=right.astype(np.float32),
            up=up.astype(np.float32),
            aspect=np.float32(aspect),
            fov_y=np.float32(fov_y),
        )

    # ---- pure update ops (each returns a new Camera) ----

    def translate(self, delta) -> "Camera":
        delta = np.asarray(delta, dtype=np.float32)
        return Camera._with_derived(
            self.origin + delta, self.lower_left + delta, self.horizontal, self.vertical
        )

    def set_fov(self, vfov_degrees: float, aspect: float) -> "Camera":
        """Rebuild plane at new FOV preserving pose (Camera.cs:128-145)."""
        center = self.lower_left + self.horizontal * 0.5 + self.vertical * 0.5
        focus = float(np.linalg.norm(center - self.origin))
        fwd = _normalize(center - self.origin)
        up = _normalize(self.vertical)
        theta = math.radians(vfov_degrees)
        half_h = math.tan(0.5 * theta)
        half_w = aspect * half_h
        u, v, _w = _ortho_basis(fwd, up)
        horizontal = u * (2.0 * half_w)
        vertical = v * (2.0 * half_h)
        lower_left = self.origin - u * half_w - v * half_h + fwd * focus
        return Camera._with_derived(self.origin, lower_left, horizontal, vertical)

    def rotate_yaw_pitch(self, yaw_degrees: float, pitch_degrees: float) -> "Camera":
        """Mouse-look rotation with gimbal guard (Camera.cs:147-180)."""
        half_w = 0.5 * float(np.linalg.norm(self.horizontal))
        half_h = 0.5 * float(np.linalg.norm(self.vertical))
        center = self.lower_left + self.horizontal * 0.5 + self.vertical * 0.5
        focus = float(np.linalg.norm(center - self.origin))

        fwd = _normalize(center - self.origin)
        up = _normalize(self.vertical)
        right = _normalize(np.cross(fwd, up))
        world_up = _WORLD_UP.copy()
        if abs(float(np.dot(fwd, world_up))) > 0.999:
            world_up = _normalize(np.cross(right, fwd))

        yaw = math.radians(yaw_degrees)
        pitch = math.radians(pitch_degrees)
        fwd = _rotate_around_axis(fwd, world_up, yaw)
        up = _rotate_around_axis(up, world_up, yaw)
        right = _normalize(np.cross(fwd, up))
        up = _normalize(np.cross(right, fwd))
        fwd = _rotate_around_axis(fwd, right, pitch)
        up = _normalize(np.cross(right, fwd))

        u, v, _w = _ortho_basis(fwd, up)
        horizontal = u * (2.0 * half_w)
        vertical = v * (2.0 * half_h)
        lower_left = self.origin - u * half_w - v * half_h + fwd * focus
        return Camera._with_derived(self.origin, lower_left, horizontal, vertical)

    def fly(
        self,
        forward_axis: float = 0.0,
        right_axis: float = 0.0,
        up_axis: float = 0.0,
        dt: float = 0.0,
        speed: float = 3.0,
    ) -> "Camera":
        """WASD-style fly: forward motion projected horizontal
        (Camera.cs:57-84 semantics, generalized to analog axes)."""
        center = self.lower_left + self.horizontal * 0.5 + self.vertical * 0.5
        fwd = _normalize(center - self.origin)
        up = _normalize(self.vertical)
        right = _normalize(np.cross(fwd, up))
        fwd_h = fwd - _WORLD_UP * float(np.dot(fwd, _WORLD_UP))
        n2 = float(np.dot(fwd_h, fwd_h))
        fwd_h = fwd_h * (1.0 / math.sqrt(n2)) if n2 > 1e-12 else right
        move = right * right_axis + _WORLD_UP * up_axis + fwd_h * forward_axis
        m2 = float(np.dot(move, move))
        if m2 <= 1e-12:
            return self
        move = move * (1.0 / math.sqrt(m2))
        return self.translate(move * (speed * dt))

