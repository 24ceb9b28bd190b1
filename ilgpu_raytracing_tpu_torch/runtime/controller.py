"""Fly-camera controller driven by an explicit input state (port of
runtime/controller.py).

The reference's FlyCameraController reads OpenTK window input
(reference CameraController.cs:19-80); a headless host has no window, so
input is an explicit `InputState` the embedding (window lib, replay script,
test) fills per tick. Semantics match: mouse-delta look only while captured,
Shift x4 / Ctrl x0.25 speed, WASD + Space/C vertical, scroll-wheel FOV zoom
clamped to [20, 100] degrees, FOV+aspect re-applied every update
(CameraController.cs:40-69).
"""

from __future__ import annotations

import dataclasses

from ilgpu_raytracing_tpu_torch.models.camera import Camera


@dataclasses.dataclass
class InputState:
    w: bool = False
    a: bool = False
    s: bool = False
    d: bool = False
    up: bool = False  # Space in the reference
    down: bool = False  # C in the reference
    shift: bool = False
    ctrl: bool = False
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0
    scroll_dy: float = 0.0
    captured: bool = True


class FlyCameraController:
    def __init__(
        self,
        base_speed: float = 3.0,
        sensitivity_deg_per_pixel: float = 0.08,
        fov_degrees: float = 60.0,
    ):
        self.base_speed = base_speed
        self.sensitivity = sensitivity_deg_per_pixel
        self.fov_degrees = fov_degrees

    def update(self, camera: Camera, inp: InputState, dt: float,
               aspect: float) -> Camera:
        if inp.captured and (inp.mouse_dx != 0.0 or inp.mouse_dy != 0.0):
            camera = camera.rotate_yaw_pitch(
                inp.mouse_dx * self.sensitivity, -inp.mouse_dy * self.sensitivity
            )

        speed = self.base_speed
        if inp.shift:
            speed *= 4.0
        if inp.ctrl:
            speed *= 0.25

        fwd = (1.0 if inp.w else 0.0) - (1.0 if inp.s else 0.0)
        right = (1.0 if inp.d else 0.0) - (1.0 if inp.a else 0.0)
        up = (1.0 if inp.up else 0.0) - (1.0 if inp.down else 0.0)
        if fwd or right or up:
            camera = camera.fly(fwd, right, up, dt, speed)

        if inp.scroll_dy != 0.0:
            self.fov_degrees = float(
                min(100.0, max(20.0, self.fov_degrees - inp.scroll_dy * 2.0))
            )
        camera = camera.set_fov(self.fov_degrees, aspect)
        return camera
