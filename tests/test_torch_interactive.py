"""Port vs JAX reference on the CPU: the fly-camera controller and the
interactive session (runtime/controller.py, runtime/interactive.py).

`FlyCameraController.update` is held to JAX's on the same camera, inputs
and fixed dt (allclose at 1e-6) over every input: look only while
captured, WASD and Space/C, Shift x4, Ctrl x0.25, the FOV clamp to
[20, 100]. The `EventPump` semantics are tests/test_interactive.py's, and
the scripted session runs the port's `Renderer` on the CPU at 48x32.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu.models import camera as jcamera
from ilgpu_raytracing_tpu.runtime import controller as jcontroller
from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models import camera as tcamera
from ilgpu_raytracing_tpu_torch.runtime import controller as tcontroller
from ilgpu_raytracing_tpu_torch.runtime.controller import InputState
from ilgpu_raytracing_tpu_torch.runtime.interactive import (
    EventPump,
    InteractiveSession,
    make_tk_presenter,
    scripted_input,
)
from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

torch.set_num_threads(1)

_CAM_FIELDS = ("origin", "lower_left", "horizontal", "vertical", "forward",
               "right", "up", "aspect", "fov_y")

INPUTS = {
    "look captured": [dict(mouse_dx=40.0, mouse_dy=-12.0)],
    "look not captured": [dict(mouse_dx=40.0, mouse_dy=-12.0, captured=False)],
    "wasd": [dict(w=True), dict(a=True), dict(s=True, d=True), dict(d=True)],
    "space and c": [dict(up=True), dict(down=True), dict(up=True, w=True)],
    "shift x4": [dict(w=True, shift=True), dict(d=True, shift=True)],
    "ctrl x0.25": [dict(w=True, ctrl=True), dict(a=True, ctrl=True, shift=True)],
    "fov clamp": [dict(scroll_dy=30.0), dict(scroll_dy=2.0), dict(scroll_dy=-80.0),
                  dict(scroll_dy=-3.0)],
    "all at once": [dict(w=True, d=True, up=True, shift=True, mouse_dx=-7.0,
                         mouse_dy=5.0, scroll_dy=1.0)] * 3,
}


@pytest.mark.parametrize("case", list(INPUTS))
def test_controller_matches_reference(case):
    jc = jcamera.Camera.create(320, 180, 60.0)
    tc = tcamera.Camera.create(320, 180, 60.0)
    jctl = jcontroller.FlyCameraController()
    tctl = tcontroller.FlyCameraController()
    dt, aspect = 1.0 / 30.0, 320 / 180
    start = tc
    fovs = []
    for kw in INPUTS[case]:
        jc = jctl.update(jc, jcontroller.InputState(**kw), dt, aspect)
        tc = tctl.update(tc, InputState(**kw), dt, aspect)
        assert tctl.fov_degrees == jctl.fov_degrees
        fovs.append(tctl.fov_degrees)
        for f in _CAM_FIELDS:
            np.testing.assert_allclose(np.asarray(getattr(tc, f), np.float64),
                                       np.asarray(getattr(jc, f), np.float64),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
    if case == "look not captured":
        np.testing.assert_array_equal(tc.forward, start.forward)
    if case == "look captured":
        assert not np.allclose(tc.forward, start.forward)
    if case == "fov clamp":
        assert fovs == [20.0, 20.0, 100.0, 100.0]


def test_controller_speed_modifiers():
    """Shift scales the fly distance by 4, Ctrl by 0.25, both by 1."""
    cam = tcamera.Camera.create(320, 180, 60.0)
    ctl = tcontroller.FlyCameraController(base_speed=2.0)

    def moved(**kw):
        c = ctl.update(cam, InputState(w=True, **kw), 0.5, 320 / 180)
        return float(np.linalg.norm(c.origin - cam.origin))

    base = moved()
    assert base == pytest.approx(1.0, rel=1e-6)
    assert moved(shift=True) == pytest.approx(4.0 * base, rel=1e-6)
    assert moved(ctrl=True) == pytest.approx(0.25 * base, rel=1e-6)
    assert moved(shift=True, ctrl=True) == pytest.approx(base, rel=1e-6)


def test_event_pump_semantics():
    """Window-event plumbing (RTWindow.cs:131-146, 255-314): capture toggle
    on E, captured-only mouse deltas, per-poll delta consume, key holds."""
    p = EventPump()
    p.key_down("w")
    p.key_down("Shift_L")
    inp = p.poll()
    assert inp.w and inp.shift and inp.captured
    p.key_up("w")
    p.key_up("Shift_L")
    p.mouse_move(100, 100)
    p.mouse_move(110, 95)
    p.mouse_move(112, 95)
    inp = p.poll()
    assert inp.mouse_dx == 12.0 and inp.mouse_dy == -5.0
    assert not inp.w and not inp.shift
    assert p.poll().mouse_dx == 0.0
    p.key_down("e")
    p.mouse_move(0, 0)
    p.mouse_move(50, 50)
    inp = p.poll()
    assert not inp.captured and inp.mouse_dx == 0.0
    p.key_down("e")
    assert p.poll().captured
    p.scroll(1.0)
    p.scroll(1.0)
    assert p.poll().scroll_dy == 2.0
    p.key_down("Escape")
    assert p.poll() is None


def _renderer():
    return Renderer(out_w=48, out_h=32, cfg=RenderConfig(spp=1, max_depth=1),
                    device="cpu")


def test_scripted_session_on_cpu_renderer():
    r = _renderer()
    assert r.device.type == "cpu" and r.wscene is not None
    script = [
        InputState(w=True),
        InputState(mouse_dx=40.0),
        InputState(d=True, shift=True),
        InputState(scroll_dy=2.0),
    ]
    presented = []
    sess = InteractiveSession(
        r, scripted_input(script),
        presenter=lambda rgb, hud: presented.append((rgb.copy(), hud)),
    )
    assert sess.run() == 4
    assert len(presented) == 4 and r.frame == 4
    assert presented[0][0].shape == (32, 48, 3) and presented[0][0].dtype == np.uint8
    assert not np.allclose(presented[0][0], presented[-1][0])
    assert all("ms" in hud for _, hud in presented)
    assert sess.controller.fov_degrees == 56.0
    # a second run replays the script from the start
    assert sess.run(max_frames=2) == 2 and r.frame == 6


def test_event_pump_drives_session():
    """A human-input session goes through EventPump.poll as the provider,
    the path TkInputWindow uses."""
    r = _renderer()
    p = EventPump()
    events = {
        0: lambda: p.key_down("w"),
        1: lambda: (p.mouse_move(0, 0), p.mouse_move(30, 10)),
        2: lambda: p.close(),
    }

    def provider(frame: int):
        ev = events.get(frame)
        if ev is not None:
            ev()
        return p.poll()

    start = dataclasses.replace(r.camera)
    sess = InteractiveSession(r, provider)
    assert sess.run() == 2
    assert not np.allclose(r.camera.origin, start.origin)
    assert not np.allclose(r.camera.forward, start.forward)


def test_tk_presenter_without_display(monkeypatch):
    """No display: the Tk presenter reports (None, None) instead of raising."""
    monkeypatch.delenv("DISPLAY", raising=False)
    assert make_tk_presenter(48, 32) == (None, None)
