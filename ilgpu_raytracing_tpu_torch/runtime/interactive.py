"""Interactive loop: fly-camera session over the renderer (port of
runtime/interactive.py).

The reference couples rendering to an OpenTK GL window (RTWindow.cs); a
headless host has none, so the loop takes an input-provider callback
(scripted replay, network stream, or a real window's event pump) and an
optional presenter. A tkinter window is provided when a display exists
(tkinter is imported only inside the Tk classes and functions); otherwise
frames can be written to disk or displayed nowhere while the HUD reports
timings (the reference's title-bar HUD, RTWindow.cs:171-188). The session
drives the `Renderer` it is given on that renderer's device; it never
chooses a device itself.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from ilgpu_raytracing_tpu_torch.runtime.controller import FlyCameraController, InputState
from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer


class InteractiveSession:
    def __init__(
        self,
        renderer: Renderer,
        input_provider: Callable[[int], Optional[InputState]],
        presenter: Optional[Callable[[np.ndarray, str], None]] = None,
        controller: FlyCameraController | None = None,
    ):
        """input_provider(frame) -> InputState or None to stop.
        presenter(rgb_uint8, hud_text) presents a frame (may be None)."""
        self.r = renderer
        self.input_provider = input_provider
        self.presenter = presenter
        self.controller = controller or FlyCameraController()

    def run(self, max_frames: int = 0) -> int:
        """Pump input -> camera -> render -> present until the provider
        returns None (or max_frames). Returns frames rendered."""
        frames = 0
        last = time.monotonic()
        while max_frames <= 0 or frames < max_frames:
            inp = self.input_provider(frames)
            if inp is None:
                break
            now = time.monotonic()
            dt = max(1e-4, now - last)
            last = now
            cam = self.controller.update(
                self.r.camera, inp, dt, self.r.out_w / max(1, self.r.out_h)
            )
            self.r.set_camera(cam)
            self.r.render(dt)
            if self.presenter is not None:
                self.presenter(self.r.frame_rgb(), self.r.hud.text)
            frames += 1
        return frames


def scripted_input(script: list[InputState]):
    """Input provider replaying a fixed list (testing / benchmarks)."""

    def provider(frame: int):
        return script[frame] if frame < len(script) else None

    return provider


class EventPump:
    """Window-event -> InputState state machine (reference RTWindow's input
    plumbing, RTWindow.cs:131-146, 255-314), decoupled from any window lib.

    A real window (TkInputWindow below) forwards its raw key/mouse/scroll
    events here; tests drive the same methods directly so the scripted path
    and the human path share every line of event handling. Semantics:

    * `E` key-press toggles mouse capture (RTWindow.cs:255);
    * mouse deltas accumulate between polls and only while captured
      (RTWindow.cs:131-146, 309-314); the first motion after a capture
      toggle only establishes the reference position;
    * scroll accumulates between polls (FOV zoom, CameraController.cs:63);
    * `poll()` snapshots held keys + accumulated deltas into an InputState
      and clears the deltas (the per-frame consume in RTWindow.OnUpdateFrame).
    """

    _KEYMAP = {
        "w": "w", "a": "a", "s": "s", "d": "d",
        "space": "up", "c": "down",
        "shift_l": "shift", "shift_r": "shift",
        "control_l": "ctrl", "control_r": "ctrl",
    }

    def __init__(self):
        self.captured = True
        self.closed = False
        self._held: set[str] = set()
        self._dx = 0.0
        self._dy = 0.0
        self._scroll = 0.0
        self._last_xy: tuple[float, float] | None = None

    # -- raw events (bound to the window lib, or called by tests) --

    def key_down(self, keysym: str) -> None:
        k = keysym.lower()
        if k == "e":  # capture toggle on press (RTWindow.cs:255)
            self.captured = not self.captured
            self._last_xy = None  # don't consume the stale reference pos
            return
        if k == "escape":
            self.closed = True
            return
        mapped = self._KEYMAP.get(k)
        if mapped:
            self._held.add(mapped)

    def key_up(self, keysym: str) -> None:
        mapped = self._KEYMAP.get(keysym.lower())
        if mapped:
            self._held.discard(mapped)

    def mouse_move(self, x: float, y: float) -> None:
        if self._last_xy is not None and self.captured:
            self._dx += x - self._last_xy[0]
            self._dy += y - self._last_xy[1]
        self._last_xy = (x, y)

    def scroll(self, dy: float) -> None:
        self._scroll += dy

    def close(self) -> None:
        self.closed = True

    # -- per-frame consume --

    def poll(self) -> Optional[InputState]:
        """Snapshot + clear accumulated deltas; None once closed."""
        if self.closed:
            return None
        inp = InputState(
            w="w" in self._held,
            a="a" in self._held,
            s="s" in self._held,
            d="d" in self._held,
            up="up" in self._held,
            down="down" in self._held,
            shift="shift" in self._held,
            ctrl="ctrl" in self._held,
            mouse_dx=self._dx,
            mouse_dy=self._dy,
            scroll_dy=self._scroll,
            captured=self.captured,
        )
        self._dx = self._dy = self._scroll = 0.0
        return inp


class TkInputWindow:
    """Live tkinter window that both presents frames and pumps real
    keyboard/mouse events into an EventPump, so a human can fly the camera
    (reference RTWindow, RTWindow.cs:131-146, 255-314).

    Usage:
        win = TkInputWindow.open(w, h)         # None if no display
        session = InteractiveSession(r, win.input_provider, win.presenter)
        session.run()
    """

    def __init__(self, root, label):
        self._root = root
        self._label = label
        self._photo = None
        self.pump = EventPump()
        root.bind("<KeyPress>", lambda e: self.pump.key_down(e.keysym))
        root.bind("<KeyRelease>", lambda e: self.pump.key_up(e.keysym))
        root.bind("<Motion>", lambda e: self.pump.mouse_move(e.x, e.y))
        # X11 sends Button-4/5 for the wheel; Windows/mac send <MouseWheel>
        root.bind("<Button-4>", lambda e: self.pump.scroll(1.0))
        root.bind("<Button-5>", lambda e: self.pump.scroll(-1.0))
        root.bind(
            "<MouseWheel>", lambda e: self.pump.scroll(e.delta / 120.0)
        )
        root.protocol("WM_DELETE_WINDOW", self.pump.close)

    @classmethod
    def open(cls, width: int, height: int):
        try:
            import tkinter as tk

            root = tk.Tk()
        except Exception:
            return None
        root.title("tpu path tracer")
        root.geometry(f"{width}x{height}")
        label = tk.Label(root)
        label.pack()
        return cls(root, label)

    def input_provider(self, frame: int) -> Optional[InputState]:
        try:
            self._root.update()  # pump queued tk events into EventPump
        except Exception:
            return None
        return self.pump.poll()

    def presenter(self, rgb: np.ndarray, hud: str) -> None:
        import tkinter as tk

        h, w = rgb.shape[:2]
        header = f"P6 {w} {h} 255 ".encode()
        self._photo = tk.PhotoImage(data=header + rgb.tobytes(), format="PPM")
        self._label.configure(image=self._photo)
        self._root.title(f"tpu path tracer — {hud}")

    def destroy(self) -> None:
        try:
            self._root.destroy()
        except Exception:
            pass


def make_tk_presenter(width: int, height: int):
    """Live window presenter via tkinter (requires a DISPLAY). Returns
    (presenter, close_fn) or (None, None) when no display is available."""
    try:
        import tkinter as tk

        root = tk.Tk()
    except Exception:
        return None, None
    root.title("tpu path tracer")
    label = tk.Label(root)
    label.pack()
    photo_ref = {}

    def presenter(rgb: np.ndarray, hud: str) -> None:
        import tkinter as tk

        h, w = rgb.shape[:2]
        header = f"P6 {w} {h} 255 ".encode()
        photo = tk.PhotoImage(data=header + rgb.tobytes(), format="PPM")
        photo_ref["img"] = photo  # keep alive
        label.configure(image=photo)
        root.title(f"tpu path tracer — {hud}")
        root.update()

    return presenter, root.destroy
