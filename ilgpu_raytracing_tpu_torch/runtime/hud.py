"""Frame-timing HUD (port of runtime/hud.py): rolling 5 s mean frame-time and 30 s mean FPS
(reference RTWindow.cs:40-45, 171-188 -- there it's the window title; here
it's a string the host loop can print/log)."""

from __future__ import annotations

import collections
import time


class FrameTimingHud:
    def __init__(self, short_window_s: float = 5.0, long_window_s: float = 30.0,
                 refresh_hz: float = 4.0):
        self.short_window_s = short_window_s
        self.long_window_s = long_window_s
        self.refresh_interval = 1.0 / refresh_hz
        self._samples: collections.deque[tuple[float, float]] = collections.deque()
        self._last_refresh = 0.0
        self._text = ""

    def push(self, frame_time_s: float, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self._samples.append((now, frame_time_s))
        cutoff = now - self.long_window_s
        while self._samples and self._samples[0][0] < cutoff:
            self._samples.popleft()

    @property
    def text(self) -> str:
        now = time.monotonic()
        if now - self._last_refresh >= self.refresh_interval:
            self._last_refresh = now
            self._text = self._format(now)
        return self._text

    def _format(self, now: float) -> str:
        if not self._samples:
            return "-- ms | -- fps"
        short = [dt for (t, dt) in self._samples if t >= now - self.short_window_s]
        long_ = list(self._samples)
        ms = 1000.0 * sum(short) / max(1, len(short))
        span = max(1e-6, now - long_[0][0])
        fps = len(long_) / span
        return f"{ms:.2f} ms (5s avg) | {fps:.1f} fps (30s avg)"
