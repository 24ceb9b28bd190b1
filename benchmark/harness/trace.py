"""Reading a torch.profiler trace of the profiled stretch.

The trace is exported in Chrome's format to a temporary directory and read
back: device operations (kernels, copies, fills) with their start and
length, the benchmark's spans (`window`, `render`, `scene_update`,
`present`, recorded with `record_function`) and the host's operators, all
on one clock in microseconds. Busy time is the union of the device
operations' intervals inside the window, so operations that overlap count
once.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = ("render", "scene_update", "present")


def kernel_base_name(name: str) -> str:
    """`void ns::trace_kernel<A, B>(float const*, ...)` -> `trace_kernel`."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    if head.startswith("void "):
        head = head[5:]
    depth, out = 0, []
    for ch in head:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return re.split(r"::", "".join(out).strip())[-1].strip()


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """(start, end) of every stretch of [lo, hi] that no interval covers."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


class Profile:
    """The profiled stretch: device operations, spans and host operators
    inside the `window` span, and the number of frames it rendered."""

    def __init__(self, events: list[dict], frames: int):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == "window"]
        if not win:
            raise ValueError("profiler trace has no `window` span")
        self.lo = float(win[0]["ts"])
        self.hi = self.lo + float(win[0]["dur"])
        inside = lambda e: self.lo <= float(e["ts"]) <= self.hi
        x = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
        self.device = [(e["cat"], e["name"], float(e["ts"]), float(e["dur"])) for e in x
                       if e.get("cat") in DEVICE_CATS and inside(e)]
        self.spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in x
                      if e.get("cat") == "user_annotation" and e.get("name") in SPANS
                      and inside(e)]
        self.host_ops = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                         for e in x if e.get("cat") == "cpu_op" and inside(e)]
        self.frames = frames

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    def intervals(self):
        return [(ts, ts + dur) for _, _, ts, dur in self.device]

    def busy_us(self) -> float:
        return union_length([(max(s, self.lo), min(e, self.hi)) for s, e in self.intervals()
                             if min(e, self.hi) > max(s, self.lo)])

    def kernels(self):
        """(base name, full name, microseconds) of every kernel."""
        return [(kernel_base_name(n), n, dur) for cat, n, _, dur in self.device
                if cat == "kernel"]

    def _label(self, t: float) -> str:
        """The benchmark span and the innermost host operator at time t."""
        span = next((n for n, s, e in self.spans if s <= t <= e), "other")
        ops = [(e - s, n) for n, s, e in self.host_ops if s <= t <= e]
        return f"{span}/{min(ops)[1]}" if ops else span

    def breakdown(self) -> dict:
        """The 10 device operations that took most time (seconds over the
        stretch) and the 10 longest idle gaps, each named by what the host
        was doing when it began."""
        by_name: dict[str, float] = {}
        for _, n, _, dur in self.device:
            by_name[n[:120]] = by_name.get(n[:120], 0.0) + dur * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle_gaps(self.intervals(), self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:10]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self._label(s), (e - s) * 1e-6] for s, e in gaps]}


def read(prof, frames: int) -> Profile:
    """Export the profiler's trace to a temporary file and read it."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Profile(events, frames)
