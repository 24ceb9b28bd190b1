"""The frame loop the benchmark drives: closed, one frame in flight.

Each step sets frame k's inputs (the vertices, through a refit and a new
scene, where the traffic moves them; then the camera), issues frame k with
`render()`, and then copies frame k-1's packed frame to host memory: the
order of a viewer that presents the previous frame while the next renders.
Set-up ends after the warm-up frames, which use the cell's own shapes; the
window then runs for `seconds` and counts every frame whose copy to the
host completes inside it.

Spans are taken on the benchmark's side with the host clock: `render` (the
call, no synchronise), `scene_update` (refit and set_scene; in a traced run
ended by a synchronise) and `present` (the copy, which waits for the
device). A traced run adds a short profiled stretch after the window.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from benchmark.harness import traffic as traffic_mod

now = time.perf_counter


@dataclasses.dataclass
class Sample:
    """One frame kept for the correctness check: its index, the renderer's
    frame counter, the state it started from and the state it handed on
    (the program's objects), and the presented frame as the host got it."""

    k: int
    counter: int
    pre: object
    post: object
    presented: object = None


@dataclasses.dataclass
class Window:
    t0: float
    seconds: float
    issued: int = 0
    done: list = dataclasses.field(default_factory=list)  # (k, t_render0, t_present_end)
    spans: dict = dataclasses.field(
        default_factory=lambda: {"render": [], "scene_update": [], "present": []})


class Loop:
    def __init__(self, prog, traffic: traffic_mod.Traffic, dt: float, judge_frames: int,
                 judge_rng: np.random.Generator):
        self.prog, self.traffic, self.dt = prog, traffic, dt
        self.k = 0  # index of the next frame to issue
        self.inflight = None  # (device frame, t_render0, Sample)
        self.judge_frames, self.judge_rng = judge_frames, judge_rng
        self.kept: list[Sample] = []  # reservoir sample of the window's frames
        self.seen = 0
        self.sync_updates = False
        self.profiler_spans = False

    def _span(self, name: str):
        """A profiler range named after the span in the profiled stretch."""
        if self.profiler_spans:
            import torch

            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _issue(self, window: Window | None):
        """Set frame k's inputs and issue it; returns what is in flight."""
        k = self.k
        self.k += 1
        positions = self.traffic.positions(k)
        if positions is not None:
            with self._span("scene_update"):
                t = now()
                self.prog.set_positions(positions)
                if self.sync_updates:
                    self.prog.torch.cuda.synchronize()
                if window is not None:
                    window.spans["scene_update"].append(now() - t)
        pre, counter = self.prog.state, self.prog.r.frame
        with self._span("render"):
            t_r0 = now()
            out = self.prog.render(self.traffic.pose(k), self.dt)
            t_r1 = now()
        if window is not None:
            window.spans["render"].append(t_r1 - t_r0)
            window.issued += 1
        return out, t_r0, Sample(k, counter, pre, self.prog.state)

    def _present(self, inflight, window: Window | None):
        """Copy a frame to the host; returns (Sample, t_render0, t_copy_end)."""
        out, t_r0, sample = inflight
        with self._span("present"):
            t = now()
            sample.presented = out.cpu()
            t_end = now()
        if window is not None:
            window.spans["present"].append(t_end - t)
        return sample, t_r0, t_end

    def step(self, window: Window | None = None):
        """Issue the next frame, then present the one before it. Returns
        (Sample, t_render0, t_copy_end) of the presented frame, or None."""
        prev = self.inflight
        self.inflight = self._issue(window)
        return None if prev is None else self._present(prev, window)

    def drain(self):
        """Present the frame in flight, if any."""
        prev, self.inflight = self.inflight, None
        return None if prev is None else self._present(prev, None)

    def warm_up(self, frames: int) -> list[Sample]:
        """`frames` frames of the cell's own traffic, drained; returns their
        Samples in order, the first rendered from an empty state."""
        out = []
        for _ in range(frames):
            got = self.step()
            if got is not None:
                out.append(got[0])
        out.append(self.drain()[0])
        return out

    def window(self, seconds: float) -> Window:
        """Frames until `seconds` have passed; a frame counts when its copy
        to the host ends inside the window. Keeps a uniform sample of the
        counted frames (seeded) for the correctness check."""
        w = Window(t0=now(), seconds=seconds)
        deadline = w.t0 + seconds
        while True:
            got = self.step(w)
            if got is None:
                continue
            sample, t_r0, t_end = got
            if t_end > deadline:
                break
            w.done.append((sample.k, t_r0, t_end))
            self._keep(sample)
        return w

    def _keep(self, sample: Sample) -> None:
        self.seen += 1
        if len(self.kept) < self.judge_frames:
            self.kept.append(sample)
            return
        j = int(self.judge_rng.integers(0, self.seen))
        if j < self.judge_frames:
            self.kept[j] = sample

    def profiled(self, frames: int):
        """`frames` more frames under torch.profiler, the in-flight frame
        drained first; returns (profiler, the frames' Samples)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.drain()
        torch.cuda.synchronize()
        self.profiler_spans = True
        samples = []
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with torch.profiler.record_function("window"):
                    for _ in range(frames):
                        got = self.step()
                        if got is not None:
                            samples.append(got[0])
                    samples.append(self.drain()[0])
                    torch.cuda.synchronize()
        finally:
            self.profiler_spans = False
        return prof, samples
