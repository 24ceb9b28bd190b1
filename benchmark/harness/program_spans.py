"""The benchmark's second door into the program, read-only: the spans the
port records itself (`ilgpu_raytracing_tpu_torch/utils/telemetry.py`),
selected for the frames a run issued.

A span record is `(id, parent_id, name, frame, t0_ns, t1_ns, attrs)` on
`time.perf_counter_ns`, the clock of the harness's `time.perf_counter`, so
the window's own times select its frames. `window_frames` gives the frames
the window issued up to its last counted copy: the loop issues frame N and
then copies N-1, so they are the counted frames and one more. A scene update
is stamped with the frame it prepares. `profiled_frames` gives the last
`ctx.profile.frames` frames, those of the traced stretch after the window.

Either returns None, and so every reader, when the program keeps no such
record (a program without the telemetry module), when the ring of records
lost part of the frames, or when the frames found disagree with the
window's count.
"""

from __future__ import annotations

import dataclasses

FRAME, KERNEL = "frame", "kernel"


@dataclasses.dataclass
class Frames:
    """Records stamped with the frame ids `ids` (a set); `n` frames."""

    ids: set
    records: list

    @property
    def n(self) -> int:
        return len(self.ids)

    def named(self, name: str) -> list:
        return [r for r in self.records if r[2] == name]

    def kernels(self) -> list:
        """The kernel spans that no other kernel span holds."""
        kernel_ids = {r[0] for r in self.records if r[2] == KERNEL}
        return [r for r in self.records if r[2] == KERNEL and r[1] not in kernel_ids]


def snapshot():
    """The program's telemetry snapshot, or None when it has none."""
    try:
        from ilgpu_raytracing_tpu_torch.utils import telemetry
    except ImportError:
        return None
    return telemetry.snapshot()


def ms(records) -> float:
    """Summed duration of span records, in milliseconds."""
    return sum(r[5] - r[4] for r in records) * 1e-6


def _lost(snap: dict, since_ns: float) -> bool:
    """True when the ring dropped a record that ended at or after `since_ns`."""
    recs = snap["records"]
    return snap["written"] > snap["capacity"] and (not recs or recs[0][5] >= since_ns)


def _select(snap: dict, frame_records: list, since_ns: float) -> Frames | None:
    """The records stamped with these frames' ids that ended after
    `since_ns` (an earlier Renderer's frames reuse the ids)."""
    ids = {r[3] for r in frame_records}
    if len(ids) != len(frame_records):
        return None
    return Frames(ids, [r for r in snap["records"] if r[3] in ids and r[5] >= since_ns])


def window_frames(ctx, snap: dict | None = None) -> Frames | None:
    """The frames the window issued, from its start to its last counted
    copy: one more than it counted."""
    snap = snapshot() if snap is None else snap
    done = ctx.window.done
    if snap is None or not done:
        return None
    lo, hi = ctx.window.t0 * 1e9, done[-1][2] * 1e9
    frames = [r for r in snap["records"] if r[2] == FRAME and lo <= r[4] <= hi]
    if _lost(snap, lo) or len(frames) != len(done) + 1:
        return None
    return _select(snap, frames, lo)


def profiled_frames(ctx, snap: dict | None = None) -> Frames | None:
    """The last `ctx.profile.frames` frames, all issued after the window's
    last counted copy."""
    snap = snapshot() if snap is None else snap
    if snap is None or ctx.profile is None or not ctx.window.done:
        return None
    n = int(ctx.profile.frames)
    hi = ctx.window.done[-1][2] * 1e9
    frames = [r for r in snap["records"] if r[2] == FRAME and r[4] > hi]
    if n < 1 or len(frames) < n or _lost(snap, frames[-n][4]):
        return None
    return _select(snap, frames[-n:], hi)
