"""trace_lane_use_pct: the share of the lanes handed to the trace kernels
that the path tracer keeps alive. 100 x the live lanes the reference counts
over the profiled frames (`ctx.live_lanes`, closest-hit and any-hit, as
trace_roofline reads them) over the lanes of the program's `kernel` spans of
those frames, every kernel but the sort K3 (`sortpos`)
(harness/program_spans.py)."""

from benchmark.harness import program_spans

SORT_KERNEL = "sortpos"


def read(ctx):
    if not ctx.live_lanes:
        return None
    f = program_spans.profiled_frames(ctx)
    if f is None:
        return None
    lanes = sum(r[6]["lanes"] for r in f.kernels() if r[6]["name"] != SORT_KERNEL)
    return 100.0 * sum(ctx.live_lanes) / lanes if lanes else None
