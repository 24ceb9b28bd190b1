"""trace_roofline: the trace kernels' share of their roofline, a bytes
floor that any implementation of the profiled frames' ray queries must
move, over the kernels' device time. Implementation-free: it counts rays
and triangles, not the boxes or primitives a particular BVH makes a kernel
test.

The rays are those the path tracer keeps alive, as the reference counts
them when it renders the profiled frames (`ctx.live_lanes`): closest-hit
queries (primary visibility and each bounce's surviving paths, after
misses and Russian roulette) of 36 B (origin, direction and t_max in, t and
primitive out), and any-hit queries (the shadow rays that visibility-ray
roulette keeps, and the last bounce's sky test) of 29 B (origin, direction
and t_max in, one byte out); and every triangle's 36 B once a frame. Floor
time = bytes / the card's HBM bandwidth (benchmark/harness/peaks.py)."""

from benchmark.harness import peaks
from benchmark.metrics import trace_gpu_ms

CLOSEST_LANE_BYTES = 36
ANYHIT_LANE_BYTES = 29
TRIANGLE_BYTES = 36


def frames_bytes(closest_lanes: int, anyhit_lanes: int, n_tris: int, frames: int) -> int:
    """Bytes of `frames` frames with these live lanes in all."""
    return (closest_lanes * CLOSEST_LANE_BYTES + anyhit_lanes * ANYHIT_LANE_BYTES
            + frames * n_tris * TRIANGLE_BYTES)


def read(ctx):
    if ctx.profile is None or not ctx.live_lanes:
        return None
    ms = trace_gpu_ms.read(ctx)
    if ms is None:
        return None
    frames = ctx.profile.frames
    floor_ms = frames_bytes(*ctx.live_lanes, ctx.n_tris, frames) / frames \
        / peaks.HBM_BYTES_PER_S * 1e3
    return 100.0 * floor_ms / ms
