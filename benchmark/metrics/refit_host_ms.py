"""refit_host_ms: host milliseconds a frame of refit_mesh_instance (the
program's `refit` span: read-back, BVH refit, TLAS, upload), over the
window's frames (harness/program_spans.py); none where nothing moves."""

from benchmark.harness import program_spans


def read(ctx):
    f = program_spans.window_frames(ctx)
    spans = [] if f is None else f.named("refit")
    return program_spans.ms(spans) / f.n if spans else None
