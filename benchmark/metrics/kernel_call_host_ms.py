"""kernel_call_host_ms: host milliseconds a frame inside the trace and
sort kernels' dispatch wrappers (the program's `kernel` spans: checks,
table pointers, the launch call; K1-K8 and K3), over the window's frames
(harness/program_spans.py)."""

from benchmark.harness import program_spans


def read(ctx):
    f = program_spans.window_frames(ctx)
    if f is None:
        return None
    return program_spans.ms(f.kernels()) / f.n
