"""kernel_calls_per_frame: calls a frame of the trace and sort kernels'
dispatch wrappers (the program's outermost `kernel` spans: K1-K8 and K3),
over the window's frames (harness/program_spans.py). Each round of the
alpha peel is one more closest-hit call."""

from benchmark.harness import program_spans


def read(ctx):
    f = program_spans.window_frames(ctx)
    if f is None:
        return None
    return len(f.kernels()) / f.n
