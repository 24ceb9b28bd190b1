"""glue_host_ms: host milliseconds a frame of the integrator's glue, from
the program's own spans: each window frame's `frame` span (its render()
call) less the time inside its `kernel` spans (harness/program_spans.py)."""

from benchmark.harness import program_spans


def read(ctx):
    f = program_spans.window_frames(ctx)
    if f is None:
        return None
    return (program_spans.ms(f.named(program_spans.FRAME))
            - program_spans.ms(f.kernels())) / f.n
