"""table_prep_host_ms: host milliseconds a frame of Renderer.set_scene (the
program's `set_scene` span: the kernel tables read back, rebuilt and
uploaded), over the window's frames (harness/program_spans.py); none where
the scene is not set in the window."""

from benchmark.harness import program_spans


def read(ctx):
    f = program_spans.window_frames(ctx)
    spans = [] if f is None else f.named("set_scene")
    return program_spans.ms(spans) / f.n if spans else None
