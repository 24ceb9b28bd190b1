"""setup_s: from the benchmark process's first line to the end of the
warm-up frames: imports, the scene and its BVH, the Renderer and its
kernel tables, kernel builds on a first run, and the warm-up frames."""


def read(ctx):
    return ctx.setup_s
