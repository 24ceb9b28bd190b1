"""trace_gpu_ms: device milliseconds a frame of the kernels of class
`trace` (benchmark/kernels/trace.json)."""


def trace_us(ctx):
    names = set(ctx.kernel_classes.get("trace", ()))
    return sum(dur for base, _, dur in ctx.profile.kernels() if base in names)


def read(ctx):
    if ctx.profile is None:
        return None
    us = trace_us(ctx)
    return us * 1e-3 / ctx.profile.frames if us > 0 else None
