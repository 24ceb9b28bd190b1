"""device_ops_per_frame: device operations (kernels, copies, fills) in
the profiled stretch, over its frames."""


def read(ctx):
    p = ctx.profile
    if p is None or not p.device:
        return None
    return len(p.device) / p.frames
