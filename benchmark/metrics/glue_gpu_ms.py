"""glue_gpu_ms: device milliseconds a frame of every kernel that no
`benchmark/kernels/*.json` class names (the integrator's PyTorch glue);
copies and fills are not kernels and are left out."""


def read(ctx):
    p = ctx.profile
    if p is None:
        return None
    own = {n for names in ctx.kernel_classes.values() for n in names}
    us = sum(dur for base, _, dur in p.kernels() if base not in own)
    return us * 1e-3 / p.frames if us > 0 else None
