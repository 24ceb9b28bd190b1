"""device_idle_pct: share of the profiled stretch's wall time in which no
device operation runs, from the union of the operations' intervals."""


def read(ctx):
    p = ctx.profile
    if p is None or p.window_us <= 0:
        return None
    return 100.0 * (1.0 - p.busy_us() / p.window_us)
