"""latency_ms_p95: per presented frame, from the start of the render()
call that issued it (its inputs set) to the end of its copy to host
memory; the 95th percentile over every frame of the window."""

import numpy as np


def read(ctx):
    lat = [(t_end - t_r0) * 1e3 for _, t_r0, t_end in ctx.window.done]
    return float(np.percentile(lat, 95)) if lat else None
