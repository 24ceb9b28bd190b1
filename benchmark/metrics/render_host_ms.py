"""render_host_ms: mean host time of one Renderer.render() call over the
window, with no synchronise: the host's issue of a frame."""


def read(ctx):
    spans = ctx.window.spans["render"]
    return 1e3 * sum(spans) / len(spans) if spans else None
