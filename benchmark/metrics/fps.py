"""fps: presented frames whose copy to the host ended inside the window,
over the time from the window's start to the last such copy's end."""


def read(ctx):
    done = ctx.window.done
    if not done:
        return None
    return len(done) / (done[-1][2] - ctx.window.t0)
