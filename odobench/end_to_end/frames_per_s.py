"""Every frame the window registered, over every row, divided by the whole
window (first call to the return of the call in flight at its end)."""


def read(ctx):
    return len(ctx.rec.frames) / ctx.rec.window_s
