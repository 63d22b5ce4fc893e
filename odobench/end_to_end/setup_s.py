"""Process start to the window's start: imports, the port's kernels, the
render of the drives on the card, the warm-up calls."""


def read(ctx):
    return ctx.setup_s
