"""Share of the benchmark's calls into the program in which the card ran
nothing: 1 - device busy / wall, in %. Busy is the union of kernel, copy
and fill intervals; wall is the sum of the calls."""


def read(ctx):
    wall = ctx.trace.calls_us()
    if not wall or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / wall)
