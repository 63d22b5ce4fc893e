"""Host ms a frame registered in `kiss/align`:
the ICP loop with K1, K2 and the 6x6 solve (ops/registration.py). Moves frames_per_s."""

SPANS = ('kiss/align',)


def read(ctx):
    us = ctx.trace.span_us(*SPANS)
    return us / 1e3 / len(ctx.traced) if us and ctx.traced else None
