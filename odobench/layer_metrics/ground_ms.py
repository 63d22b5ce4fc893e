"""Host ms a frame registered in `kiss/ground`: the ground-plane fit and
the attitude correction after each registration (ops/ground.py). Moves
frames_per_s."""

SPANS = ('kiss/ground',)


def read(ctx):
    us = ctx.trace.span_us(*SPANS)
    return us / 1e3 / len(ctx.traced) if us and ctx.traced else None
