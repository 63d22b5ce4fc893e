"""Host ms a frame in the port's wrappers outside its `kiss/*` stages: the
benchmark's `odobench/*` spans around each call, less the stage spans
inside them. Moves frames_per_s."""


def read(ctx):
    calls = ctx.trace.calls_us()
    if not calls or not ctx.traced:
        return None
    stages = sum(e - s for _, s, e in ctx.trace.spans_with_prefix("kiss/"))
    return (calls - stages) / 1e3 / len(ctx.traced)
